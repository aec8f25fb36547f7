// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T * scale
// + bias [+ causal mask]) v, plus the per-row logsumexp.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_fwd_kernels` (the Pallas
// online-softmax forward, called from `flash_attention_fwd`). Same math:
// the scale folds into the query once, an optional [b, sk] f32 key bias is
// added to the logits, causal keys are set to -1e30, the running max starts
// at -1e30, p is rounded to the operand type before the p.v product while
// the normaliser sums the unrounded p, and the epilogue divides by
// max(l, 1e-30) and writes lse = m + log(max(l, 1e-30)).
//
// Differences from the TPU kernel, by design:
//  * Causal masking is END-aligned (key j visible to row i while
//    j <= i + sk - sq), which is the reference `sdpa_reference` semantics
//    for every shape; for sq == sk it is the TPU kernel's start alignment.
//  * Any sq / sk: ragged query and key tails are masked here (out-of-range
//    keys get -inf, so they never enter the normaliser), there is no
//    block-divisibility gate and no minimum sequence length.
//  * Key tiles entirely past the block's last visible key are skipped. A
//    row whose every visible key is masked (no real key at all) is
//    degenerate and its output is unspecified, as on the TPU.
//
// What bounds it on an H100: in fp32 the logits and p.v products run on
// the CUDA cores (67 TFLOP/s fp32; TF32 tensor cores would lose the 2e-5
// parity with the plain version). At the serving shapes (s <= 1024,
// d = 64) the work per block is small and the kernel is bound by shared-
// memory traffic and latency rather than by device memory: each q/k/v
// element is read from device memory once per (query tile, key tile)
// pair. Design: one 128-thread block per (query tile of 64 rows, b*h);
// K, V and the key bias are staged tile by tile (64 keys) in shared
// memory with a padded row stride so the column reads are free of bank
// conflicts; each thread owns 4 rows x 8 key columns of the logits and
// 4 rows x d/8 columns of the accumulator, the row max / row sum reduce
// over the 8 lanes of a row with warp shuffles, and p goes through
// shared memory to the p.v product. wgmma/TMA are left for a later PR.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int RPT = 4;        // logits rows per thread
constexpr int CPT = 8;        // logits columns per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// value as it is after a cast to the operand type (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr int smem_floats() {
  // q, k, v tiles [64][D + 1], p tile [64][BK + 1], bias tile [BK]
  return 3 * 64 * (D + 1) + BQ * (BK + 1) + BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int H,
                 int sq, int sk, int d, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, float scale,
                 int causal) {
  constexpr int LD = D + 1;       // padded row stride of the q/k/v tiles
  constexpr int LP = BK + 1;      // padded row stride of the p tile
  constexpr int OPT = D / 8;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* bs = ps + BQ * LP;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;        // row group: rows 4*rg .. 4*rg + 3
  const int cg = tid & 7;         // column group: columns cg + 8*j
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;        // end-aligned causal offset

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const float* bp = bias ? bias + (long long)b * sk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < sq && c < d)
      x = round_to<T>(to_f(qp[(long long)(q0 + r) * qss + c]) * scale);
    qs[r * LD + c] = x;
  }

  int kend = sk;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    kend = max(0, min(sk, last_row + off + 1));
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = to_f(kp[(long long)(k0 + r) * kss + c]);
        vx = to_f(vp[(long long)(k0 + r) * vss + c]);
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    if (tid < BK) bs[tid] = (bp && k0 + tid < sk) ? bp[k0 + tid] : 0.f;
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(rg * RPT + i) * LD + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(cg + 8 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (causal && col > row + off) x = NEG;
        if (col >= sk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(rg * RPT + i) * LP + cg + 8 * j] = round_to<T>(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                 // a row's p is written by its own warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(rg * RPT + i) * LP + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float vv = vs[j * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* op = out + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) op[col] = from_f<T>(acc[i][c] / ls);
    }
    if (cg == 0) lse[(long long)bh * sq + row] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, void* lse, int B, int H, int sq, int sk, int d,
           const long long* st, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), H, sq, sk, d, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, sq, d], k/v [B, H, sk, d] with unit stride on d and element
// strides (batch, head, row) given in `strides` (q, k, v: 9 values);
// bias: [B, sk] float32 or null; out [B, H, sq, d] contiguous; lse
// [B * H, sq] float32. Returns the cudaError_t of the launch.
extern "C" int pt_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, const void* bias,
                            void* out, void* lse, int B, int H, int sq,
                            int sk, int d, const long long* strides,
                            float scale, int causal, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return dtype == 0
        ? launch<float, 64>(q, k, v, bias, out, lse, B, H, sq, sk, d,
                            strides, scale, causal, s)
        : launch<__nv_bfloat16, 64>(q, k, v, bias, out, lse, B, H, sq, sk,
                                    d, strides, scale, causal, s);
  return dtype == 0
      ? launch<float, 128>(q, k, v, bias, out, lse, B, H, sq, sk, d,
                           strides, scale, causal, s)
      : launch<__nv_bfloat16, 128>(q, k, v, bias, out, lse, B, H, sq, sk, d,
                                   strides, scale, causal, s);
}
