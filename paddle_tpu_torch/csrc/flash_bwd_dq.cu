// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/attention.py `dq_kernel` inside
// `flash_attention_bwd` (the Pallas dQ kernel, grid (b*h, query block),
// looping over key blocks), without and with segment ids (`has_segs`).
// Same math per (query row, key):
//   logits = round(q * scale) . k + bias, pairs of different segments
//            and causal keys (end-aligned) -1e30
//   p      = exp(logits - lse)                  (lse saved by the forward)
//   dp     = dO . v, dropped and upscaled by the forward's keep bits
//   ds     = p * (dp - delta)                   (delta = rowsum(dO * O))
//   dq    += round(ds) . round(k * scale)
// The scale folds into the query for the logits (as in the forward, so the
// recomputed logits match the saved lse) and into k for the product
// (`kbs` in the TPU kernel); "round" is a cast to the operand type.
// Segment ids (flash_common.cuh): a query tile visits only the key tiles
// of [lower_bound(kseg, min qseg), upper_bound(kseg, max qseg)), as the
// forward does; masked pairs get p = 0 and add nothing.
// Differences from the TPU kernel, by design: end-aligned causal for any
// sq / sk, ragged tails masked here (keys past sk get p = 0), no
// block-divisibility gate.
//
// What bounds it on an H100: 6 * b*h*sq*sk*d operations (two logits-sized
// products and the dq product) on the CUDA cores in fp32 (67 TFLOP/s),
// against reading q, dO, lse, delta once and k, v, bias once per query
// tile. At the ERNIE shapes (s = 1024, d = 64) it is bound by the FMAs and
// their shared-memory operands, not by device memory. Design: one
// 128-thread block per (query tile of 64 rows, b*h); the block keeps
// round(q * scale), dO, lse and delta of its rows for the whole key loop
// and stages k, round(k * scale), v and the key bias tile by tile (64
// keys) in shared memory with padded rows; each thread owns 4 rows x 8 key
// columns of p / dp and 4 rows x d/8 columns of the dq accumulator; ds
// goes through shared memory (written and read by the same warp) to the
// dq product. wgmma/TMA are left for a later PR.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // q, dO, k, round(k*scale), v tiles [64][D + 1], ds tile [64][BK + 1],
  // bias tile [BK]; as int: the key tile's segment ids [BK] and the
  // segment range [2]
  return 5 * 64 * (D + 1) + BQ * (BK + 1) + BK + BK + 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int sq, int sk, int d, Strides4 st,
                    float scale, int causal, Dropout dr) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int OPT = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;               // round(q * scale)
  float* gs = qs + BQ * LD;       // dO
  float* ks = gs + BQ * LD;       // k
  float* kbs = ks + BK * LD;      // round(k * scale)
  float* vs = kbs + BK * LD;      // v
  float* dss = vs + BK * LD;      // round(ds)
  float* bs = dss + BQ * LP;      // key bias
  int* kids = reinterpret_cast<int*>(bs + BK);  // key tile's segment ids
  int* seg_sh = kids + BK;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;
  const bool drop = dr.block_q > 0;

  const T* qp = q + b * st.v[0] + h * st.v[1];
  const T* kp = k + b * st.v[3] + h * st.v[4];
  const T* vp = v + b * st.v[6] + h * st.v[7];
  const T* gp = g + b * st.v[9] + h * st.v[10];
  const float* bp = bias ? bias + (long long)b * sk : nullptr;
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float qx = 0.f, gx = 0.f;
    if (q0 + r < sq && c < d) {
      qx = round_to<T>(to_f(qp[(long long)(q0 + r) * st.v[2] + c]) * scale);
      gx = to_f(gp[(long long)(q0 + r) * st.v[11] + c]);
    }
    qs[r * LD + c] = qx;
    gs[r * LD + c] = gx;
  }

  float lse_r[RPT], dl_r[RPT], acc[RPT][OPT];
  unsigned int row_key[RPT];
  int qid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    const bool ok = row < sq;
    qid[i] = (qsp && ok) ? qsp[row] : 0;
    lse_r[i] = ok ? lse[(long long)bh * sq + row] : 0.f;
    dl_r[i] = ok ? delta[(long long)bh * sq + row] : 0.f;
    row_key[i] = drop ? drop_row_key(dr, bh, row) : 0u;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  int kbeg = 0, kend = sk;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    kend = max(0, min(sk, last_row + off + 1));
  }
  if (qsp) {
    const int2 w = seg_window(qsp, q0, min(q0 + BQ, sq), ksp, sk, seg_sh);
    kbeg = w.x / BK * BK;
    kend = min(kend, w.y);
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = to_f(kp[(long long)(k0 + r) * st.v[5] + c]);
        vx = to_f(vp[(long long)(k0 + r) * st.v[8] + c]);
      }
      ks[r * LD + c] = kx;
      kbs[r * LD + c] = round_to<T>(kx * scale);
      vs[r * LD + c] = vx;
    }
    if (tid < BK) {
      bs[tid] = (bp && k0 + tid < sk) ? bp[k0 + tid] : 0.f;
      kids[tid] = (ksp && k0 + tid < sk) ? ksp[k0 + tid] : 0;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(rg * RPT + i) * LD + c];
        gv[i] = gs[(rg * RPT + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(cg + 8 * j) * LD + c];
        vv[j] = vs[(cg + 8 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (ksp && qid[i] != kids[cg + 8 * j]) x = NEG;
        if (causal && col > row + off) x = NEG;
        const float p = (col < sk && row < sq) ? expf(x - lse_r[i]) : 0.f;
        float dpv = dp[i][j];
        if (drop)
          dpv = drop_keep(dr, row_key[i], col) ? dpv * dr.inv_keep : 0.f;
        dss[(rg * RPT + i) * LP + cg + 8 * j] =
            round_to<T>(p * (dpv - dl_r[i]));
      }
    }
    __syncwarp();                 // a row's ds is written by its own warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dv_[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dv_[i] = dss[(rg * RPT + i) * LP + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float kk = kbs[j * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dv_[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= sq) continue;
    T* op = dq + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) op[col] = from_f<T>(acc[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* qseg, const void* kseg, const void* g,
           const void* lse, const void* delta, void* dq,
           int B, int H, int sq, int sk, int d, const Strides4& st,
           float scale, int causal, Dropout dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, sq, sk, d,
      st, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q / dO [B, H, sq, d], k / v [B, H, sk, d] with unit stride on d and
// element strides (batch, head, row) in `strides` (q, k, v, dO: 12 values,
// host memory); bias [B, sk] float32 or null; qseg / kseg as in
// pt_flash_fwd; lse and delta [B * H, sq] float32; dq [B, H, sq, d]
// contiguous. Dropout as in pt_flash_fwd (block_q = 0: none). Returns the
// cudaError_t of the launch.
extern "C" int pt_flash_bwd_dq(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* qseg,
                               const void* kseg, const void* g,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int sq, int sk, int d,
                               const long long* strides, float scale,
                               int causal, unsigned int seed,
                               unsigned int thresh, float inv_keep,
                               int block_q, int block_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype != 0 && dtype != 1) || block_q < 0 ||
      block_k < 0 || (block_q > 0) != (block_k > 0) ||
      (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, inv_keep, block_q, block_k};
  const Strides4 st = Strides4::from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return dtype == 0
        ? launch<float, 64>(q, k, v, bias, qseg, kseg, g, lse, delta, dq, B,
                            H, sq, sk, d, st, scale, causal, dr, s)
        : launch<__nv_bfloat16, 64>(q, k, v, bias, qseg, kseg, g, lse, delta,
                                    dq, B, H, sq, sk, d, st, scale, causal,
                                    dr, s);
  return dtype == 0
      ? launch<float, 128>(q, k, v, bias, qseg, kseg, g, lse, delta, dq, B, H,
                           sq, sk, d, st, scale, causal, dr, s)
      : launch<__nv_bfloat16, 128>(q, k, v, bias, qseg, kseg, g, lse, delta,
                                   dq, B, H, sq, sk, d, st, scale, causal, dr,
                                   s);
}
