// Split-K flash decode for Hopper (sm_90a): one query token per (batch,
// head) row against a preallocated [B, H, L, d] KV cache, emitting one
// partial softmax (acc, m, l) per key split. The logsumexp combine of the
// partials stays outside the kernel (torch ops), as the JAX package does it
// in XLA.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_decode_call` (the Pallas
// split-K decode kernel, called from `flash_decode`). Same math per split:
// logits = (q * scale) . k, keys at positions >= the row's written length
// set to -1e30, then the optional [B, L] f32 key bias added; m = max over
// the split, p = exp(logits - m) rounded to the operand type for the p.v
// product, l = sum(p). A split that starts at or past the row's written
// length emits exactly the TPU kernel's skip value: acc = 0, m = -1e30,
// l = 0. The per-row length is read inside the kernel (the TPU kernel
// took it by scalar prefetch).
//
// Differences from the TPU kernel, by design: any L (the last split may be
// ragged; keys past L never enter the softmax) and a fixed split size
// chosen for the H100's 132 SMs instead of the TPU's 128-multiple ladder.
//
// What bounds it on an H100: device-memory bandwidth. Each needed K and V
// element is read once (2 * length * d * 4 bytes per row in fp32) against
// 4 flops per element, far below the card's ~20 flop/byte fp32 ridge.
// Design: one 128-thread block per (split, b*h); each warp takes every 4th
// key of the split, its 32 lanes read a key row as consecutive elements
// (fully coalesced), reduce the dot product with warp shuffles and keep a
// running (m, l, acc) online softmax in registers; four keys per iteration
// keep several row loads in flight. The four warps' partials merge in
// shared memory by a logsumexp into the split's (acc, m, l).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;               // keys per warp per iteration
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
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ lengths, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    int H, int L, int d, int split, int n_splits,
                    long long qsb, long long qsh, long long ksb,
                    long long ksh, long long kss, long long vsb,
                    long long vsh, long long vss, float scale) {
  constexpr int PER = D / 32;      // elements of a row per lane
  __shared__ float sm_m[WARPS], sm_l[WARPS], sm_a[WARPS][D];

  const int si = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_valid = lengths[b];
  const int start = si * split;
  const long long part = (long long)bh * n_splits + si;
  float* ao = acc_out + part * d;

  if (start >= n_valid) {
    // the split lies entirely past the written cache region: an exact
    // zero contribution to the combine (m = -1e30 makes its weight 0)
    for (int c = threadIdx.x; c < d; c += THREADS) ao[c] = 0.f;
    if (threadIdx.x == 0) {
      m_out[part] = NEG;
      l_out[part] = 0.f;
    }
    return;
  }
  const int end = min(start + split, L);

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const float* bp = bias ? bias + (long long)b * L : nullptr;

  float qv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < d ? round_to<T>(to_f(qp[c]) * scale) : 0.f;
  }

  float mw = -INFINITY, lw = 0.f, aw[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) aw[i] = 0.f;

  for (int j0 = start + warp; j0 < end; j0 += WARPS * U) {
    float sc[U], kr[U][PER], vr[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + WARPS * u;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        const bool ok = j < end && c < d;
        kr[u][i] = ok ? to_f(kp[(long long)j * kss + c]) : 0.f;
        vr[u][i] = ok ? to_f(vp[(long long)j * vss + c]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part_dot = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part_dot = fmaf(qv[i], kr[u][i], part_dot);
      sc[u] = part_dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + WARPS * u;
      float x = -INFINITY;        // past L: never enters the softmax
      if (j < end) {
        x = j < n_valid ? sc[u] : NEG;
        if (bp) x += bp[j];
      }
      sc[u] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(mw, mx);   // finite: key j0 is in range
    const float alpha = expf(mw - m_new);
    float p[U];
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = expf(sc[u] - m_new);
      ps += p[u];
      p[u] = round_to<T>(p[u]);
    }
    lw = lw * alpha + ps;
    mw = m_new;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float a = aw[i] * alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][i], a);
      aw[i] = a;
    }
  }

  if (lane == 0) {
    sm_m[warp] = mw;
    sm_l[warp] = lw;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) sm_a[warp][lane + 32 * i] = aw[i];
  __syncthreads();
  float ms = sm_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) ms = fmaxf(ms, sm_m[w]);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sm_a[w][c] * expf(sm_m[w] - ms);
    ao[c] = a;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ls += sm_l[w] * expf(sm_m[w] - ms);
    m_out[part] = ms;
    l_out[part] = ls;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* lengths, void* acc, void* m, void* l, int B, int H,
           int L, int d, int split, const long long* st, float scale,
           cudaStream_t stream) {
  const int n_splits = (L + split - 1) / split;
  dim3 grid(n_splits, B * H);
  flash_decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), H, L, d, split,
      n_splits, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, 1, d], k/v [B, H, L, d], each with unit stride on d; `strides`
// holds (q batch, q head, k batch, k head, k row, v batch, v head, v row)
// in elements. lengths: [B] int32 written counts; bias: [B, L] float32 or
// null. Outputs: acc [B * H, n_splits, d], m and l [B * H, n_splits],
// float32, n_splits = ceil(L / split). Returns the launch's cudaError_t.
extern "C" int pt_flash_decode(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* lengths,
                               void* acc, void* m, void* l, int B, int H,
                               int L, int d, int split,
                               const long long* strides, float scale,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || split < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return dtype == 0
        ? launch<float, 64>(q, k, v, bias, lengths, acc, m, l, B, H, L, d,
                            split, strides, scale, s)
        : launch<__nv_bfloat16, 64>(q, k, v, bias, lengths, acc, m, l, B, H,
                                    L, d, split, strides, scale, s);
  return dtype == 0
      ? launch<float, 128>(q, k, v, bias, lengths, acc, m, l, B, H, L, d,
                           split, strides, scale, s)
      : launch<__nv_bfloat16, 128>(q, k, v, bias, lengths, acc, m, l, B, H,
                                   L, d, split, strides, scale, s);
}
