// Gathered LoRA delta for Hopper (sm_90a): for every batch row i,
//   out[i] = (x[i] @ A[ids[i]]) @ B[ids[i]]
// with x [b, s, d] float32, the stacked adapter banks A [cap, d, r] and
// B [cap, r, n] float32, ids [b] int32 and out [b, s, n] float32. The
// wrapper (ops/quant.py `lora_delta`) casts a bf16 x to float32 first and
// the result back to x's type.
//
// Replaces: paddle_tpu/ops/quant.py `_lora_gather_call` (the Pallas
// kernel behind `lora_delta`, whose A/B index maps dereference the
// scalar-prefetched ids). Same math in float32: xa = x[i] @ A[id], then
// xa @ B[id]. Bank row 0 is the base model and holds zeros, so a base
// row gets an exact zero through the same arithmetic (no short cut: a
// NaN in x stays a NaN, as in the plain version). Each block loads its
// own row's id, which takes the place of the scalar prefetch; the
// wrapper has checked every id against [0, cap) on the host, and an id
// outside it would only write NaN here, never read past the banks.
//
// What bounds it on an H100: device-memory bandwidth. The delta is a
// rank-r product (r = 8 on the serving path): 2 * s * r * (d + n) flops
// against the bytes of x, the A and B rows of the row's adapter, and
// out, far below the card's float32 ridge. Design: one 256-thread block
// per (batch row, 32-row tile of s, 256 output columns). Phase 1 stages
// 128-wide slices of the x tile's valid rows and of A[id] in shared
// memory and computes the tile's xa [32 x r] there; when the tile has few
// rows (a decode step has s = 1) up to 32 threads share one xa entry and
// reduce with warp shuffles, so the d-long sums still run in parallel.
// Phase 2
// gives each thread one output column: it reads B[id][:, column] once
// (consecutive threads, consecutive addresses) and multiplies it into
// the tile's rows. xa is recomputed for every 256-column tile of n: at
// r = 8 that is 8 * d flops a row, small beside the tile's own work, and
// it keeps the blocks independent (no second pass, no atomics).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ST = 32;          // rows of s per block
constexpr int KC = 128;         // k per staged slice of phase 1
constexpr int RMAX = 32;        // the largest rank (ops/quant.py checks)
constexpr int BN = THREADS;     // output columns per block

__global__ void __launch_bounds__(THREADS)
lora_gather_kernel(const float* __restrict__ x, const float* __restrict__ A,
                   const float* __restrict__ B, const int* __restrict__ ids,
                   float* __restrict__ out, int s, int d, int r, int n,
                   int cap) {
  __shared__ float xs[ST][KC + 1];       // x tile slice
  __shared__ float at[RMAX][KC + 1];     // A[id] slice, transposed
  __shared__ float xa[ST][RMAX + 1];     // the tile's x @ A[id]
  const int tid = threadIdx.x;
  const int i = blockIdx.z, s0 = blockIdx.y * ST;
  const int sv = min(ST, s - s0);        // valid rows of this tile
  const int c = blockIdx.x * BN + tid;
  float* orow = out + ((long long)i * s + s0) * n;
  const int id = ids[i];
  if (id < 0 || id >= cap) {
    if (c < n)
      for (int t = 0; t < sv; ++t)
        orow[(long long)t * n + c] = __int_as_float(0x7fc00000);
    return;
  }
  const float* xi = x + ((long long)i * s + s0) * d;
  const float* ai = A + (long long)id * d * r;
  const float* bi = B + (long long)id * r * n;

  // phase 1: xa[t][j] = sum_k x[i, s0 + t, k] * A[id][k, j]. O outputs,
  // g threads (a power of two up to a warp) per output.
  const int O = sv * r;
  int g = 1;
  while (g < 32 && 2 * g * O <= THREADS) g *= 2;
  const int sub = tid % g, grp = tid / g, ngrp = THREADS / g;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};   // O <= ST * RMAX = 4 * THREADS
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kc = min(KC, d - k0);
    for (int idx = tid; idx < sv * KC; idx += THREADS) {   // valid rows
      const int t = idx / KC, kk = idx % KC;
      xs[t][kk] = kk < kc ? xi[(long long)t * d + k0 + kk] : 0.f;
    }
    for (int idx = tid; idx < kc * r; idx += THREADS)
      at[idx % r][idx / r] = ai[(long long)k0 * r + idx];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = grp + u * ngrp;
      if (o < O) {
        const int t = o / r, j = o % r;
        float a = acc[u];
        for (int kk = sub; kk < kc; kk += g) a = fmaf(xs[t][kk], at[j][kk], a);
        acc[u] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float v = acc[u];
    for (int off = g >> 1; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int o = grp + u * ngrp;
    if (sub == 0 && o < O) xa[o / r][o % r] = v;
  }
  __syncthreads();

  // phase 2: out[i, s0 + t, c] = sum_j xa[t][j] * B[id][j, c]
  if (c >= n) return;
  float acc2[ST];
#pragma unroll
  for (int t = 0; t < ST; ++t) acc2[t] = 0.f;
  for (int j = 0; j < r; ++j) {
    const float bj = bi[(long long)j * n + c];
#pragma unroll
    for (int t = 0; t < ST; ++t)
      if (t < sv) acc2[t] = fmaf(xa[t][j], bj, acc2[t]);
  }
#pragma unroll
  for (int t = 0; t < ST; ++t)
    if (t < sv) orow[(long long)t * n + c] = acc2[t];
}

}  // namespace

// C entry point, bound with ctypes. x [b, s, d], A [cap, d, r] and
// B [cap, r, n] float32, ids [b] int32 (each in [0, cap)), all contiguous;
// out [b, s, n] float32. 1 <= r <= 32. Returns the launch's cudaError_t.
extern "C" int pt_lora_gather(int device, const void* x, const void* A,
                              const void* B, const void* ids, void* out,
                              int b, int s, int d, int r, int n, int cap,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r < 1 || r > RMAX || b < 0 || s < 0 || d < 0 || n < 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || n == 0) return 0;
  dim3 grid((n + BN - 1) / BN, (s + ST - 1) / ST, b);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  lora_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const int*>(ids),
      static_cast<float*>(out), s, d, r, n, cap);
  return (int)cudaGetLastError();
}
