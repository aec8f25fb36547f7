// Shared pieces of the fused 1x1-conv + BatchNorm kernels
// (fused_conv_fwd.cu, fused_conv_bwd.cu): the element types, the
// normalized activation both kernels recompute on chip, the tile
// geometry, and the fixed-order second pass that adds per-tile partials.
//
// Layout (the JAX package's, NCHW with HW flattened): x [B, Ci, HW],
// z and dz [B, Co, HW], W [Co, Ci] (float32: the wrapper widens a bf16
// weight, which is exact). The column axis of every product is the
// flattened (image, position) axis n = b * HW + p, so a 64-column tile
// may span two images and no tile is wasted on a ragged HW (3136, 784,
// 196 and 49 at ResNet-50's stages are no multiples of 64); only the
// last tile of the whole axis is partial, and it is masked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fc {

constexpr int THREADS = 256;
constexpr int TM = 64;   // rows of a block's output tile
constexpr int TN = 64;   // columns of a block's output tile
constexpr int TK = 16;   // depth of a staged slice

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The element rounded to T and widened again: what the JAX kernel's
// `.astype(dtype)` leaves in a float32 register.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ReLU that keeps a NaN (jnp.maximum and torch.clamp_min do).
__device__ __forceinline__ float relu_f(float v) { return v < 0.f ? 0.f : v; }

// pre = f32(x) * scale + shift, rounded as two separate float32 ops (no
// contraction into an FMA), so the ReLU mask and the rounding of xn
// agree with the plain version bit for bit.
__device__ __forceinline__ float affine(float xv, float sc, float sh) {
  return __fadd_rn(__fmul_rn(xv, sc), sh);
}

// The normalized activation xn of one element, as a float: with a norm,
// act(f32(x) * scale + shift) rounded to T; without, act(x) (exact in T).
template <typename T>
__device__ __forceinline__ float act_in(T xv, const float* scale,
                                        const float* shift, int c,
                                        int has_norm, int relu) {
  const float v = to_f(xv);
  if (has_norm) {
    const float pre = affine(v, scale[c], shift[c]);
    return round_to<T>(relu ? relu_f(pre) : pre);
  }
  return relu ? relu_f(v) : v;
}

// Offset of column n = b * HW + p in a [B, C, HW] tensor, channel 0.
__device__ __forceinline__ long long col_offset(int n, int C, int HW) {
  const int b = n / HW;
  return (long long)b * C * HW + (n - b * HW);
}

// The second pass of a per-tile reduction: out0[c] = sum_t part[c][t] and
// out1[c] = sum_t part[C + c][t], one block per channel, each thread over
// a strided run of tiles, then a tree over the block's threads: the same
// order on every run, whatever the scheduling of the first pass.
__global__ void __launch_bounds__(THREADS)
reduce_partials(const float* __restrict__ part, float* __restrict__ out0,
                float* __restrict__ out1, int C, int P) {
  __shared__ float r0[THREADS], r1[THREADS];
  const int c = blockIdx.x, tid = threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int t = tid; t < P; t += THREADS) {
    a += part[(long long)c * P + t];
    b += part[(long long)(C + c) * P + t];
  }
  r0[tid] = a;
  r1[tid] = b;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) {
      r0[tid] += r0[tid + o];
      r1[tid] += r1[tid + o];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out0[c] = r0[0];
    out1[c] = r1[0];
  }
}

// The 16 x 16 products of one staged slice (both slices padded by 4
// floats a row, which keeps the transposing stores of the dW kernel at
// two-way bank conflicts): a thread owns rows
// ty * 4 + i and columns tx + 16 * j of the block's 64 x 64 tile (rows
// from `as`, columns from `bs`, both k-major), so each store of the
// epilogue covers 16 consecutive columns across a half-warp.
__device__ __forceinline__ void mma_slice(float (*as)[TM + 4],
                                          float (*bs)[TN + 4],
                                          float (&acc)[4][4], int ty,
                                          int tx) {
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Sum v over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fc
