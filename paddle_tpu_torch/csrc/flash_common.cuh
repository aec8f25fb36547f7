// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): operand-type conversions and the
// attention-dropout bits.
//
// Every kernel stages its tiles in shared memory as float32 with a padded
// row stride (D + 1), so column reads are free of bank conflicts, and
// accumulates in float32 on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int RPT = 4;        // rows per thread
constexpr int CPT = 8;        // columns per thread
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

// In-kernel attention dropout of one call. block_q == 0 means no dropout.
// The keep bit of logit (row, col) of head bh is the JAX package's
// interpret-mode counter hash (`_hash_bits`, paddle_tpu/ops/attention.py:
// 215) over the LOGICAL blocks (block_q, block_k) the JAX kernels use:
// qi = row / block_q, r = row % block_q, and likewise for the key. So the
// forward and both backward kernels (and the plain PyTorch versions)
// regenerate identical bits whatever tile size each uses, in any order.
struct Dropout {
  unsigned int seed, thresh;
  float inv_keep;
  int block_q, block_k;
};

// the (seed, bh) and row parts of the hash's first xor, per thread
__device__ __forceinline__ unsigned int drop_row_key(const Dropout& dr,
                                                     unsigned int bh,
                                                     int row) {
  const unsigned int qi = (unsigned int)(row / dr.block_q);
  const unsigned int r = (unsigned int)(row % dr.block_q);
  return (dr.seed * 0x9E3779B9u) ^ (bh * 0x85EBCA6Bu) ^ (qi * 0xC2B2AE35u) ^
         (r * 0x165667B1u);
}

// keep bit of (row, col) given the row's drop_row_key
__device__ __forceinline__ bool drop_keep(const Dropout& dr,
                                          unsigned int row_key, int col) {
  const unsigned int ki = (unsigned int)(col / dr.block_k);
  const unsigned int c = (unsigned int)(col % dr.block_k);
  unsigned int x = row_key ^ (ki * 0x27D4EB2Fu) ^ (c * 0x9E3779B9u);
  // murmur3 fmix32 finaliser
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dr.thresh;
}

// element strides (batch, head, row) of four [B, H, s, d] operands,
// passed to a kernel by value
struct Strides4 {
  long long v[12];
  static Strides4 from(const long long* p) {
    Strides4 s;
    for (int i = 0; i < 12; ++i) s.v[i] = p[i];
    return s;
  }
};

}  // namespace flash
