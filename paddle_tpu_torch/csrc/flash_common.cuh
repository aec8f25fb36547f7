// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): operand-type conversions, the
// attention-dropout bits and the segment-id bounds of packed rows.
//
// The SIMT kernels (the forward, and the backward in float32) stage their
// tiles in shared memory as float32 with a padded row stride (D + 1), so
// column reads are free of bank conflicts, and accumulate in float32 on
// the CUDA cores. The bf16 backward runs on the tensor cores
// (flash_mma.cuh).
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
// A launch on a shard of a larger call (a data-parallel rank's rows, a
// tensor-parallel rank's heads) hashes the GLOBAL head index: local
// (b, h) = (bh / H, bh % H) is (b0 + b, h0 + h) of a call with `heads`
// heads, so every shard draws the bits of its slice of the whole call.
// b0 = h0 = 0 and heads = H give bh itself.
struct Dropout {
  unsigned int seed, thresh;
  float inv_keep;
  int block_q, block_k;
  int H, b0, h0, heads;
};

// the global head index of local head bh
__device__ __forceinline__ unsigned int drop_bh(const Dropout& dr,
                                                unsigned int bh) {
  const unsigned int H = (unsigned int)dr.H;
  return ((unsigned int)dr.b0 + bh / H) * (unsigned int)dr.heads +
         (unsigned int)dr.h0 + bh % H;
}

// the (seed, bh) and row parts of the hash's first xor, per thread
__device__ __forceinline__ unsigned int drop_row_key(const Dropout& dr,
                                                     unsigned int bh,
                                                     int row) {
  const unsigned int qi = (unsigned int)(row / dr.block_q);
  const unsigned int r = (unsigned int)(row % dr.block_q);
  return (dr.seed * 0x9E3779B9u) ^ (drop_bh(dr, bh) * 0x85EBCA6Bu) ^
         (qi * 0xC2B2AE35u) ^ (r * 0x165667B1u);
}

// the entry points' check of a dropout address: 0 when it is legal
inline int drop_address_bad(int block_q, int H, int b0, int h0, int heads) {
  return block_q > 0 && (H < 1 || b0 < 0 || h0 < 0 || heads < h0 + H);
}

// the column part of the hash's first xor
__device__ __forceinline__ unsigned int drop_col_key(const Dropout& dr,
                                                     int col) {
  const unsigned int ki = (unsigned int)(col / dr.block_k);
  const unsigned int c = (unsigned int)(col % dr.block_k);
  return (ki * 0x27D4EB2Fu) ^ (c * 0x9E3779B9u);
}

// keep bit of the logit whose row and column keys xor to x
__device__ __forceinline__ bool drop_keep_mixed(const Dropout& dr,
                                                unsigned int x) {
  // murmur3 fmix32 finaliser
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= dr.thresh;
}

// keep bit of (row, col) given the row's drop_row_key
__device__ __forceinline__ bool drop_keep(const Dropout& dr,
                                          unsigned int row_key, int col) {
  return drop_keep_mixed(dr, row_key ^ drop_col_key(dr, col));
}

// Packed rows (the segment-id branch): per-token int32 ids, [B, sq] for
// the queries and [B, sk] for the keys, non-decreasing along each row
// (`core/lod.pack_padded`), restrict attention to pairs of equal ids. A
// pair of different ids is masked like a causal key (-1e30), and a tile
// visits only the tiles of the other side whose tokens share an id with
// it: with monotone ids those tokens form one range, found by binary
// search.

// first index of ids[0, n) (non-decreasing) whose id is >= v, or > v
// when `upper`
__device__ __forceinline__ int seg_bound(const int* ids, int n, int v,
                                         bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int x = ids[mid];
    if (x < v || (upper && x == v))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The token range [lo, hi) of the other side (ids other[0, n)) whose ids
// lie within [min, max] of this tile's ids own[t0, t1), t0 < t1: the only
// tokens this tile's tokens pair with. Called by every thread of the
// block (it synchronises): the first warp reduces, its first lane
// searches, and `sh` (2 ints of shared memory) broadcasts the range.
__device__ __forceinline__ int2 seg_window(const int* own, int t0, int t1,
                                           const int* other, int n,
                                           int* sh) {
  if (threadIdx.x < 32) {
    int mn = 0x7fffffff, mx = -0x7fffffff - 1;
    for (int t = t0 + (int)threadIdx.x; t < t1; t += 32) {
      const int x = own[t];
      mn = min(mn, x);
      mx = max(mx, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (threadIdx.x == 0) {
      sh[0] = seg_bound(other, n, mn, false);
      sh[1] = seg_bound(other, n, mx, true);
    }
  }
  __syncthreads();
  return make_int2(sh[0], sh[1]);
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
