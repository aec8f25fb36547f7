// The attention pieces of the 16-bit (bf16 and f16) flash-attention
// kernels on the tensor cores (flash_fwd.cu, flash_bwd_dq.cu and flash_bwd_dkv.cu), for Hopper
// (sm_90a), over the generic ones of hopper_mma.cuh: the tile copies of
// q, k, v and dO, the scaling of a tile, and the host rules.
//
// A head dim of 128 is two 64-column swizzled tiles 8 KiB apart.
//
// Copies are cp.async (16 bytes a thread) when every row of a view starts
// on 16 bytes, else element by element (`vec`, decided by the C entry
// point and mirrored by the wrapper's counter).
#pragma once

#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_mma.cuh"

namespace flash {
namespace mma {

using namespace hopper;

// Rows [r0, r0 + 64) of a [n, d] matrix of T (bf16 or f16; row stride ld
// elements) into a swizzled tile of D columns (64 or 128); rows >= n and
// columns >= d read as zeros. Called by all 128 threads; cp.async copies
// join the caller's next commit group.
template <int D, typename T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* src,
                                          long long ld, int r0, int n, int d,
                                          bool vec) {
  constexpr int CH = D / 8;
  if (vec) {
#pragma unroll
    for (int j = 0; j < ROWS * CH / 128; ++j) {
      const int i = threadIdx.x + 128 * j;
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < n && c * 8 < d;
      cp_async16(dst + sw_off(r, c),
                 ok ? src + (long long)(r0 + r) * ld + c * 8 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += 128) {
      const int r = i / D, c = i % D;
      T x = Half16<T>::from(0.f);
      if (r0 + r < n && c < d) x = src[(long long)(r0 + r) * ld + c];
      *reinterpret_cast<T*>(dst + sw_off(r, c >> 3) + (c & 7) * 2) = x;
    }
  }
}

// the tile's elements times `scale`, rounded back to T, written to dst
// (dst may be src). Called by all 128 threads.
template <int D, typename T>
__device__ __forceinline__ void scale_tile(uint8_t* dst, const uint8_t* src,
                                           float scale) {
#pragma unroll
  for (int j = 0; j < ROWS * D / 8 / 128; ++j) {
    const int i = threadIdx.x + 128 * j;
    uint4 x = reinterpret_cast<const uint4*>(src)[i];
    uint32_t* h = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = Half16<T>::unpack(h[j]);
      h[j] = Half16<T>::pack(f.x * scale, f.y * scale);
    }
    reinterpret_cast<uint4*>(dst)[i] = x;
  }
}

// Host side. Whether every row of the four [B, H, s, d] views (q, k, v, dO;
// the forward passes q again for dO) starts on 16 bytes, so whole rows go
// by 16-byte cp.async: d a multiple of 8 elements, every base pointer
// 16-byte aligned, every batch, head and row stride a multiple of 8
// elements. The wrappers ask the same question through
// `pt_flash_bwd_vector_loads` (flash_bwd_dq.cu) and
// `pt_flash_fwd_vector_loads` (flash_fwd.cu).
inline int vector_loads(const void* const* ptrs, const long long* strides,
                        int d) {
  if (d % 8 != 0) return 0;
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return 0;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return 0;
  return 1;
}

// whether round(x * scale) == x * scale for every bf16 x: scale is a
// power of two (and for every f16 x whose product stays in f16's normal
// range; below it the kernel's unrounded product is the closer one)
inline int power_of_two(float scale) {
  int e;
  return frexpf(fabsf(scale), &e) == 0.5f;
}

}  // namespace mma
}  // namespace flash
