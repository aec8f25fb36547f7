// The tensor-core pieces of the fused 1x1-conv + BatchNorm kernels for
// Hopper (sm_90a), shared by the bf16 forward (fused_conv_fwd.cu) and the
// bf16 dx and dW products of the backward (fused_conv_bwd.cu), over the
// generic wgmma pieces of hopper_mma.cuh.
//
// Raw bf16 chunks of x, z and dz land in 128-byte-swizzled shared tiles by
// cp.async; the thread that copied a chunk then turns it into the
// product's operand in place (xn8: the normalized activation; dzb8:
// dz_eff rounded to bf16), so neither operand ever exists in device
// memory. Columns of the flattened (image, position) axis n = b * HW + p
// past its end become zeros, so they add nothing to a product or a sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_conv.cuh"
#include "hopper_mma.cuh"

namespace fc {

using bf16 = __nv_bfloat16;
constexpr int EB = 16;   // element loads a thread has in flight

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// dz_eff of one element in float32: ((dz + ds) + (2 z) dss), each op
// rounded on its own (dz_eff's order)
__device__ __forceinline__ float dz_eff_f(float dzv, float zv, float ds,
                                          float dss) {
  return __fadd_rn(__fadd_rn(dzv, ds), __fmul_rn(__fmul_rn(2.f, zv), dss));
}

// xn of one element in float32, before its rounding (act_in's math)
__device__ __forceinline__ float xn_f(float xv, float sc, float sh,
                                      int has_norm, int relu) {
  const float v = has_norm ? affine(xv, sc, sh) : xv;
  return relu ? relu_f(v) : v;
}

// bf16 element `raw` (as loaded) widened
__device__ __forceinline__ float bf_f(uint32_t raw) {
  return __uint_as_float(raw << 16);
}

// The chunk of 8 z values at zc becomes its dzb = round(dz_eff) (dz from
// the chunk at dzc) in place, two values a conversion; columns n + e >=
// end become zeros.
__device__ __forceinline__ void dzb8(uint8_t* zc, const uint8_t* dzc,
                                     float ds, float dss, int n, int end) {
  uint4 zv = *reinterpret_cast<const uint4*>(zc);
  const uint4 dv = *reinterpret_cast<const uint4*>(dzc);
  __nv_bfloat162* z2 = reinterpret_cast<__nv_bfloat162*>(&zv);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  const bool full = n + 8 <= end;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float2 a = __bfloat1622float2(z2[h]), b = __bfloat1622float2(d2[h]);
    float lo = dz_eff_f(b.x, a.x, ds, dss), hi = dz_eff_f(b.y, a.y, ds, dss);
    if (!full) {
      lo = n + 2 * h < end ? lo : 0.f;
      hi = n + 2 * h + 1 < end ? hi : 0.f;
    }
    z2[h] = __floats2bfloat162_rn(lo, hi);
  }
  *reinterpret_cast<uint4*>(zc) = zv;
}

// The chunk of 8 x values at xc becomes its xn (act_in) in place, two
// values a conversion; columns n + e >= end become zeros.
__device__ __forceinline__ void xn8(uint8_t* xc, float sc, float sh,
                                    int has_norm, int relu, int n, int end) {
  uint4 xv = *reinterpret_cast<const uint4*>(xc);
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&xv);
  const bool full = n + 8 <= end;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float2 v = __bfloat1622float2(x2[h]);
    v.x = xn_f(v.x, sc, sh, has_norm, relu);
    v.y = xn_f(v.y, sc, sh, has_norm, relu);
    if (!full) {
      v.x = n + 2 * h < end ? v.x : 0.f;
      v.y = n + 2 * h + 1 < end ? v.y : 0.f;
    }
    x2[h] = __floats2bfloat162_rn(v.x, v.y);
  }
  *reinterpret_cast<uint4*>(xc) = xv;
}

// The 8 columns n .. n + 7 of one 16-byte chunk that a thread copies in
// a stage: the element offsets
// (channel 0 of a [B, C, HW] tensor) of columns n and n + 4, and whether
// each lies before the axis's end N. With HW a multiple of 8 (4) a run of
// 8 (4) columns never crosses an image.
struct Chunk {
  long long off0, off4;
  bool in0, in4;
};

__device__ __forceinline__ Chunk chunk_at(int n, int N, int C, int HW) {
  Chunk k;
  k.in0 = n < N;
  k.in4 = n + 4 < N;
  k.off0 = k.in0 ? col_offset(n, C, HW) : 0;
  k.off4 = k.in4 ? col_offset(n + 4, C, HW) : 0;
  return k;
}

// Copy channel ch of chunk k of the [B, C, HW] tensor src into the 16
// bytes at dst: vec 8, one 16-byte cp.async; vec 4, two 8-byte ones.
// Columns past the end and channels that are not `ok` read as zeros.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const bf16* src,
                                           const Chunk& k, long long ch_off,
                                           bool ok, int vec) {
  using namespace hopper;
  if (vec == 8) {
    const bool in = ok && k.in0;
    cp_async16(dst, in ? src + k.off0 + ch_off : src, in ? 16 : 0);
  } else {
    const bool in0 = ok && k.in0, in4 = ok && k.in4;
    cp_async8(dst, in0 ? src + k.off0 + ch_off : src, in0 ? 8 : 0);
    cp_async8(dst + 8, in4 ? src + k.off4 + ch_off : src, in4 ? 8 : 0);
  }
}

// Rows r0 .. r0 + ROWS_ - 1 and columns c0 .. c0 + 8 CPR - 1 of a
// [R, ld] bf16 matrix (row r at src + r * ld) into a swizzled tile of
// CPR 16-byte chunks a row: `wide` 1 copies by cp.async (ld a multiple
// of 8, src 16-byte aligned: `rows_wide`), else element by element; rows
// >= R and columns >= cols read as zeros. Called by all THREADS_ threads
// of the block.
template <int ROWS_, int CPR, int THREADS_>
__device__ __forceinline__ void copy_rows(uint8_t* dst, const bf16* src,
                                          long long ld, int r0, int R,
                                          int c0, int cols, int wide) {
  using namespace hopper;
  const int tid = threadIdx.x;
  if (wide) {
#pragma unroll
    for (int j = 0; j < ROWS_ * CPR / THREADS_; ++j) {
      const int i = tid + THREADS_ * j;
      const int r = i / CPR, c = i % CPR;
      const int col = c0 + 8 * c;
      const bool in = r0 + r < R && col < cols;
      cp_async16(dst + sw_off(r, c),
                 in ? src + (long long)(r0 + r) * ld + col : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS_ * CPR * 8; i += THREADS_) {
      const int r = i / (CPR * 8), c = i % (CPR * 8);
      const bool in = r0 + r < R && c0 + c < cols;
      *reinterpret_cast<bf16*>(dst + sw_off(r, c >> 3) + 2 * (c & 7)) =
          in ? src[(long long)(r0 + r) * ld + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// Host side. Widest copy that every [B, C, HW] row run of these pointers
// takes: 8 elements (16 bytes) when HW is a multiple of 8, 4 when of 4,
// else 1; narrower when a base pointer is not aligned to it.
inline int copy_width(int HW, const void* const* ptrs, int n) {
  int vec = HW % 8 == 0 ? 8 : HW % 4 == 0 ? 4 : 1;
  for (int i = 0; i < n; ++i) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(ptrs[i]);
    while (vec > 1 && a % (2 * vec) != 0) vec = vec == 8 ? 4 : 1;
  }
  return vec;
}

// Whether the rows of a [R, ld] bf16 matrix at p all start on 16 bytes,
// so `copy_rows` copies them by cp.async.
inline int rows_wide(const void* p, int ld) {
  return ld % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Barrier of one warpgroup's 128 threads (named barrier 1 + wg; 0 is
// __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A 64 x 64 tile of float32 values in the wgmma accumulator layout of
// warpgroup wg, rounded to bf16, into a swizzled tile at `stage` (8 KiB),
// so `store_tile` can write it out in whole rows.
__device__ __forceinline__ void stage_tile(uint8_t* stage,
                                           const float (&d)[32], int wg) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = frag_row(i) - 64 * wg, c = frag_col(i);
    *reinterpret_cast<__nv_bfloat162*>(stage + sw_off(r, c >> 3) +
                                       2 * (c & 7)) =
        __floats2bfloat162_rn(d[i], d[i + 1]);
  }
}

// The staged tile into channels ch0 .. ch0 + 63 (< C) and columns n0 ..
// n0 + 63 (< N) of a [B, C, HW] bf16 tensor, by the 128 threads of a
// warpgroup (lt its thread index there), each row's 128 bytes by 8
// adjacent threads: 16 bytes a store (vec 8), 8 (vec 4) or element by
// element (vec 1; `copy_width` of the tensor).
__device__ __forceinline__ void store_tile(bf16* dst, const uint8_t* stage,
                                           int n0, int N, int ch0, int C,
                                           int HW, int vec, int lt) {
  using namespace hopper;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = lt + 128 * k, r = idx >> 3, c = idx & 7;
    const int ch = ch0 + r, n = n0 + 8 * c;
    if (ch >= C || n >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + sw_off(r, c));
    const long long at = (long long)ch * HW;
    if (vec == 8) {
      *reinterpret_cast<uint4*>(dst + col_offset(n, C, HW) + at) = v;
    } else if (vec == 4) {
      *reinterpret_cast<uint2*>(dst + col_offset(n, C, HW) + at) =
          make_uint2(v.x, v.y);
      if (n + 4 < N)
        *reinterpret_cast<uint2*>(dst + col_offset(n + 4, C, HW) + at) =
            make_uint2(v.z, v.w);
    } else {
      // one division, then steps across an image's end
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
      unsigned short* d = reinterpret_cast<unsigned short*>(dst);
      int b = n / HW, p = n - b * HW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (n + j < N) d[((long long)b * C) * HW + at + p] = e[j];
        if (++p == HW) {
          p = 0;
          ++b;
        }
      }
    }
  }
}

// The raw bf16 values of columns n (low half) and n + 1 (high half), n
// even, of channel ch of a [B, C, HW] bf16 tensor; zeros for columns >= N.
// One 4-byte load with HW even, else two.
__device__ __forceinline__ uint32_t load_pair(const bf16* src, int n, int N,
                                              int C, int HW, int ch) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  if ((HW & 1) == 0)
    return n < N ? __ldg(reinterpret_cast<const unsigned int*>(
                       s + col_offset(n, C, HW) + (long long)ch * HW))
                 : 0u;
  uint32_t lo = 0u, hi = 0u;
  if (n < N) lo = __ldg(s + col_offset(n, C, HW) + (long long)ch * HW);
  if (n + 1 < N) hi = __ldg(s + col_offset(n + 1, C, HW) + (long long)ch * HW);
  return lo | (hi << 16);
}

// Element copies (HW neither a multiple of 4 nor of 8): rows erow +
// estep * k, k < 64 / estep, of column `col` (its element offset `off`
// in channel 0, `in` when it lies before the end) of channels k0 .. k0 +
// 63 of a [B, C, HW] bf16 tensor, raw, into a swizzled tile; channels
// >= C and columns past the end read as zeros. EB loads in flight.
__device__ __forceinline__ void copy_elements(uint8_t* dst, const bf16* src,
                                              long long off, bool in,
                                              int col, int erow, int estep,
                                              int k0, int C, int HW) {
  using namespace hopper;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src) +
                            off;
  for (int k1 = 0; k1 < 64 / estep; k1 += EB) {
    unsigned short v[EB];
#pragma unroll
    for (int k = 0; k < EB; ++k) {
      const int c = k0 + erow + estep * (k1 + k);
      v[k] = in && c < C ? __ldg(s + (long long)c * HW) : (unsigned short)0;
    }
#pragma unroll
    for (int k = 0; k < EB; ++k)
      *reinterpret_cast<unsigned short*>(
          dst + sw_off(erow + estep * (k1 + k), col >> 3) + 2 * (col & 7)) =
          v[k];
  }
}

// How many column tiles each block of a tensor-core kernel walks (its
// ring runs on from one tile into the next, so one tile's epilogue
// overlaps the next one's copies): enough that the blocks of `rows` row
// tiles fill one wave of the card (`per_sm` blocks an SM).
inline int tiles_per_block(int device, int tiles, int rows, int per_sm) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms < 1)
    sms = 1;
  long long groups = (long long)sms * (per_sm > 0 ? per_sm : 1) / rows;
  if (groups < 1) groups = 1;
  return (int)((tiles + groups - 1) / groups);
}

// Sum v over the 4 threads of a quad (the threads that hold one row of a
// wgmma accumulator fragment), in a fixed order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace fc
