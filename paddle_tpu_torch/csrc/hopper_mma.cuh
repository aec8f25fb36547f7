// Tensor-core pieces shared by the 16-bit kernels for Hopper (sm_90a): the
// flash-attention forward and backward (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu, through flash_mma.cuh) and the fused 1x1-conv +
// BN forward and backward (fused_conv_fwd.cu, fused_conv_bwd.cu, through
// fused_conv_mma.cuh).
//
// Tiles are 64 rows of bf16 in shared memory, 128 bytes (64 columns) a
// row, in the 128-byte swizzle that wgmma reads: the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) of its row. A wider operand is several
// such 64-column tiles TILE_BYTES apart; a taller one continues the rows
// (row r at byte r * 128, the swizzle repeating every 8 rows). One layout
// serves both roles of a tile: read K-major (its columns are the
// reduction dim: Q.K^T) and read MN-major (its rows are the reduction
// dim: P.V), by the transpose bits of the descriptors.
//
// The products are wgmma m64n64k16 with bf16 (or, for the flash kernels'
// float16 instances, f16) operands and float32 accumulators: A from shared
// memory or from registers (the accumulator layout of an earlier product,
// `to_a`), B from shared memory. The operand type T is a template argument,
// __nv_bfloat16 by default; `Half16<T>` holds its conversions. Copies into
// the tiles are cp.async, 16, 8 or 4 bytes a thread with zero fill.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int ROWS = 64;                // rows of a tile, and of a warpgroup
constexpr int TILE_BYTES = ROWS * 128;  // one 64-column swizzled tile

// The conversions of a 16-bit operand type: one value from float (round to
// nearest even), two packed into a 32-bit register, and back.
template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
  __device__ __forceinline__ static uint32_t pack(float x, float y) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  }
};

template <>
struct Half16<__half> {
  __device__ __forceinline__ static __half from(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static uint32_t pack(float x, float y) {
    __half2 h = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<__half2*>(&u));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (any column block) of row r in a tile
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 3) * TILE_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a swizzled tile at `p` (plus a byte
// offset inside it): 128-byte swizzle; both byte offsets 1024, the stride
// of 8 rows, which is what a K-major operand reads and, for one 64-wide
// MN block, all an MN-major operand reads
__device__ __forceinline__ uint64_t desc(const void* p, int offset) {
  const uint64_t a = (smem_u32(p) + offset) & 0x3FFFF;
  return (a >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// descriptor offset of reduction step kk (16 columns) of a K-major tile
__device__ __forceinline__ int k_major_step(int kk) {
  return (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
}

// descriptor offset of reduction step kk (16 rows) and 64-column block
// nb of an MN-major tile
__device__ __forceinline__ int mn_major_step(int kk, int nb) {
  return nb * TILE_BYTES + kk * 16 * 128;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warp's wgmma groups are pending (groups
// complete in the order they were committed)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin the accumulator registers at this point of the program, so the
// compiler neither reads them before a wgmma wait nor moves them between
// the asynchronous instructions
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] = A[64 x 16] . B[16 x 64], both from shared memory, both
// K-major: the first reduction step of a product. D is written only, so
// no register of it has to be set before the product starts
#define HOPPER_WGMMA_SS_FIRST(TY)                                           \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),         \
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),         \
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),    \
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),    \
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),    \
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),    \
        "=f"(d[30]), "=f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(0))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_SS_FIRST("f16");
  else
    HOPPER_WGMMA_SS_FIRST("bf16");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory; TA
// (TB) 1 reads A (B) MN-major, its rows the reduction dim, 0 K-major, its
// columns the reduction dim; scale_d 0 overwrites D instead (the first
// step of a product, so D needs no zeros written before it)
#define HOPPER_WGMMA_SS(TY)                                                 \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB))

template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_SS("f16");
  else
    HOPPER_WGMMA_SS("bf16");
}

// the same with both operands K-major
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d = 1) {
  wgmma_ss_t<0, 0, T>(d, da, db, scale_d);
}

// the product D = A . B over KS reduction steps of 16, both operands
// K-major tiles in shared memory
template <int KS, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[32], const void* a,
                                           const void* b) {
  wgmma_ss_first<T>(d, desc(a, k_major_step(0)), desc(b, k_major_step(0)));
#pragma unroll
  for (int kk = 1; kk < KS; ++kk)
    wgmma_ss<T>(d, desc(a, k_major_step(kk)), desc(b, k_major_step(kk)));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A from registers (the
// accumulator layout, two 16-bit values a register), B from shared memory,
// MN-major; scale_d 0 overwrites D (the first step of a product, so D
// needs no zeros written before it)
#define HOPPER_WGMMA_RS(TY)                                                 \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                            \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
        "+f"(d[30]), "+f"(d[31])                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_RS("f16");
  else
    HOPPER_WGMMA_RS("bf16");
}

// The accumulator layout of a 64 x 64 wgmma tile: thread t of the
// warpgroup holds 32 values, element i at row frag_row(i) and column
// frag_col(i). Masks, biases, per-row values and stores all go through
// these two. With several warpgroups in a block, frag_row counts on
// across them: warpgroup w's rows are 64w .. 64w + 63.
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// The A operand of reduction step kk (16 columns) from a 64 x 64 tile of
// values in the accumulator layout, rounded to T: the accumulator's
// columns 16kk .. 16kk + 15 are exactly the A fragment's.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void to_a(const float (&x)[32], int kk,
                                     uint32_t (&a)[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    a[m] = Half16<T>::pack(x[8 * kk + 2 * m], x[8 * kk + 2 * m + 1]);
}

}  // namespace hopper
