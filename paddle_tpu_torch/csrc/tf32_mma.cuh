// Float32 products on Hopper's tensor cores with an operand split: the
// pieces of the float32 flash forward (flash_fwd.cu, `flash_fwd_tf32`).
//
// A float32 value x splits into a TF32 "big" part and a TF32 "small"
// remainder, big = rna(x), small = rna(x - big), with rna the rounding of
// `cvt.rna.tf32.f32` (to nearest, ties away from zero, on the 10 stored
// mantissa bits; x - big is exact in float32). The product a.b is taken as
// three TF32 products, small_a.big_b + big_a.small_b + big_a.big_b
// (3xTF32), each exact in the float32 accumulator (11 x 11 significant
// bits): only small_a.small_b and the rounding of the small parts are
// dropped, about 2^-21 of each product, against 2^-11 for one TF32 pass.
// `paddle_tpu_torch.testing.tf32_round` / `split_matmul` are the same
// arithmetic in plain PyTorch.
//
// The product is `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`: a
// warp multiplies a 16 x 8 A (row) by an 8 x 8 B (col) into a 16 x 8
// float32 tile. With g = lane / 4 and t = lane % 4 (PTX ISA, "matrix
// fragments for mma.m16n8k8"):
//   A: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B: b0 (k t, n g), b1 (k t + 4, n g)
//   C: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product whose A comes from an earlier product's C (P.V after Q.K^T)
// reads C's columns 2t, 2t + 1 as A's k indices t, t + 4: the reduction
// index is permuted within each 8-wide step, and B's rows are read in the
// same permuted order (k t -> row 2t, k t + 4 -> row 2t + 1), so the sum
// is unchanged and no value moves between lanes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (low 13 bits zero),
// on the bit pattern: half a TF32 step added to the magnitude (a carry
// moves the exponent), then the low bits cleared. Two integer operations
// at the full rate of the integer pipe, where cvt is a conversion.
__device__ __forceinline__ uint32_t rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = rna(x);
  small = rna(x - __uint_as_float(big));
}

// d (16 x 8) += a (16 x 8) . b (8 x 8), TF32 operands, float32 sum
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tf32
