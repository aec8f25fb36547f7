// Flash decode for Hopper (sm_90a): one query token per (batch, head) row
// against a preallocated [B, H, L, d] KV cache; the key splits are merged
// in the kernel, which writes the [B, H, 1, d] output in q's type.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_decode_call` (the Pallas
// split-K decode kernel, called from `flash_decode`), the decode step of the
// dense slot pool. Same math: logits = round(q * scale) . k (the scaled
// query rounded to q's type), keys at or past the row's written length not
// read, then the optional [B, L] f32 key bias; the softmax over the visible
// keys, p rounded to the operand type for p . v while l sums the unrounded
// p. A row with no written key gives 0, as the JAX combine's clamp does.
// The per-row length is read inside the kernel (the TPU kernel took it by
// scalar prefetch).
//
// Differences from the TPU kernel, by design: the TPU grid emitted one
// partial (acc, m, l) per 128-key split and combined them in XLA; here the
// splits (`pt_flash_decode_plan`: whole key tiles over a thread-block
// cluster) merge in the kernel, one launch a call. In bf16, p is rounded at
// its group's running max rather than at a 128-key split's max, so the bf16
// output differs from the split-and-combine within bf16 rounding; float32
// is the same function in another order of summation. Any L.
//
// What bounds it on an H100: device-memory bandwidth (each visible K and V
// element read once, 4 flops an element pair). Design: the shared kernel
// body of attn_merge.cuh at one query row over dense keys
// (`amerge::DenseKeys`): whole key tiles through a cp.async ring, 16 keys in
// flight a block, the key splits merged over a cluster.

#include "attn_merge.cuh"

namespace {

using amerge::Args;
using amerge::DenseKeys;

template <typename T, int D>
__global__ void __launch_bounds__(amerge::THREADS)
flash_decode_kernel(const Args a) {
  amerge::attend<T, T, D, 1, true, DenseKeys<T>>(a);
}

template <typename T>
int by_width(const Args& a, int rows, int C, cudaStream_t s) {
  if (a.d <= 64)
    return amerge::launch(flash_decode_kernel<T, 64>, a,
                          amerge::smem_bytes<T, 64, 1, DenseKeys<T>>(a),
                          rows, 1, C, s);
  return amerge::launch(flash_decode_kernel<T, 128>, a,
                        amerge::smem_bytes<T, 128, 1, DenseKeys<T>>(a), rows,
                        1, C, s);
}

}  // namespace

// The kernel's plan for B * H rows over L cached keys on `device`: out[0]
// the blocks a cluster (key splits, merged in the kernel), out[1] the keys
// a split, a whole number of 32-key steps (whole key tiles at any width).
// It reads B, H and L only, never the lengths on the device. A legal
// split_k (the tuning table's; 0 = the rule) sets the blocks a cluster.
// `ops.attention.flash_decode_plan` writes the same rule out for the CPU.
extern "C" int pt_flash_decode_plan(int device, int B, int H, int L,
                                    int split_k, int* out) {
  if (B < 0 || H < 1 || L < 1) return (int)cudaErrorInvalidValue;
  amerge::dense_plan(amerge::sm_count(device), B * H, L, out, out + 1,
                     split_k);
  return 0;
}

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, 1, d], k/v [B, H, L, d], each with unit stride on d; `strides`
// holds (q batch, q head, q row, k batch, k head, k row, v batch, v head,
// v row) in elements. lengths: [B] int32 written counts; bias: [B, L]
// float32 or null. out [B, H, 1, d] contiguous, q's type. split_k: the
// plan's override (`pt_flash_decode_plan`). Returns the launch's
// cudaError_t.
extern "C" int pt_flash_decode(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* lengths,
                               void* out, int B, int H, int L, int d,
                               const long long* strides, float scale,
                               int split_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || L < 1 || H < 1 || B < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  int plan[2];
  pt_flash_decode_plan(device, B, H, L, split_k, plan);
  const amerge::Args a =
      amerge::dense_args(q, k, v, lengths, bias, out, H, 1, L, d,
                         dtype == 0 ? 4 : 2, plan[1], strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? by_width<float>(a, B * H, plan[0], s)
                    : by_width<__nv_bfloat16>(a, B * H, plan[0], s);
}
