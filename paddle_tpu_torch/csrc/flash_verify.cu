// Flash verify for Hopper (sm_90a): T query tokens per (batch, head) row,
// just written into a preallocated [B, H, L, d] KV cache at the row's own
// offset, against that cache, causal within the block; the key splits are
// merged in the kernel, which writes the [B, H, T, d] output in q's type.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_verify_call` (the Pallas
// split-K verify kernel, called from `flash_verify`), the speculative-
// decoding verify step of the dense slot pool. Same math: logits =
// round(q * scale) . k (the scaled query rounded to q's type), key j hidden
// from row t past position n_valid - T + t and keys at or past n_valid never
// read, then the [B, L] f32 key bias (per batch row; the TPU kernel took it
// repeated over heads); the softmax over the visible keys, p rounded to the
// operand type for p . v while l sums the unrounded p. A row with no
// visible key gives 0, as the JAX combine's clamp does. After a rejected
// draft the cache past n_valid holds the rejected block's keys: they are
// never read.
//
// Differences from the TPU kernel, by design: the TPU grid emitted one
// partial (acc, m, l) per 128-key split and combined them in XLA; here the
// splits (the dense decode's plan, `amerge::dense_plan`: whole key tiles
// over a thread-block cluster) merge in the kernel, one launch a call. In
// bf16, p is rounded at its group's running max rather than at a 128-key
// split's max, so the bf16 output differs from the split-and-combine within
// bf16 rounding; float32 is the same function in another order of
// summation. Any L (the TPU gate asked for L >= 256 and L % 128 == 0; the
// speculative pool's length is max_len + spec_k) and any T, in tiles of R
// query rows.
//
// What bounds it on an H100: device-memory bandwidth (each visible K and V
// row read once per tile of query rows, 4 R flops a key element). Design:
// the shared kernel body of attn_merge.cuh at R query rows over dense keys
// (`amerge::DenseKeys`), as flash_decode.cu at one row: whole key tiles
// through a cp.async ring, 16 keys in flight a block, R online softmaxes a
// group, the key splits merged over a cluster. The R 4 instance at d 64 is
// held to 128 registers (4 blocks an SM: the plan's clusters in one wave).

#include "attn_merge.cuh"

namespace {

using amerge::Args;
using amerge::DenseKeys;

// The second bound is the blocks an SM the compiler must fit (its register
// budget): 4 for the speculative step's instance (R 4 at d 64), so the
// plan's 64 rows x 7 splits run in one wave; left alone, ptxas gave the
// float32 instance 156 registers, 3 blocks an SM and 47 clusters of 7 at
// once (two waves).
template <typename T, int D, int R>
__global__ void __launch_bounds__(amerge::THREADS,
                                  (D == 64 && R == 4) ? 4 : 1)
flash_verify_kernel(const Args a) {
  amerge::attend<T, T, D, R, true, DenseKeys<T>>(a);
}

template <typename T, int D, int R>
int launch(const Args& a, int rows, int C, cudaStream_t s) {
  return amerge::launch(flash_verify_kernel<T, D, R>, a,
                        amerge::smem_bytes<T, D, R, DenseKeys<T>>(a), rows,
                        (a.T + R - 1) / R, C, s);
}

// Query rows a block (the paged split route's rule): 1 for T 1, 4 for
// T <= 4; above, 8 at d <= 64 and tiles of 4 at d 128 (a lane would hold
// 8 x 16 q and accumulator values).
template <typename T>
int by_rows(const Args& a, int rows, int C, cudaStream_t s) {
  if (a.T == 1)
    return a.d <= 64 ? launch<T, 64, 1>(a, rows, C, s)
                     : launch<T, 128, 1>(a, rows, C, s);
  if (a.d > 64) return launch<T, 128, 4>(a, rows, C, s);
  return a.T <= 4 ? launch<T, 64, 4>(a, rows, C, s)
                  : launch<T, 64, 8>(a, rows, C, s);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, T, d], k/v [B, H, L, d], each with unit stride on d; `strides`
// holds (q batch, q head, q row, k batch, k head, k row, v batch, v head,
// v row) in elements. lengths: [B] int32 written counts after the T-token
// write; bias: [B, L] float32 or null. out [B, H, T, d] contiguous, q's
// type. The key splits follow the dense decode's plan
// (`amerge::dense_plan`, `pt_flash_decode_plan`), split_k its override.
// Returns the launch's cudaError_t.
extern "C" int pt_flash_verify(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* lengths,
                               void* out, int B, int H, int T, int L, int d,
                               const long long* strides, float scale,
                               int split_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || L < 1 || H < 1 || B < 0 || T < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidValue;
  int C = 0, split = 0;
  amerge::dense_plan(amerge::sm_count(device), B * H, L, &C, &split,
                     split_k);
  const amerge::Args a =
      amerge::dense_args(q, k, v, lengths, bias, out, H, T, L, d,
                         dtype == 0 ? 4 : 2, split, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? by_rows<float>(a, B * H, C, s)
                    : by_rows<__nv_bfloat16>(a, B * H, C, s);
}
