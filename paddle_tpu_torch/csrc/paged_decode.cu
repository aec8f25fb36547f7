// Paged flash decode for Hopper (sm_90a): one query token per (slot, head)
// row against K/V read through a page table, with int8 pages dequantized in
// the kernel by per-(page, head) scales; the key splits are merged in the
// kernel, which writes the [S, H, 1, d] output in q's type.
//
// Replaces: paddle_tpu/ops/attention.py `_paged_flash_decode_call` (the
// Pallas block-table decode kernel, called from `paged_flash_decode`), the
// decode step of the paged serving pool. Same math: q, K, V and p in float32
// after the dequant (K = int8 * scale), logits = (q * scale) . k, keys at or
// past the slot's written length not read, then the [S, L] f32 key bias in
// logical positions (indexed by logical page, no table lookup); the softmax
// over the visible keys, p . v / sum(p). A slot with no written key gives 0,
// as the JAX combine's clamp does.
//
// Differences from the TPU kernel, by design: the TPU grid took one 16-key
// page per step and combined the per-page partials in XLA; here a thread-
// block cluster of C blocks owns a (slot, head) row, each block a run of
// whole pages (`plan`), and the blocks' partials are merged in the kernel.
// The table is read in the kernel (the TPU kernel took it by scalar
// prefetch); an unmapped (-1) or out-of-range entry reads the trash page,
// never through the -1.
//
// What bounds it on an H100: device-memory bandwidth (at S8 h8 and ~1k keys
// a row, 16 MB of float32 K/V against 4 flops a byte pair). Design: the
// shared kernel body of attn_merge.cuh at one query row over paged keys
// (`amerge::PagedKeys`): a page-head row of K or V (psz x d elements) is
// contiguous, a block resolves its pages' rows and scales once a page,
// whole key tiles go through a cp.async ring, 16 keys in flight a block,
// the key splits merged over a cluster. The dense decode (flash_decode.cu)
// and the paged verify's split route (paged_verify.cu) instantiate the same
// body.

#include "attn_merge.cuh"

namespace pdec {

using amerge::Args;
using amerge::PagedKeys;

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(amerge::THREADS)
paged_decode_kernel(const Args a) {
  amerge::attend<TQ, TKV, D, 1, false, PagedKeys<TKV>>(a);
}

template <typename TQ, typename TKV>
int by_width(const Args& a, int rows, int C, cudaStream_t s) {
  if (a.d <= 64)
    return amerge::launch(paged_decode_kernel<TQ, TKV, 64>, a,
                          amerge::smem_bytes<TKV, 64, 1, PagedKeys<TKV>>(a),
                          rows, 1, C, s);
  return amerge::launch(paged_decode_kernel<TQ, TKV, 128>, a,
                        amerge::smem_bytes<TKV, 128, 1, PagedKeys<TKV>>(a),
                        rows, 1, C, s);
}

template <typename TQ>
int by_kv(int kvdtype, const Args& a, int rows, int C, cudaStream_t s) {
  switch (kvdtype) {
    case 0: return by_width<TQ, float>(a, rows, C, s);
    case 1: return by_width<TQ, __nv_bfloat16>(a, rows, C, s);
    default: return by_width<TQ, signed char>(a, rows, C, s);
  }
}

}  // namespace pdec

// The kernel's plan for S * H rows over mp pages on `device`: out[0] the
// blocks a cluster (key splits, merged in the kernel), out[1] the pages a
// split. A legal split_k (the tuning table's; 0 = the rule) sets the
// blocks a cluster. `ops.attention.paged_decode_plan` writes the same rule
// out for the CPU.
extern "C" int pt_paged_decode_plan(int device, int S, int H, int mp,
                                    int split_k, int* out) {
  if (S < 0 || H < 1 || mp < 1) return (int)cudaErrorInvalidValue;
  amerge::plan(amerge::sm_count(device), S * H, mp, out, out + 1, split_k);
  return 0;
}

// C entry point, bound with ctypes. qdtype: 0 = float32, 1 = bfloat16;
// kvdtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale / v_scale then
// required). q [S, H, 1, d]; pages [n_rows, H, psz, d], each with unit
// stride on d; `strides` holds (q slot, q head, q row, k page, k head, k
// row, v page, v head, v row) in elements. scales [n_rows, H, 1, 1]
// float32; table [S, mp] int32 (entries outside [0, n_rows) read the trash
// row n_rows - 1); lengths [S] int32 written counts; bias [S, mp * psz]
// float32 or null. out [S, H, 1, d] contiguous, q's type. split_k: the
// plan's override (`pt_paged_decode_plan`). Returns the launch's
// cudaError_t.
extern "C" int pt_paged_decode(int device, int qdtype, int kvdtype,
                               const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* table,
                               const void* lengths, const void* bias,
                               void* out, int S, int H, int mp, int psz,
                               int n_rows, int d, const long long* strides,
                               float scale, int split_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || psz < 1 || mp < 1 || n_rows < 1 || H < 1 ||
      S < 0 || (qdtype != 0 && qdtype != 1) || kvdtype < 0 || kvdtype > 2 ||
      (kvdtype == 2 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  if ((long long)S * H > 65535) return (int)cudaErrorInvalidValue;
  int plan[2];
  pt_paged_decode_plan(device, S, H, mp, split_k, plan);
  const int esz = kvdtype == 0 ? 4 : kvdtype == 1 ? 2 : 1;
  const amerge::Args a = amerge::paged_args(
      q, k_pages, v_pages, k_scale, v_scale, table, lengths, bias, out, H, 1,
      mp, psz, n_rows, d, esz, plan[1], strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return qdtype == 0 ? pdec::by_kv<float>(kvdtype, a, S * H, plan[0], s)
                     : pdec::by_kv<__nv_bfloat16>(kvdtype, a, S * H,
                                                  plan[0], s);
}
