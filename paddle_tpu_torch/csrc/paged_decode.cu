// Paged flash decode for Hopper (sm_90a): one query token per (slot, head)
// row against K/V read through a page table, with int8 pages dequantized in
// the kernel by per-(page, head) scales; one partial softmax (acc, m, l) per
// run of logical pages. The logsumexp combine stays in torch ops.
//
// Replaces: paddle_tpu/ops/attention.py `_paged_flash_decode_call` (the
// Pallas block-table decode kernel, called from `paged_flash_decode`), the
// decode step of the paged serving pool. Same math: q, K, V and p in float32
// after the dequant (K = int8 * scale), logits = (q * scale) . k, keys at or
// past the slot's written length set to -1e30, then the [S, L] f32 key bias
// in logical positions (indexed by logical page, no table lookup); a run of
// pages wholly past the written region gives the exact-zero partial (acc 0,
// m -1e30, l 0).
//
// Differences from the TPU kernel, by design: the TPU grid took one 16-key
// page per step, far too small a CUDA block; here a block owns (a run of
// pages_per_split logical pages, slot * head) and loops over the pages, so a
// partial covers 128 keys as in flash_decode.cu. The table is read in the
// kernel (the TPU kernel took it by scalar prefetch); an unmapped (-1) or
// out-of-range entry reads the trash page, never through the -1.
//
// What bounds it, and the design: see split_attn.cuh (device-memory
// bandwidth; a warp per key, four keys in flight, an online softmax in
// registers). Every page row (psz x d elements) is contiguous, so each key's
// load stays coalesced after the indirection.

#include "split_attn.cuh"

// C entry point, bound with ctypes. qdtype: 0 = float32, 1 = bfloat16;
// kvdtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale / v_scale then
// required). q [S, H, T, d]; pages [n_rows, H, psz, d], each with unit
// stride on d; `strides` holds (q slot, q head, q row, k page, k head, k
// row, v page, v head, v row) in elements. scales [n_rows, H, 1, 1]
// float32; table [S, mp] int32 (entries outside [0, n_rows) read the trash
// row n_rows - 1); lengths [S] int32 written counts (after the T-token write
// for a verify); bias [S, mp * psz] float32 or null. Outputs: acc
// [S * H, n_splits, T, d], m and l [S * H, n_splits, T], float32,
// n_splits = ceil(mp / pages_per_split). Returns the launch's cudaError_t.
extern "C" int pt_paged_decode(int device, int qdtype, int kvdtype, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* table, const void* lengths, const void* bias, void* acc,
    void* m, void* l, int S, int H, int T, int mp, int psz, int n_rows,
    int d, int pages_per_split, const long long* strides, float scale,
    void* stream) {
  if (T != 1) return (int)cudaErrorInvalidValue;
  split_attn::PagedArgs a{qdtype, kvdtype, q, k_pages, v_pages,
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         static_cast<const int*>(table), lengths, bias, acc,
                         m, l, S, H, T, mp, psz, n_rows, d, pages_per_split,
                         strides, scale, static_cast<cudaStream_t>(stream)};
  return split_attn::paged_run<1>(device, a);
}
