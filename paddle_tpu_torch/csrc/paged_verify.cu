// Paged flash verify for Hopper (sm_90a): T query tokens per (slot, head)
// row, just written through the page table at the slot's own offset,
// against K/V read through the table, causal within the block, int8 pages
// dequantized in the kernel; one partial softmax (acc, m, l) per run of
// logical pages and query row. The logsumexp combine stays in torch ops.
//
// Replaces: paddle_tpu/ops/attention.py `_paged_flash_verify_call` (the
// Pallas block-table verify kernel, called from `paged_flash_verify`): the
// speculative verify step of the paged pool, and the tail prefill of a radix
// partial prefix hit (`PagedLayout.pattach`, T = the tail's bucket, up to
// hundreds of tokens). Same math as paged_decode.cu with the verify mask:
// key j hidden from row i past position n_valid - T + i (-1e30). q, K, V and
// p stay float32 after the dequant (the dense verify kernel rounds them to
// the operand type instead; both orders are kept, as on the TPU).
//
// Differences from the TPU kernel, by design: a block owns a run of
// pages_per_split logical pages (not one page) and a tile of R query rows
// (not the whole (T, d) block, which at T = 512 would be 128 KB of f32).
//
// What bounds it, and the design: see split_attn.cuh.

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
extern "C" int pt_paged_verify(int device, int qdtype, int kvdtype, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* table, const void* lengths, const void* bias, void* acc,
    void* m, void* l, int S, int H, int T, int mp, int psz, int n_rows,
    int d, int pages_per_split, const long long* strides, float scale,
    void* stream) {
  split_attn::PagedArgs a{qdtype, kvdtype, q, k_pages, v_pages,
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         static_cast<const int*>(table), lengths, bias, acc,
                         m, l, S, H, T, mp, psz, n_rows, d, pages_per_split,
                         strides, scale, static_cast<cudaStream_t>(stream)};
  return T <= 4 ? split_attn::paged_run<4>(device, a)
                : split_attn::paged_run<8>(device, a);
}
