// Split-K flash verify for Hopper (sm_90a): T query tokens per (batch, head)
// row, just written into a preallocated [B, H, L, d] KV cache at the row's
// own offset, against that cache, causal within the block; one partial
// softmax (acc, m, l) per key split and query row. The logsumexp combine of
// the partials stays in torch ops.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_verify_call` (the Pallas
// split-K verify kernel, called from `flash_verify`), the speculative-
// decoding verify step of the dense slot pool. Same math per split: the
// query scaled and rounded to its dtype, logits = q . k, key j hidden from
// row i past position n_valid - T + i (-1e30), then the [B, L] f32 key bias
// (per batch row; the TPU kernel took it repeated over heads); p = exp(x -
// m), rounded to the operand type for the p . v product, l = sum(p). A split
// wholly past the written region gives the exact-zero partial (acc 0, m
// -1e30, l 0).
//
// Differences from the TPU kernel, by design: any L (the TPU gate asked for
// L >= 256 and L % 128 == 0; the speculative pool's length is max_len +
// spec_k), a fixed 128-key split, and the query block tiled by R rows so a
// long block never holds a (T, d) tile.
//
// What bounds it, and the design: see split_attn.cuh (device-memory
// bandwidth; a warp per key, shuffled dot products, R online softmaxes in
// registers).

#include "split_attn.cuh"

namespace {

using split_attn::DenseKeys;
using split_attn::launch;

template <typename T, int D, int R>
int run_r(const void* q, const void* k, const void* v, const void* bias,
          const void* lengths, void* acc, void* m, void* l, int B, int H,
          int Tq, int L, int d, int split, const long long* st, float scale,
          cudaStream_t stream) {
  DenseKeys<T> keys;
  keys.k = static_cast<const T*>(k);
  keys.v = static_cast<const T*>(v);
  keys.ksb = st[3];
  keys.ksh = st[4];
  keys.kss = st[5];
  keys.vsb = st[6];
  keys.vsh = st[7];
  keys.vss = st[8];
  keys.kb = nullptr;
  keys.vb = nullptr;
  return launch<T, T, D, R, true>(q, keys, bias, lengths, acc, m, l, B, H,
                                  Tq, L, d, split, st[0], st[1], st[2], scale,
                                  stream);
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* bias,
        const void* lengths, void* acc, void* m, void* l, int B, int H,
        int Tq, int L, int d, int split, const long long* st, float scale,
        cudaStream_t stream) {
  if (Tq == 1)
    return run_r<T, D, 1>(q, k, v, bias, lengths, acc, m, l, B, H, Tq, L, d,
                          split, st, scale, stream);
  if (Tq <= 4)
    return run_r<T, D, 4>(q, k, v, bias, lengths, acc, m, l, B, H, Tq, L, d,
                          split, st, scale, stream);
  return run_r<T, D, 8>(q, k, v, bias, lengths, acc, m, l, B, H, Tq, L, d,
                        split, st, scale, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// q [B, H, T, d], k/v [B, H, L, d], each with unit stride on d; `strides`
// holds (q batch, q head, q row, k batch, k head, k row, v batch, v head,
// v row) in elements. lengths: [B] int32 written counts after the T-token
// write; bias: [B, L] float32 or null. Outputs: acc [B * H, n_splits, T, d],
// m and l [B * H, n_splits, T], float32, n_splits = ceil(L / split).
// Returns the launch's cudaError_t.
extern "C" int pt_flash_verify(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* lengths,
                               void* acc, void* m, void* l, int B, int H,
                               int T, int L, int d, int split,
                               const long long* strides, float scale,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || split < 1 || T < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return dtype == 0
        ? run<float, 64>(q, k, v, bias, lengths, acc, m, l, B, H, T, L, d,
                         split, strides, scale, s)
        : run<__nv_bfloat16, 64>(q, k, v, bias, lengths, acc, m, l, B, H, T,
                                 L, d, split, strides, scale, s);
  return dtype == 0
      ? run<float, 128>(q, k, v, bias, lengths, acc, m, l, B, H, T, L, d,
                        split, strides, scale, s)
      : run<__nv_bfloat16, 128>(q, k, v, bias, lengths, acc, m, l, B, H, T,
                                L, d, split, strides, scale, s);
}
