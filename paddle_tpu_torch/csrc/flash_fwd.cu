// Flash-attention forward for Hopper (sm_90a): out = softmax(q k^T * scale
// + bias [+ causal mask] [+ segment mask]) v, plus the per-row logsumexp.
//
// Replaces: paddle_tpu/ops/attention.py `_flash_fwd_kernels` (the Pallas
// online-softmax forward, called from `flash_attention_fwd`), both of its
// variants (without and with segment ids, `has_segs`). Same math: the
// scale folds into the query once, an optional [b, sk] f32 key bias is
// added to the logits, pairs of different segments and causal keys are
// set to -1e30, the running max starts at -1e30, p is rounded to the
// operand type before the p.v product while the normaliser sums the
// unrounded p, and the epilogue divides by max(l, 1e-30) and writes
// lse = m + log(max(l, 1e-30)).
//
// Segment ids (packed rows, flash_common.cuh): a query tile visits only
// the key tiles of [lower_bound(kseg, min qseg), upper_bound(kseg, max
// qseg)), intersected with the causal range. A row whose first visited
// keys all lie in other segments sums exp(0) terms under m = -1e30; its
// first same-segment key wipes them (alpha = exp(-1e30 - m) = 0), as in
// the TPU kernel. The dropout bits stay addressed by global (row, col), so
// skipping tiles moves none.
//
// Differences from the TPU kernel, by design:
//  * Causal masking is END-aligned (key j visible to row i while
//    j <= i + sk - sq), which is the reference `sdpa_reference` semantics
//    for every shape; for sq == sk it is the TPU kernel's start alignment.
//  * Any sq / sk: ragged query and key tails are masked here (out-of-range
//    keys get -inf, so they never enter the normaliser), there is no
//    block-divisibility gate and no minimum sequence length.
//  * Key tiles entirely past the block's last visible key are skipped. A
//    row whose every visible key is masked (no real key at all) is
//    degenerate and its output is unspecified, as on the TPU.
//
// What bounds it on an H100: 4 * b*h*sq*sk*d operations (the logits and
// the p.v product) against reading q once and k, v and the bias once per
// query tile.
//
// bfloat16 (the training path) and float16 (the same body, instantiated
// over __half for training under amp.auto_cast(dtype="float16"): f16
// wgmma, p rounded to f16 where the bf16 instance rounds it to bf16; the
// softmax state and every accumulator stay float32, so f16's narrow range
// meets only the rounded p in [0, 1] and the output): both products run on the tensor cores
// (bf16 wgmma, 989 TFLOP/s), so the exp, the masks and the dropout hash
// on the CUDA cores are the other half of the work. One warpgroup (128
// threads) per (query tile of 64 rows, b*h). The tile's q stays in
// swizzled shared memory, its row max, normaliser, ids and dropout row
// keys in registers; k, v, the key bias, ids and dropout column keys
// stream in 64-key tiles through a ring of three buffers, cp.async filling
// the next tile's under this tile's work. Per key tile: S = Q.K^T by wgmma
// from shared memory into fp32 registers (the accumulator layout,
// flash_mma.cuh); bias, masks, the online softmax (row max and row sum
// over the four threads of a row) and the dropout in those registers; p
// rounded to bf16 straight into the A registers of O += P.V (B = the v
// tile read MN-major). The rescale of O by exp(m_old - m_new) waits for
// the previous P.V, so the products of one tile do not overlap its
// softmax (other blocks on the SM fill the gap). When the scale is a power
// of two (d = 64 and 128), round(q * scale) = q * scale exactly, so the
// raw q tile feeds the product and the scale multiplies the fp32 logits;
// any other scale stages round(q * scale) in place once. Views whose rows
// do not all start on 16 bytes copy their tiles element by element
// (`pt_flash_fwd_vector_loads`, mirrored by the wrapper's counter).
//
// float32 (serving's prefill, encoder and cross-attention) runs both
// products on the tensor cores as 3xTF32 (tf32_mma.cuh): each operand
// splits into a TF32 big part and a TF32 remainder, and three mma.sync
// m16n8k8 TF32 products (small.big, big.small, big.big) drop only about
// 2^-21 of each product, within the float32 limit of the plain version
// (atol 2e-5), where one TF32 pass (2^-11) is not. TF32 wgmma reads both
// operands K-major from shared memory only, which P.V (v's rows are the
// reduction) would need transposed; mma.sync takes p's fragments from
// registers, with each 8-key step's keys permuted so that the logits'
// C fragment is P's A fragment (tf32_mma.cuh), and v's B fragments from
// rows padded to D + 4 floats (conflict-free). Bound on an H100: 4 b h sq
// sk d operations three times at 495 TFLOP/s (TF32), or the bytes at the
// decode step.
//  * Query-tiled (`flash_fwd_tf32_kernel`, sq > 16): four warps a (64
//    query rows, b*h), each warp 16 rows against all 64 keys of each key
//    tile; q * scale split from its shared tile at each reduction step,
//    k, v and the bias through a two-tile cp.async ring (16 bytes a
//    thread where the views allow, else 4), the next tile's copy under
//    this tile's products. The scale, masks, online
//    softmax and -1e30 conventions are those above, in the C fragments.
//  * Short-query (`flash_fwd_tf32_short_kernel`, sq <= 16: the decode
//    step's cross-attention, one query row over the 256-token memory): a
//    16-row query tile, the keys split across the block's four warps (16
//    keys of each tile each); the warps merge in warp order.
//  * Both split the key tiles of a (query tile, b*h) over a thread-block
//    cluster of up to 8 blocks until about two blocks an SM run (`plan`):
//    the ranks' partials merge through distributed shared memory in rank
//    order (`cluster_merge`), the same bits on every run, with no partials
//    in device memory and no combine pass.
// Attention dropout and segment ids (training only, no serving path) keep
// the float32 SIMT kernel (`flash_fwd_kernel`): float32 FMAs on the CUDA
// cores, 4 rows x 8 keys a thread, p through shared memory. `pt_flash_fwd_route` is the
// rule, and the wrapper counts launches by it.

#include <math.h>

#include "flash_mma.cuh"
#include "flash_common.cuh"
#include "tf32_mma.cuh"

#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // q, k, v tiles [64][D + 1], p tile [64][BK + 1], bias tile [BK]; as
  // int: the key tile's segment ids [BK] and the segment range [2]
  return 3 * 64 * (D + 1) + BQ * (BK + 1) + BK + BK + 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 T* __restrict__ out, float* __restrict__ lse, int H,
                 int sq, int sk, int d, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, float scale,
                 int causal, Dropout dr) {
  constexpr int LD = D + 1;       // padded row stride of the q/k/v tiles
  constexpr int LP = BK + 1;      // padded row stride of the p tile
  constexpr int OPT = D / 8;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* bs = ps + BQ * LP;
  int* kids = reinterpret_cast<int*>(bs + BK);  // key tile's segment ids
  int* seg_sh = kids + BK;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;        // row group: rows 4*rg .. 4*rg + 3
  const int cg = tid & 7;         // column group: columns cg + 8*j
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;        // end-aligned causal offset

  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  const float* bp = bias ? bias + (long long)b * sk : nullptr;
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < sq && c < d)
      x = round_to<T>(to_f(qp[(long long)(q0 + r) * qss + c]) * scale);
    qs[r * LD + c] = x;
  }

  int kbeg = 0, kend = sk;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    kend = max(0, min(sk, last_row + off + 1));
  }
  int qid[RPT];
  if (qsp) {
    const int2 w = seg_window(qsp, q0, min(q0 + BQ, sq), ksp, sk, seg_sh);
    kbeg = w.x / BK * BK;
    kend = min(kend, w.y);
  }

  const bool drop = dr.block_q > 0;
  float m[RPT], l[RPT], acc[RPT][OPT];
  unsigned int row_key[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    qid[i] = (qsp && row < sq) ? qsp[row] : 0;
    row_key[i] = drop ? drop_row_key(dr, bh, row) : 0u;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = to_f(kp[(long long)(k0 + r) * kss + c]);
        vx = to_f(vp[(long long)(k0 + r) * vss + c]);
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    if (tid < BK) {
      bs[tid] = (bp && k0 + tid < sk) ? bp[k0 + tid] : 0.f;
      kids[tid] = (ksp && k0 + tid < sk) ? ksp[k0 + tid] : 0;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(rg * RPT + i) * LD + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(cg + 8 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + rg * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (ksp && qid[i] != kids[cg + 8 * j]) x = NEG;
        if (causal && col > row + off) x = NEG;
        if (col >= sk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float p = expf(s[i][j] - m_new);
        rs += p;
        if (drop)
          p = drop_keep(dr, row_key[i], k0 + cg + 8 * j) ? p * dr.inv_keep
                                                         : 0.f;
        ps[(rg * RPT + i) * LP + cg + 8 * j] = round_to<T>(p);
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                 // a row's p is written by its own warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(rg * RPT + i) * LP + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float vv = vs[j * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* op = out + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) op[col] = from_f<T>(acc[i][c] / ls);
    }
    if (cg == 0) lse[(long long)bh * sq + row] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* qseg, const void* kseg, void* out, void* lse, int B,
           int H, int sq, int sk, int d,
           const long long* st, float scale, int causal, Dropout dr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<T*>(out), static_cast<float*>(lse), H, sq, sk, d, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      dr);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- float32, tensor cores

namespace f32tc {

constexpr int LD_PAD = 4;       // row pad of the float32 tiles (words)
constexpr int NSF = 2;          // key-tile buffers (the cp.async ring)
constexpr int SHORT_ROWS = 16;  // query rows of the short-query route
constexpr int MAX_CLUSTER = 8;  // blocks a cluster (key splits), portable
constexpr int WARPS = THREADS / 32;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  int H, sq, sk, d;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  float scale;
  int causal, vec;
};

// Shared memory of one block: the q tile (qrows rows), NSF k and NSF v
// tiles of BK keys, NSF bias tiles. Rows are D + 4 floats, so the
// fragment reads of mma.sync (8 rows x 4 columns a warp, rows 4 banks
// apart) hit 32 banks.
template <int D>
struct Layout {
  static constexpr int LD = D + LD_PAD;
  static constexpr int TILE = BK * LD;
  static constexpr int bytes(int qrows) {
    return 4 * (qrows * LD + 2 * NSF * TILE + NSF * BK);
  }
};

// Rows [r0, r0 + ROWS) of a [n, d] float32 matrix (row stride ld) into a
// tile of D columns with row stride D + LD_PAD; rows >= n and columns >=
// d land as zeros. By cp.async: 16 bytes a thread when `vec` (every row of
// the views starts on 16 bytes and d % 4 == 0), else 4. Called by all
// threads; the copies join the caller's next commit group.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long ld, int r0, int n,
                                          int d, int vec) {
  constexpr int LD = D + LD_PAD;
  if (vec) {
    constexpr int CH = D / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = r0 + r < n && 4 * c < d;
      hopper::cp_async16(dst + r * LD + 4 * c,
                         ok ? src + (long long)(r0 + r) * ld + 4 * c : src,
                         ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = r0 + r < n && c < d;
      hopper::cp_async4(dst + r * LD + c,
                        ok ? src + (long long)(r0 + r) * ld + c : src,
                        ok ? 4 : 0);
    }
  }
}

// The A fragments (big, small) of reduction step kk of q * scale, rows
// qr0 .. qr0 + 15 of the q tile. The product is rounded to float32 before
// the split (no contraction into the subtraction), as the plain version
// rounds round(q * scale).
template <int D>
__device__ __forceinline__ void q_frag(const float* qt, int qr0, int kk,
                                       float scale, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  constexpr int LD = D + LD_PAD;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* r = qt + (qr0 + g) * LD + 8 * kk + t;
  tf32::split(__fmul_rn(r[0], scale), ab[0], as[0]);
  tf32::split(__fmul_rn(r[8 * LD], scale), ab[1], as[1]);
  tf32::split(__fmul_rn(r[4], scale), ab[2], as[2]);
  tf32::split(__fmul_rn(r[8 * LD + 4], scale), ab[3], as[3]);
}

// One warp's online softmax over 16 query rows: the running max and
// normaliser of rows g and g + 8 (the C fragment's), and out [D / 8
// column tiles of 8][the C fragment].
template <int D>
struct Rows {
  float m[2], l[2];
  float o[D / 8][4];
};

// One key tile for one warp: S = (q * scale) . K^T over NT column tiles
// of 8 keys from tile column kc0; the bias, causal keys set to -1e30 and
// keys at or past klim to -inf; the online softmax; O += P . V. Both
// products 3xTF32 on the tensor cores, each reduction step's fragments
// split first and its three passes (small.big, big.small, big.big) issued
// across all column tiles, so neighbouring mma.sync write different
// accumulators (one after another on one accumulator they wait out each
// other's latency).
template <int D, int NT>
__device__ __forceinline__ void tile_step(
    Rows<D>& st, const float* qt, int qr0, const float* kt, const float* vt,
    const float* bt, int kc0, int k0, const int (&rows)[2], int off,
    int klim, int causal, float scale) {
  constexpr int LD = D + LD_PAD;
  constexpr int CB = D / 8 < 8 ? D / 8 : 8;   // output column tiles a pass
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4], bb[NT][2], bs[NT][2];
    q_frag<D>(qt, qr0, kk, scale, ab, as);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* kr = kt + (kc0 + 8 * j + g) * LD + 8 * kk + t;
      tf32::split(kr[0], bb[j][0], bs[j][0]);
      tf32::split(kr[4], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) tf32::mma(s[j], as, bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) tf32::mma(s[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) tf32::mma(s[j], ab, bb[j][0], bb[j][1]);
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = e >> 1;
      const int lc = kc0 + 8 * j + 2 * t + (e & 1);
      const int col = k0 + lc;
      float lg = s[j][e] + bt[lc];
      if (causal && col > rows[x] + off) lg = NEG;
      if (col >= klim) lg = -INFINITY;
      s[j][e] = lg;
      mx[x] = fmaxf(mx[x], lg);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    const float m_new = fmaxf(st.m[x], mx[x]);
    alpha[x] = expf(st.m[x] - m_new);
    st.m[x] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - st.m[e >> 1]);
      rs[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
    rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
    st.l[x] = st.l[x] * alpha[x] + rs[x];
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[c][e] *= alpha[e >> 1];

  // P . V: p's C fragment read as A with the keys of each 8-wide step
  // permuted (A's k t = key 2t, k t + 4 = key 2t + 1), v's rows read in
  // the same order (tf32_mma.cuh)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t pb[4], ps[4];
    tf32::split(s[j][0], pb[0], ps[0]);
    tf32::split(s[j][2], pb[1], ps[1]);
    tf32::split(s[j][1], pb[2], ps[2]);
    tf32::split(s[j][3], pb[3], ps[3]);
    const float* vr = vt + (kc0 + 8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int c0 = 0; c0 < D / 8; c0 += CB) {
      uint32_t vb[CB][2], vs[CB][2];
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        tf32::split(vr[8 * (c0 + c)], vb[c][0], vs[c][0]);
        tf32::split(vr[LD + 8 * (c0 + c)], vb[c][1], vs[c][1]);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tf32::mma(st.o[c0 + c], ps, vb[c][0], vb[c][1]);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tf32::mma(st.o[c0 + c], pb, vs[c][0], vs[c][1]);
#pragma unroll
      for (int c = 0; c < CB; ++c)
        tf32::mma(st.o[c0 + c], pb, vb[c][0], vb[c][1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void rows_init(Rows<D>& st) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    st.m[x] = NEG;
    st.l[x] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[c][e] = 0.f;
}

// The bias tile of keys [k0, k0 + BK) below `klim` (zeros without a bias
// or past it): 4-byte cp.async, the caller's next commit group.
__device__ __forceinline__ void copy_bias(float* dst, const float* bp,
                                          int k0, int klim) {
  const int tid = threadIdx.x;
  if (tid >= BK) return;
  if (bp == nullptr) {
    dst[tid] = 0.f;
    return;
  }
  const bool ok = k0 + tid < klim;
  hopper::cp_async4(dst + tid, ok ? bp + k0 + tid : bp, ok ? 4 : 0);
}

// The key tiles of a cluster's ranks, and the merge of their partials.
// A (query tile, b*h) is one thread-block cluster of C blocks (`plan`);
// rank r runs key tiles r, r + C, r + 2C, ... (interleaved, so a causal
// row's visible tiles spread evenly). With C > 1 each rank leaves its
// rows' partial (max, normaliser, unnormalised out) in its shared memory
// and, after a cluster barrier, rank r finishes a slice of the rows,
// reading every rank's partial through distributed shared memory in rank
// order: the same bits on every run, no partials in device memory and no
// second launch.
template <int D, int ROWS>
__device__ __forceinline__ void cluster_merge(
    cg::cluster_group& cl, float* po, float* pm, float* pl, int valid,
    int d, float* op, float* lp) {
  __shared__ float c_w[ROWS][MAX_CLUSTER];   // exp(m_k - m*)
  __shared__ float c_ms[ROWS], c_den[ROWS];
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int per = (valid + C - 1) / C;
  const int r0 = min(valid, rank * per), nr = min(valid, r0 + per) - r0;
  const int tid = threadIdx.x;
  if (tid < nr) {
    const int r = r0 + tid;
    float ms = -INFINITY;
    for (int k = 0; k < C; ++k) ms = fmaxf(ms, cl.map_shared_rank(pm, k)[r]);
    float den = 0.f;
    for (int k = 0; k < C; ++k) {
      const float w = expf(cl.map_shared_rank(pm, k)[r] - ms);
      c_w[tid][k] = w;
      den += cl.map_shared_rank(pl, k)[r] * w;
    }
    c_ms[tid] = ms;
    c_den[tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < nr * d; i += THREADS) {
    const int rr = i / d, c = i - rr * d;
    float num = 0.f;
    for (int k = 0; k < C; ++k)
      num += cl.map_shared_rank(po, k)[(r0 + rr) * D + c] * c_w[rr][k];
    op[(long long)(r0 + rr) * d + c] = num / fmaxf(c_den[rr], 1e-30f);
  }
  if (tid < nr) lp[r0 + tid] = c_ms[tid] + logf(fmaxf(c_den[tid], 1e-30f));
}

// The query-tiled route (sq > 16): a block of four warps for 64 query
// rows of one (batch, head), each warp 16 rows against every key of its
// rank's 64-key tiles; k, v and the bias stream through a two-tile
// cp.async ring, the next tile's copy under this tile's products.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32_kernel(const Args a) {
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem_tc[];
  float* qt = smem_tc;
  float* kt = qt + BQ * L::LD;
  float* vt = kt + NSF * L::TILE;
  float* bt = vt + NSF * L::TILE;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * BQ, qr0 = 16 * warp;
  const int off = a.sk - a.sq;
  const float* qp = a.q + b * a.qsb + h * a.qsh;
  const float* kp = a.k + b * a.ksb + h * a.ksh;
  const float* vp = a.v + b * a.vsb + h * a.vsh;
  const float* bp = a.bias ? a.bias + (long long)b * a.sk : nullptr;

  int kend = a.sk;
  if (a.causal) {
    const int last_row = min(q0 + BQ, a.sq) - 1;
    kend = max(0, min(a.sk, last_row + off + 1));
  }
  const int ntiles = (kend + BK - 1) / BK;
  const int nt = ntiles > rank ? (ntiles - rank + C - 1) / C : 0;
  auto fetch = [&](int i, int buf) {
    const int k0 = (rank + i * C) * BK;
    copy_rows<D, BK>(kt + buf * L::TILE, kp, a.kss, k0, a.sk, a.d, a.vec);
    copy_rows<D, BK>(vt + buf * L::TILE, vp, a.vss, k0, a.sk, a.d, a.vec);
    copy_bias(bt + buf * BK, bp, k0, a.sk);
  };
  copy_rows<D, BQ>(qt, qp, a.qss, q0, a.sq, a.d, a.vec);
  if (nt > 0) fetch(0, 0);
  hopper::cp_async_commit();

  Rows<D> st;
  rows_init(st);
  const int rows[2] = {q0 + qr0 + g, q0 + qr0 + g + 8};
  for (int i = 0; i < nt; ++i) {
    const int buf = i % NSF;
    hopper::cp_async_wait<0>();   // tile i (and q) have landed
    __syncthreads();              // ... for every thread; tile i - 1 is done
    if (i + 1 < nt) fetch(i + 1, (i + 1) % NSF);
    hopper::cp_async_commit();
    tile_step<D, BK / 8>(st, qt, qr0, kt + buf * L::TILE,
                               vt + buf * L::TILE, bt + buf * BK, 0,
                               (rank + i * C) * BK, rows, off, a.sk,
                               a.causal, a.scale);
  }
  hopper::cp_async_wait<0>();

  if (C == 1) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = rows[x];
      if (row >= a.sq) continue;
      const float ls = fmaxf(st.l[x], 1e-30f);
      float* op = a.out + ((long long)bh * a.sq + row) * a.d;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * c + 2 * t + u;
          if (col < a.d) op[col] = st.o[c][2 * x + u] / ls;
        }
      if (t == 0) a.lse[(long long)bh * a.sq + row] = st.m[x] + logf(ls);
    }
    return;
  }
  __syncthreads();                // the ring is free for the partials
  float* po = smem_tc;            // [BQ][D]
  float* pm = po + BQ * D;        // [BQ]
  float* pl = pm + BQ;            // [BQ]
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      po[(qr0 + g + 8 * (e >> 1)) * D + 8 * c + 2 * t + (e & 1)] =
          st.o[c][e];
  if (t == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      pm[qr0 + g + 8 * x] = st.m[x];
      pl[qr0 + g + 8 * x] = st.l[x];
    }
  }
  cl.sync();
  cluster_merge<D, BQ>(cl, po, pm, pl, min(BQ, a.sq - q0), a.d,
                       a.out + ((long long)bh * a.sq + q0) * a.d,
                       a.lse + (long long)bh * a.sq + q0);
  cl.sync();                      // no rank leaves while others read it
}

// The short-query route (sq <= 16, the decode step's cross-attention): a
// block of four warps for all rows of one (batch, head) against its
// rank's 64-key tiles, each warp 16 keys of every tile. The warps'
// partials merge in warp order in the block, the ranks' in the cluster.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tf32_short_kernel(const Args a) {
  constexpr int R = SHORT_ROWS;
  using L = Layout<D>;
  extern __shared__ __align__(16) float smem_tc[];
  float* qt = smem_tc;
  float* kt = qt + R * L::LD;
  float* vt = kt + NSF * L::TILE;
  float* bt = vt + NSF * L::TILE;
  __shared__ float s_w[R][WARPS];     // the warps' weights exp(m - m*)
  __shared__ float s_m[R], s_l[R];    // the block's row max, normaliser
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int off = a.sk - a.sq;
  const int ntiles = (a.sk + BK - 1) / BK;
  const int nt = ntiles > rank ? (ntiles - rank + C - 1) / C : 0;
  const float* qp = a.q + b * a.qsb + h * a.qsh;
  const float* kp = a.k + b * a.ksb + h * a.ksh;
  const float* vp = a.v + b * a.vsb + h * a.vsh;
  const float* bp = a.bias ? a.bias + (long long)b * a.sk : nullptr;

  auto fetch = [&](int i, int buf) {
    const int k0 = (rank + i * C) * BK;
    copy_rows<D, BK>(kt + buf * L::TILE, kp, a.kss, k0, a.sk, a.d, a.vec);
    copy_rows<D, BK>(vt + buf * L::TILE, vp, a.vss, k0, a.sk, a.d, a.vec);
    copy_bias(bt + buf * BK, bp, k0, a.sk);
  };
  copy_rows<D, R>(qt, qp, a.qss, 0, a.sq, a.d, a.vec);
  if (nt > 0) fetch(0, 0);
  hopper::cp_async_commit();

  Rows<D> st;
  rows_init(st);
  const int rows[2] = {g, g + 8};
  for (int i = 0; i < nt; ++i) {
    const int buf = i % NSF;
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nt) fetch(i + 1, (i + 1) % NSF);
    hopper::cp_async_commit();
    tile_step<D, 2>(st, qt, 0, kt + buf * L::TILE,
                          vt + buf * L::TILE, bt + buf * BK, 16 * warp,
                          (rank + i * C) * BK, rows, off, a.sk, a.causal,
                          a.scale);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                // the tiles are free for the merge

  // the warps' partials: out [WARPS][R][D], max and sum [WARPS][R]; the
  // block's merged out [R][D] after them
  float* wo = smem_tc;
  float* wm = wo + WARPS * R * D;
  float* wl = wm + WARPS * R;
  float* bo = wl + WARPS * R;
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(warp * R + g + 8 * (e >> 1)) * D + 8 * c + 2 * t + (e & 1)] =
          st.o[c][e];
  if (t == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      wm[warp * R + rows[x]] = st.m[x];
      wl[warp * R + rows[x]] = st.l[x];
    }
  }
  __syncthreads();
  if (tid < R) {
    float ms = -INFINITY;
    for (int w = 0; w < WARPS; ++w) ms = fmaxf(ms, wm[w * R + tid]);
    float den = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(wm[w * R + tid] - ms);
      s_w[tid][w] = wt;
      den += wl[w * R + tid] * wt;
    }
    s_m[tid] = ms;
    s_l[tid] = den;
  }
  __syncthreads();
  const int d = a.d;
  for (int i = tid; i < R * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    float num = 0.f;
    for (int w = 0; w < WARPS; ++w) num += wo[(w * R + r) * D + c] * s_w[r][w];
    if (C > 1)
      bo[r * D + c] = num;
    else if (r < a.sq)
      a.out[((long long)bh * a.sq + r) * d + c] = num / fmaxf(s_l[r], 1e-30f);
  }
  if (C == 1) {
    if (tid < a.sq)
      a.lse[(long long)bh * a.sq + tid] =
          s_m[tid] + logf(fmaxf(s_l[tid], 1e-30f));
    return;
  }
  cl.sync();
  cluster_merge<D, R>(cl, bo, s_m, s_l, a.sq, d,
                      a.out + (long long)bh * a.sq * d,
                      a.lse + (long long)bh * a.sq);
  cl.sync();
}

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

// Blocks a cluster (key splits) for `pairs` (query tile, b*h) pairs over
// sk keys: enough for about two blocks an SM, at most one a 64-key tile
// and MAX_CLUSTER (the portable cluster size). The short-query route
// rounds up (its blocks are few and light: more bytes in flight), the
// query-tiled route down (its blocks are full: no second wave).
inline int plan(int sms, long long pairs, int sk, bool short_q) {
  const long long tiles = max(1, (sk + BK - 1) / BK);
  const long long target = 2LL * sms;
  const long long p = max(pairs, 1LL);
  long long c = short_q ? (target + p - 1) / p : target / p;
  c = min(c, min(tiles, (long long)MAX_CLUSTER));
  return (int)max(c, 1LL);
}

// whether every row of the q, k and v views starts on 16 bytes and d is
// a multiple of 4 floats: tiles then copy by 16-byte cp.async, else by
// 4-byte cp.async
inline int vector_loads(const void* q, const void* k, const void* v,
                        const long long* strides, int d) {
  if (d % 4 != 0) return 0;
  const void* views[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(views[i]) % 16 != 0) return 0;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 4 != 0) return 0;
  return 1;
}

template <int D>
int launch(const Args& a, int B, int C, bool short_q, cudaStream_t stream) {
  using L = Layout<D>;
  auto run = [&](auto kernel, dim3 grid, int bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  };
  if (!short_q)
    return run(flash_fwd_tf32_kernel<D>,
               dim3(C, (a.sq + BQ - 1) / BQ, B * a.H), L::bytes(BQ));
  const int merge = 4 * ((WARPS + 1) * SHORT_ROWS * D + 2 * WARPS *
                         SHORT_ROWS);
  return run(flash_fwd_tf32_short_kernel<D>, dim3(C, B * a.H),
             max(L::bytes(SHORT_ROWS), merge));
}

}  // namespace f32tc

// ------------------------------------------------------- bf16 and f16

// dynamic shared memory of the wgmma kernel: the q tile, NS k and NS v
// tiles; per key tile (NS buffers) the bias, the ids and the dropout
// column keys; the segment range; 1 KiB to align the tiles to the
// swizzle's 1024 bytes
constexpr int NS = 3;             // key-tile buffers of the wgmma kernel

template <int D>
constexpr int mma_smem_bytes() {
  return (1 + 2 * NS) * (D / 64) * mma::TILE_BYTES + 3 * NS * BK * 4 + 16 +
         1024;
}

template <int D, typename T>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const T* __restrict__ q,
              const T* __restrict__ k,
              const T* __restrict__ v,
              const float* __restrict__ bias, const int* __restrict__ qseg,
              const int* __restrict__ kseg, T* __restrict__ out,
              float* __restrict__ lse, int H, int sq, int sk, int d,
              Strides4 st, float scale, int causal, Dropout dr, int vec,
              int pow2) {
  using namespace mma;
  constexpr int TB = (D / 64) * TILE_BYTES;   // one tile of D columns
  constexpr int NB = D / 64;                  // 64-column blocks of out
  constexpr int KS = D / 16;                  // reduction steps of S
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                 // q, or round(q * scale)
  uint8_t* ks = qs + TB;              // k, NS buffers
  uint8_t* vs = ks + NS * TB;         // v, NS buffers
  float* bs = reinterpret_cast<float*>(vs + NS * TB);          // [NS][BK]
  int* kids = reinterpret_cast<int*>(bs + NS * BK);            // [NS][BK]
  unsigned int* cks =
      reinterpret_cast<unsigned int*>(kids + NS * BK);         // [NS][BK]
  int* seg_sh = reinterpret_cast<int*>(cks + NS * BK);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;
  const bool drop = dr.block_q > 0;
  const float s_scale = pow2 ? scale : 1.f;

  const T* qp = q + b * st.v[0] + h * st.v[1];
  const T* kp = k + b * st.v[3] + h * st.v[4];
  const T* vp = v + b * st.v[6] + h * st.v[7];
  const float* bp = bias ? bias + (long long)b * sk : nullptr;
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

  int kbeg = 0, kend = sk;
  if (causal) {
    const int last_row = min(q0 + BQ, sq) - 1;
    kend = max(0, min(sk, last_row + off + 1));
  }
  if (qsp) {
    const int2 w = seg_window(qsp, q0, min(q0 + BQ, sq), ksp, sk, seg_sh);
    kbeg = w.x / BK * BK;
    kend = min(kend, w.y);
  }
  const int nt = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  // the key tile t into buffer `buf`: k and v by cp.async (or element
  // loads), the bias and ids by 4-byte cp.async, the dropout column keys
  // computed here
  auto fetch = [&](int t, int buf) {
    const int k0 = kbeg + t * BK;
    load_tile<D, T>(ks + buf * TB, kp, st.v[5], k0, sk, d, vec);
    load_tile<D, T>(vs + buf * TB, vp, st.v[8], k0, sk, d, vec);
    if (tid < BK) {
      const int col = k0 + tid;
      const bool ok = col < sk;
      float* bd = bs + buf * BK + tid;
      int* kd = kids + buf * BK + tid;
      if (bp) cp_async4(bd, ok ? bp + col : bp, ok ? 4 : 0);
      else *bd = 0.f;
      if (ksp) cp_async4(kd, ok ? ksp + col : ksp, ok ? 4 : 0);
      else *kd = 0;
      cks[buf * BK + tid] = drop ? drop_col_key(dr, col) : 0u;
    }
  };

  load_tile<D, T>(qs, qp, st.v[2], q0, sq, d, vec);
  if (nt > 0) fetch(0, 0);
  cp_async_commit();

  // this thread's two rows (accumulator rows frag_row(0) and + 8): the
  // running max, the normaliser, the ids and the dropout row keys
  float m[2], l[2];
  unsigned int rk[2];
  int qid[2], rows[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = q0 + frag_row(2 * x);
    rows[x] = row;
    m[x] = NEG;
    l[x] = 0.f;
    qid[x] = (qsp && row < sq) ? qsp[row] : 0;
    rk[x] = drop ? drop_row_key(dr, bh, row) : 0u;
  }

  // out, set by the first tile's product (scale-d 0): zeros written here
  // would be register moves beside a running product (ptxas C7515)
  float acc[NB][32];

  // Per key tile t: S(t) is one wgmma group, waited for together with
  // P.V(t - 1), which ran under this tile's barrier and copies. The k and
  // v tiles of buffer t % NS are refilled only at tile t + 2, after every
  // warp has waited for P.V(t) and passed that tile's barrier.
  for (int t = 0; t < nt; ++t) {
    const int buf = t % NS;
    const int k0 = kbeg + t * BK;
    cp_async_wait<0>();           // tile t (and q) have landed
    fence_async_smem();
    __syncthreads();
    if (t + 1 < nt) fetch(t + 1, (t + 1) % NS);
    cp_async_commit();
    if (!pow2 && t == 0) {        // round(q * scale), in place, once
      scale_tile<D, T>(qs, qs, scale);
      fence_async_smem();
      __syncthreads();
    }

    float s[32];
    wgmma_fence();
    wgmma_ss_k<KS, T>(s, qs, ks + buf * TB);
    wgmma_commit();
    wgmma_wait<0>();              // S(t) and P.V(t - 1) are done
    fence_regs(s);
#pragma unroll
    for (int n = 0; n < NB; ++n) fence_regs(acc[n]);

    const float* bt = bs + buf * BK;
    const int* kt_ids = kids + buf * BK;
    const unsigned int* ck = cks + buf * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      const int lc = frag_col(i);
      const int col = k0 + lc;
      float lg = s[i] * s_scale + bt[lc];
      if (ksp && qid[x] != kt_ids[lc]) lg = NEG;
      if (causal && col > rows[x] + off) lg = NEG;
      if (col >= sk) lg = -INFINITY;
      s[i] = lg;
      mx[x] = fmaxf(mx[x], lg);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m[x], mx[x]);
      alpha[x] = expf(m[x] - m_new);
      m[x] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      float p = expf(s[i] - m[x]);
      rs[x] += p;
      if (drop)
        p = drop_keep_mixed(dr, rk[x] ^ ck[frag_col(i)]) ? p * dr.inv_keep
                                                         : 0.f;
      s[i] = p;
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
      l[x] = l[x] * alpha[x] + rs[x];
    }
    if (t > 0) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[n][i] *= alpha[(i >> 1) & 1];
    }

    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a<T>(s, kk, a[kk]);
#pragma unroll
    for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        wgmma_rs<T>(acc[n], a[kk],
                    desc(vs + buf * TB, mn_major_step(kk, n)),
                    t > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
  cp_async_wait<0>();

  float ls[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) ls[x] = fmaxf(l[x], 1e-30f);
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int x = (i >> 1) & 1;
      const int row = rows[x];
      const int col = 64 * n + frag_col(i);
      if (row >= sq || col >= d) continue;
      T* op = out + ((long long)bh * sq + row) * d + col;
      op[0] = Half16<T>::from(nt > 0 ? acc[n][i] / ls[x] : 0.f);
      if (col + 1 < d)
        op[1] = Half16<T>::from(nt > 0 ? acc[n][i + 1] / ls[x] : 0.f);
    }
  if ((tid & 3) == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
      if (rows[x] < sq) lse[(long long)bh * sq + rows[x]] = m[x] + logf(ls[x]);
  }
}

template <typename T>
int launch_mma(const void* q, const void* k, const void* v,
               const void* bias, const void* qseg, const void* kseg,
               void* out, void* lse, int B, int H, int sq, int sk, int d,
               const Strides4& st, float scale, int causal, Dropout dr,
               int vec, int pow2, cudaStream_t stream) {
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  auto run = [&](auto kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 128, smem, stream>>>(
        static_cast<const T*>(q),
        static_cast<const T*>(k),
        static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const int*>(qseg),
        static_cast<const int*>(kseg), static_cast<T*>(out),
        static_cast<float*>(lse), H, sq, sk, d, st, scale, causal, dr, vec,
        pow2);
    return (int)cudaGetLastError();
  };
  return d <= 64 ? run(flash_fwd_mma<64, T>, mma_smem_bytes<64>())
                 : run(flash_fwd_mma<128, T>, mma_smem_bytes<128>());
}

// the four views of the vector-loads rule: q, k, v, and q again
Strides4 views_of(const void* q, const void* k, const void* v,
                  const long long* strides, const void** views) {
  long long s12[12];
  for (int i = 0; i < 9; ++i) s12[i] = strides[i];
  for (int i = 0; i < 3; ++i) s12[9 + i] = strides[i];
  views[0] = q;
  views[1] = k;
  views[2] = v;
  views[3] = q;
  return Strides4::from(s12);
}

}  // namespace

// The route of pt_flash_fwd (the one rule of the entry point, asked by
// the wrapper to count the launches of each route): 1 the wgmma kernel
// (bf16 or f16); for float32, 0 the SIMT kernel (attention dropout or segment
// ids, which no serving path uses), else the 3xTF32 tensor-core kernels,
// 2 query-tiled (sq > 16), 3 short-query (sq <= 16).
extern "C" int pt_flash_fwd_route(int dtype, int sq, int segs,
                                  int dropout) {
  if (dtype >= 1) return 1;
  if (segs || dropout) return 0;
  return sq <= f32tc::SHORT_ROWS ? 3 : 2;
}

// Blocks a cluster (key splits) of the float32 tensor-core routes for
// B*H = bh and sq query rows over sk keys on `device` (`f32tc::plan`).
extern "C" int pt_flash_fwd_cluster(int device, int bh, int sq, int sk) {
  const bool short_q = sq <= f32tc::SHORT_ROWS;
  const long long pairs =
      (long long)bh * (short_q ? 1 : (sq + BQ - 1) / BQ);
  return f32tc::plan(f32tc::sm_count(device), pairs, sk, short_q);
}

// Whether the bf16 kernel copies the tiles of these views (q, k, v;
// strides as in pt_flash_fwd) by 16-byte cp.async (1) or element by
// element (0): the entry point's own rule, asked by the wrapper to count
// the element-copy launches.
extern "C" int pt_flash_fwd_vector_loads(const void* q, const void* k,
                                         const void* v,
                                         const long long* strides, int d) {
  const void* views[4];
  const Strides4 st = views_of(q, k, v, strides, views);
  return mma::vector_loads(views, st.v, d);
}

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16; the
// kernel is `pt_flash_fwd_route`'s. q [B, H, sq, d], k/v [B, H, sk, d]
// with unit stride on d and element strides (batch, head, row) given in
// `strides` (q, k, v: 9 values); bias: [B, sk] float32 or null; qseg /
// kseg: [B, sq] / [B, sk] int32 segment ids, non-decreasing along each
// row, or both null; out [B, H, sq, d] contiguous; lse [B * H, sq]
// float32. Dropout: seed, uint32 keep threshold, 1/keep and the logical
// blocks (block_q = 0: no dropout), and the shard's address in the whole
// call: batch offset b0, head offset h0 and the call's head count
// (`Dropout` in flash_common.cuh; 0, 0, H for an unsharded call).
// Returns the cudaError_t of the launch.
extern "C" int pt_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* qseg, const void* kseg, void* out,
                            void* lse, int B, int H, int sq, int sk, int d,
                            const long long* strides,
                            float scale, int causal, unsigned int seed,
                            unsigned int thresh, float inv_keep, int block_q,
                            int block_k, int b0, int h0, int heads,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype < 0 || dtype > 2) || block_q < 0 ||
      block_k < 0 || (block_q > 0) != (block_k > 0) ||
      (qseg == nullptr) != (kseg == nullptr) ||
      drop_address_bad(block_q, H, b0, h0, heads))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, inv_keep, block_q, block_k, H, b0, h0,
                   heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int route = pt_flash_fwd_route(dtype, sq, qseg != nullptr,
                                       block_q > 0);
  if (route == 1) {
    const void* views[4];
    const Strides4 st = views_of(q, k, v, strides, views);
    const int vec = mma::vector_loads(views, st.v, d);
    const int pow2 = mma::power_of_two(scale);
    return dtype == 1
        ? launch_mma<__nv_bfloat16>(q, k, v, bias, qseg, kseg, out, lse, B,
                                    H, sq, sk, d, st, scale, causal, dr,
                                    vec, pow2, s)
        : launch_mma<__half>(q, k, v, bias, qseg, kseg, out, lse, B, H, sq,
                             sk, d, st, scale, causal, dr, vec, pow2, s);
  }
  if (route >= 2) {
    const f32tc::Args a{
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<float*>(lse), H, sq, sk, d,
        strides[0], strides[1], strides[2], strides[3], strides[4],
        strides[5], strides[6], strides[7], strides[8], scale, causal,
        f32tc::vector_loads(q, k, v, strides, d)};
    const int C = pt_flash_fwd_cluster(device, B * H, sq, sk);
    return d <= 64 ? f32tc::launch<64>(a, B, C, route == 3, s)
                   : f32tc::launch<128>(a, B, C, route == 3, s);
  }
  return d <= 64
      ? launch<float, 64>(q, k, v, bias, qseg, kseg, out, lse, B, H, sq, sk,
                          d, strides, scale, causal, dr, s)
      : launch<float, 128>(q, k, v, bias, qseg, kseg, out, lse, B, H, sq, sk,
                           d, strides, scale, causal, dr, s);
}
