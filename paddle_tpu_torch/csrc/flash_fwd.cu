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
// bfloat16 (the training path): both products run on the tensor cores
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
// float32 (serving's prefill, encoder and cross-attention) keeps the SIMT
// kernel below: the logits and p.v products run on the CUDA cores (67
// TFLOP/s fp32; TF32 tensor cores would lose the 2e-5 parity with the
// plain version). At the serving shapes (s <= 1024, d = 64) the work per
// block is small and the kernel is bound by shared-memory traffic and
// latency rather than by device memory. One 128-thread block per (query
// tile of 64 rows, b*h); K, V and the key bias are staged tile by tile (64
// keys) in shared memory with a padded row stride so the column reads are
// free of bank conflicts; each thread owns 4 rows x 8 key columns of the
// logits and 4 rows x d/8 columns of the accumulator, the row max / row
// sum reduce over the 8 lanes of a row with warp shuffles, and p goes
// through shared memory to the p.v product.

#include <math.h>

#include "flash_mma.cuh"
#include "flash_common.cuh"

namespace {

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

// ---------------------------------------------------------------- bf16

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

template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ bias, const int* __restrict__ qseg,
              const int* __restrict__ kseg, __nv_bfloat16* __restrict__ out,
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

  const __nv_bfloat16* qp = q + b * st.v[0] + h * st.v[1];
  const __nv_bfloat16* kp = k + b * st.v[3] + h * st.v[4];
  const __nv_bfloat16* vp = v + b * st.v[6] + h * st.v[7];
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
    load_tile<D>(ks + buf * TB, kp, st.v[5], k0, sk, d, vec);
    load_tile<D>(vs + buf * TB, vp, st.v[8], k0, sk, d, vec);
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

  load_tile<D>(qs, qp, st.v[2], q0, sq, d, vec);
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
      scale_tile<D>(qs, qs, scale);
      fence_async_smem();
      __syncthreads();
    }

    float s[32];
    wgmma_fence();
    wgmma_ss_k<KS>(s, qs, ks + buf * TB);
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
    for (int kk = 0; kk < 4; ++kk) to_a(s, kk, a[kk]);
#pragma unroll
    for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        wgmma_rs(acc[n], a[kk], desc(vs + buf * TB, mn_major_step(kk, n)),
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
      __nv_bfloat16* op = out + ((long long)bh * sq + row) * d + col;
      op[0] = __float2bfloat16(nt > 0 ? acc[n][i] / ls[x] : 0.f);
      if (col + 1 < d)
        op[1] = __float2bfloat16(nt > 0 ? acc[n][i + 1] / ls[x] : 0.f);
    }
  if ((tid & 3) == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
      if (rows[x] < sq) lse[(long long)bh * sq + rows[x]] = m[x] + logf(ls[x]);
  }
}

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
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const float*>(bias), static_cast<const int*>(qseg),
        static_cast<const int*>(kseg), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), H, sq, sk, d, st, scale, causal, dr, vec,
        pow2);
    return (int)cudaGetLastError();
  };
  return d <= 64 ? run(flash_fwd_mma<64>, mma_smem_bytes<64>())
                 : run(flash_fwd_mma<128>, mma_smem_bytes<128>());
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

// The tensor-core route of pt_flash_fwd for this dtype (1: the bf16
// wgmma kernel; 0: the float32 SIMT kernel): the one rule of the entry
// point, asked by the wrapper to count the launches of each route.
extern "C" int pt_flash_fwd_tensor_cores(int dtype) { return dtype == 1; }

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

// C entry point, bound with ctypes. dtype: 0 = float32 (the SIMT kernel),
// 1 = bfloat16 (the wgmma kernel). q [B, H, sq, d], k/v [B, H, sk, d] with
// unit stride on d and element strides (batch, head, row) given in
// `strides` (q, k, v: 9 values); bias: [B, sk] float32 or null; qseg /
// kseg: [B, sq] / [B, sk] int32 segment ids, non-decreasing along each
// row, or both null; out [B, H, sq, d] contiguous; lse [B * H, sq]
// float32. Dropout: seed, uint32 keep threshold, 1/keep and the logical
// blocks (block_q = 0: no dropout). Returns the cudaError_t of the launch.
extern "C" int pt_flash_fwd(int device, int dtype, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* qseg, const void* kseg, void* out,
                            void* lse, int B, int H, int sq, int sk, int d,
                            const long long* strides,
                            float scale, int causal, unsigned int seed,
                            unsigned int thresh, float inv_keep, int block_q,
                            int block_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype != 0 && dtype != 1) || block_q < 0 ||
      block_k < 0 || (block_q > 0) != (block_k > 0) ||
      (qseg == nullptr) != (kseg == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, inv_keep, block_q, block_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pt_flash_fwd_tensor_cores(dtype)) {
    const void* views[4];
    const Strides4 st = views_of(q, k, v, strides, views);
    return launch_mma(q, k, v, bias, qseg, kseg, out, lse, B, H, sq, sk, d,
                      st, scale, causal, dr,
                      mma::vector_loads(views, st.v, d),
                      mma::power_of_two(scale), s);
  }
  return d <= 64
      ? launch<float, 64>(q, k, v, bias, qseg, kseg, out, lse, B, H, sq, sk,
                          d, strides, scale, causal, dr, s)
      : launch<float, 128>(q, k, v, bias, qseg, kseg, out, lse, B, H, sq, sk,
                           d, strides, scale, causal, dr, s);
}
