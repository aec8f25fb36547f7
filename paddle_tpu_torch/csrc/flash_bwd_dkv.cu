// Flash-attention backward, dK / dV (and the key-bias gradient), for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/attention.py `dkv_kernel` inside
// `flash_attention_bwd` (the Pallas dK/dV kernel, grid (b*h, key block),
// looping over query blocks), without and with segment ids (`has_segs`).
// Same math per (query row, key):
//   qbs      = round(q * scale)     (the forward's folded query; it is
//                                    also the s*q that dk needs)
//   logits   = qbs . k + bias, pairs of different segments and causal
//              keys (end-aligned) -1e30
//   p        = exp(logits - lse)
//   dp       = dO . v;  with dropout pd = D(p), dp = D(dp), where D drops
//              and upscales with the forward's keep bits
//   dlogits  = p * (dp - delta)
//   dv      += round(pd)^T . dO
//   dk      += round(dlogits)^T . qbs
//   dbias   += sum over rows of dlogits   (per b*h; the wrapper sums heads)
// "round" is a cast to the operand type, as in the TPU kernel.
// Segment ids (flash_common.cuh): a key tile visits only the query tiles
// of [lower_bound(qseg, min kseg), upper_bound(qseg, max kseg)),
// intersected with the causal start; masked pairs have p = 0, so they add
// nothing to dk, dv or dbias.
// Differences from the TPU kernel, by design: end-aligned causal for any
// sq / sk (the query loop starts at the first tile that can see the key
// tile), ragged tails masked here, no block-divisibility gate.
//
// What bounds it on an H100: 8 * b*h*sq*sk*d operations (two logits-sized
// products, dv and dk), against reading k, v, bias once and q, dO, lse,
// delta once per key tile.
//
// bfloat16 (the training path) and float16 (the same body over __half,
// for amp.auto_cast(dtype="float16"): f16 wgmma, pd and ds rounded to f16
// where the bf16 instance rounds them to bf16, float32 accumulators and
// dbias): the four products run on the tensor cores
// (bf16 wgmma). One warpgroup per (key tile of 64, b*h); its k and v stay
// in swizzled shared memory, its bias, ids and dropout column keys in
// registers; q, dO and the rows' lse, delta, ids and dropout row keys
// stream in 64-row tiles through a ring of three buffers, cp.async filling
// the next tile's under this tile's work. The products are
// taken transposed, S^T = K.Q^T and dP^T = V.dO^T, so each accumulator
// row is a key: round(pd^T) and round(dlogits^T) go from those registers
// straight into the A operand of dV += Pd^T.dO and dK += dS^T.Q (B = the
// dO and q tiles read MN-major; both run on under the next tile's copies
// and S^T), with no transpose through shared memory, and dbias is a row
// sum kept in registers and reduced over the four threads of a row once
// at the end. A power-of-two scale multiplies
// S^T and dk in fp32; any other rounds each q tile to round(q * scale) in
// place.
// float32 keeps the SIMT kernel below: tiles as fp32 with padded rows,
// every product an fmaf on the CUDA cores; each thread owns 4 rows x 8
// keys of the logits-sized products, and round(pd) and dlogits go through
// shared memory, read transposed for 4 keys x d/8 columns of dk and dv
// (and 4 keys' dbias sums).

#include <math.h>

#include "flash_mma.cuh"
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // k, v, round(q*scale), dO tiles [64][D + 1]; round(pd), dlogits tiles
  // [64][BK + 1]; key bias [BK]; lse, delta [BQ]; as int: the query
  // tile's segment ids [BQ] and the segment range [2]
  return 4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + BK + 2 * BQ + BQ + 2;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg,
                     const float* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ db, int H,
                     int sq, int sk, int d, Strides4 st, float scale,
                     int causal, Dropout dr) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int OPT = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;               // k
  float* vs = ks + BK * LD;       // v
  float* qs = vs + BK * LD;       // round(q * scale)
  float* gs = qs + BQ * LD;       // dO
  float* pds = gs + BQ * LD;      // round(pd)
  float* dls = pds + BQ * LP;     // dlogits
  float* bs = dls + BQ * LP;      // key bias
  float* ls = bs + BK;            // lse of the tile's rows
  float* des = ls + BQ;           // delta of the tile's rows
  int* qids = reinterpret_cast<int*>(des + BQ);  // the rows' segment ids
  int* seg_sh = qids + BQ;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;        // logits phase: rows 4*rg .. 4*rg + 3
  const int cg = tid & 7;         // logits phase: keys cg + 8*j;
  //                                 accumulate phase: columns cg + 8*c
  const int kg = tid >> 3;        // accumulate phase: keys 4*kg .. +3
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int off = sk - sq;
  const bool drop = dr.block_q > 0;

  const float* qp = q + b * st.v[0] + h * st.v[1];
  const float* kp = k + b * st.v[3] + h * st.v[4];
  const float* vp = v + b * st.v[6] + h * st.v[7];
  const float* gp = g + b * st.v[9] + h * st.v[10];
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < sk && c < d) {
      kx = kp[(long long)(k0 + r) * st.v[5] + c];
      vx = vp[(long long)(k0 + r) * st.v[8] + c];
    }
    ks[r * LD + c] = kx;
    vs[r * LD + c] = vx;
  }
  if (tid < BK)
    bs[tid] = (bias && k0 + tid < sk) ? bias[(long long)b * sk + k0 + tid]
                                      : 0.f;

  float dk_acc[RPT][OPT], dv_acc[RPT][OPT], db_acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    db_acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }
  // segment ids of the logits phase's keys cg + 8*j
  int kid[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = k0 + cg + 8 * j;
    kid[j] = (ksp && col < sk) ? ksp[col] : 0;
  }

  // first query tile that sees any key of this tile: row >= k0 - off
  int q_lo = 0, q_end = sq;
  if (causal) q_lo = max(0, k0 - off) / BQ * BQ;
  if (ksp) {
    const int2 w = seg_window(ksp, k0, min(k0 + BK, sk), qsp, sq, seg_sh);
    q_lo = max(q_lo, w.x / BQ * BQ);
    q_end = w.y;
  }

  for (int q0 = q_lo; q0 < q_end; q0 += BQ) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float qx = 0.f, gx = 0.f;
      if (q0 + r < sq && c < d) {
        qx = qp[(long long)(q0 + r) * st.v[2] + c] * scale;
        gx = gp[(long long)(q0 + r) * st.v[11] + c];
      }
      qs[r * LD + c] = qx;
      gs[r * LD + c] = gx;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < sq;
      ls[tid] = ok ? lse[(long long)bh * sq + q0 + tid] : 0.f;
      des[tid] = ok ? delta[(long long)bh * sq + q0 + tid] : 0.f;
      qids[tid] = (qsp && ok) ? qsp[q0 + tid] : 0;
    }
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(rg * RPT + i) * LD + c];
        gv[i] = gs[(rg * RPT + i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(cg + 8 * j) * LD + c];
        vv[j] = vs[(cg + 8 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int lr = rg * RPT + i;
      const int row = q0 + lr;
      const unsigned int row_key = drop ? drop_row_key(dr, bh, row) : 0u;
      const float lse_r = ls[lr], dl_r = des[lr];
      const int qid = qids[lr];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (qsp && qid != kid[j]) x = NEG;
        if (causal && col > row + off) x = NEG;
        const float p = (col < sk && row < sq) ? expf(x - lse_r) : 0.f;
        float pd = p, dpv = dp[i][j];
        if (drop) {
          const bool keep = drop_keep(dr, row_key, col);
          pd = keep ? p * dr.inv_keep : 0.f;
          dpv = keep ? dpv * dr.inv_keep : 0.f;
        }
        pds[lr * LP + cg + 8 * j] = pd;
        dls[lr * LP + cg + 8 * j] = p * (dpv - dl_r);
      }
    }
    __syncthreads();              // the accumulate phase reads other
    //                               warps' rows of pds / dls

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[RPT], lv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = pds[r * LP + kg * RPT + i];
        lv[i] = dls[r * LP + kg * RPT + i];
        db_acc[i] += lv[i];
      }
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float gg = gs[r * LD + cg + 8 * c];
        const float qq = qs[r * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][c] = fmaf(pv[i], gg, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(lv[i], qq, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + kg * RPT + i;
    if (key >= sk) continue;
    float* kop = dk + ((long long)bh * sk + key) * d;
    float* vop = dv + ((long long)bh * sk + key) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) {
        kop[col] = dk_acc[i][c];
        vop[col] = dv_acc[i][c];
      }
    }
    if (db && cg == 0) db[(long long)bh * sk + key] = db_acc[i];
  }
}

// ------------------------------------------------------- bf16 and f16

// dynamic shared memory of the wgmma kernel: k, v, NS q and NS dO tiles;
// per query tile (NS buffers) lse, delta, ids and the dropout row keys;
// the segment range; 1 KiB to align the tiles
constexpr int NS = 3;             // query-tile buffers of the wgmma kernel

template <int D>
constexpr int mma_smem_bytes() {
  return (2 + 2 * NS) * (D / 64) * mma::TILE_BYTES + 4 * NS * BQ * 4 + 16 +
         1024;
}

template <int D, typename T>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_mma(const T* __restrict__ q,
                  const T* __restrict__ k,
                  const T* __restrict__ v,
                  const float* __restrict__ bias,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const T* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ db,
                  int H, int sq, int sk, int d, Strides4 st, float scale,
                  int causal, Dropout dr, int vec, int pow2) {
  using namespace mma;
  constexpr int TB = (D / 64) * TILE_BYTES;
  constexpr int NB = D / 64;
  constexpr int KS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = base;                 // k
  uint8_t* vs = ks + TB;              // v
  uint8_t* qs = vs + TB;              // q, or round(q * scale); NS buffers
  uint8_t* gs = qs + NS * TB;         // dO, NS buffers
  float* ls = reinterpret_cast<float*>(gs + NS * TB);   // lse [NS][BQ]
  float* des = ls + NS * BQ;                            // delta [NS][BQ]
  int* qids = reinterpret_cast<int*>(des + NS * BQ);    // ids [NS][BQ]
  unsigned int* rks =
      reinterpret_cast<unsigned int*>(qids + NS * BQ);  // row keys [NS][BQ]
  int* seg_sh = reinterpret_cast<int*>(rks + NS * BQ);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int off = sk - sq;
  const bool drop = dr.block_q > 0;
  const float s_scale = pow2 ? scale : 1.f;

  const T* qp = q + b * st.v[0] + h * st.v[1];
  const T* kp = k + b * st.v[3] + h * st.v[4];
  const T* vp = v + b * st.v[6] + h * st.v[7];
  const T* gp = g + b * st.v[9] + h * st.v[10];
  const float* lp = lse + (long long)bh * sq;
  const float* dp_ = delta + (long long)bh * sq;
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

  // first query tile that sees any key of this tile: row >= k0 - off
  int q_lo = 0, q_end = sq;
  if (causal) q_lo = max(0, k0 - off) / BQ * BQ;
  if (ksp) {
    const int2 w = seg_window(ksp, k0, min(k0 + BK, sk), qsp, sq, seg_sh);
    q_lo = max(q_lo, w.x / BQ * BQ);
    q_end = w.y;
  }
  const int nt = q_end > q_lo ? (q_end - q_lo + BQ - 1) / BQ : 0;

  // the query tile t into buffer `buf`: q and dO by cp.async (or element
  // loads), lse, delta and ids by 4-byte cp.async, the dropout row keys
  // computed here
  auto fetch = [&](int t, int buf) {
    const int q0 = q_lo + t * BQ;
    load_tile<D, T>(qs + buf * TB, qp, st.v[2], q0, sq, d, vec);
    load_tile<D, T>(gs + buf * TB, gp, st.v[11], q0, sq, d, vec);
    if (tid < BQ) {
      const int row = q0 + tid;
      const bool ok = row < sq;
      const int j = buf * BQ + tid;
      cp_async4(ls + j, ok ? lp + row : lp, ok ? 4 : 0);
      cp_async4(des + j, ok ? dp_ + row : dp_, ok ? 4 : 0);
      if (qsp) cp_async4(qids + j, ok ? qsp + row : qsp, ok ? 4 : 0);
      else qids[j] = 0;
      rks[j] = drop ? drop_row_key(dr, bh, row) : 0u;
    }
  };

  load_tile<D, T>(ks, kp, st.v[5], k0, sk, d, vec);
  load_tile<D, T>(vs, vp, st.v[8], k0, sk, d, vec);
  if (nt > 0) fetch(0, 0);
  cp_async_commit();

  // this thread's two keys (accumulator rows frag_row(0) and + 8)
  float kb[2], db_acc[2] = {0.f, 0.f};
  unsigned int ck[2];
  int kid[2], keys[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int key = k0 + frag_row(2 * x);
    const bool ok = key < sk;
    keys[x] = key;
    kb[x] = (bias && ok) ? bias[(long long)b * sk + key] : 0.f;
    kid[x] = (ksp && ok) ? ksp[key] : 0;
    ck[x] = drop ? drop_col_key(dr, key) : 0u;
  }

  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;

  // Per query tile t: dV(t) and dK(t) are left running into the next
  // tile, under its barrier and copies, and the wait for S^T(t + 1) and
  // dP^T(t + 1) retires them. Their q and dO tiles (buffer t % NS) are
  // refilled only at tile t + 2, after every warp has waited for them and
  // passed that tile's barrier.
  for (int t = 0; t < nt; ++t) {
    const int buf = t % NS;
    const int q0 = q_lo + t * BQ;
    cp_async_wait<0>();           // tile t (and k, v) have landed
    fence_async_smem();
    __syncthreads();
    if (t + 1 < nt) fetch(t + 1, (t + 1) % NS);
    cp_async_commit();
    uint8_t* qb = qs + buf * TB;
    uint8_t* gb = gs + buf * TB;
    if (!pow2) {
      scale_tile<D, T>(qb, qb, scale);
      fence_async_smem();
      __syncthreads();
    }

    float s[32], dp[32];           // S^T and dP^T: rows keys, cols rows
    wgmma_fence();
    wgmma_ss_k<KS, T>(s, ks, qb);
    wgmma_ss_k<KS, T>(dp, vs, gb);
    wgmma_commit();
    wgmma_wait<0>();              // dV, dK(t - 1), S^T(t), dP^T(t) done
    fence_regs(s);
    fence_regs(dp);

    const float* lt = ls + buf * BQ;
    const float* dt = des + buf * BQ;
    const int* it = qids + buf * BQ;
    const unsigned int* rk = rks + buf * BQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      const int lr = frag_col(i);
      const int row = q0 + lr;
      float l = s[i] * s_scale + kb[x];
      if (qsp && it[lr] != kid[x]) l = NEG;
      if (causal && keys[x] > row + off) l = NEG;
      const float p = (keys[x] < sk && row < sq) ? expf(l - lt[lr]) : 0.f;
      float pd = p, dpv = dp[i];
      if (drop) {
        const bool keep = drop_keep_mixed(dr, rk[lr] ^ ck[x]);
        pd = keep ? p * dr.inv_keep : 0.f;
        dpv = keep ? dpv * dr.inv_keep : 0.f;
      }
      const float dl = p * (dpv - dt[lr]);
      db_acc[x] += dl;
      s[i] = pd;
      dp[i] = dl;
    }

    uint32_t apd[4][4], adl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      to_a<T>(s, kk, apd[kk]);
      to_a<T>(dp, kk, adl[kk]);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      fence_regs(dv_acc[n]);
      fence_regs(dk_acc[n]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        wgmma_rs<T>(dv_acc[n], apd[kk], desc(gb, mn_major_step(kk, n)),
                    1);
        wgmma_rs<T>(dk_acc[n], adl[kk], desc(qb, mn_major_step(kk, n)),
                    1);
      }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    fence_regs(dv_acc[n]);
    fence_regs(dk_acc[n]);
  }
  cp_async_wait<0>();

  const float o_scale = pow2 ? scale : 1.f;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = keys[(i >> 1) & 1];
      const int col = 64 * n + frag_col(i);
      if (key >= sk || col >= d) continue;
      const long long o = ((long long)bh * sk + key) * d + col;
      dk[o] = Half16<T>::from(dk_acc[n][i] * o_scale);
      dv[o] = Half16<T>::from(dv_acc[n][i]);
      if (col + 1 < d) {
        dk[o + 1] = Half16<T>::from(dk_acc[n][i + 1] * o_scale);
        dv[o + 1] = Half16<T>::from(dv_acc[n][i + 1]);
      }
    }
  // dbias: each key's sum lies across the four threads of its row
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float v_ = db_acc[x];
    v_ += __shfl_xor_sync(0xffffffffu, v_, 1);
    v_ += __shfl_xor_sync(0xffffffffu, v_, 2);
    if (db && (tid & 3) == 0 && keys[x] < sk)
      db[(long long)bh * sk + keys[x]] = v_;
  }
}

template <typename T>
int launch_mma(const void* q, const void* k, const void* v,
               const void* bias, const void* qseg, const void* kseg,
               const void* g, const void* lse, const void* delta, void* dk,
               void* dv, void* db, int B, int H, int sq, int sk, int d,
               const Strides4& st, float scale, int causal, Dropout dr,
               int vec, int pow2, cudaStream_t stream) {
  dim3 grid((sk + BK - 1) / BK, B * H);
  auto run = [&](auto kernel, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 128, smem, stream>>>(
        static_cast<const T*>(q),
        static_cast<const T*>(k),
        static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const int*>(qseg),
        static_cast<const int*>(kseg), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(db), H, sq, sk, d, st, scale, causal, dr, vec,
        pow2);
    return (int)cudaGetLastError();
  };
  return d <= 64 ? run(flash_bwd_dkv_mma<64, T>, mma_smem_bytes<64>())
                 : run(flash_bwd_dkv_mma<128, T>, mma_smem_bytes<128>());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* qseg, const void* kseg, const void* g,
           const void* lse, const void* delta, void* dk,
           void* dv, void* db, int B, int H, int sq, int sk, int d,
           const Strides4& st, float scale, int causal, Dropout dr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(db), H, sq, sk, d, st, scale,
      causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32 (the SIMT kernel),
// 1 = bfloat16, 2 = float16 (the wgmma kernel's two instances). Operands (segment ids included) as in
// pt_flash_bwd_dq; dk / dv [B, H, sk, d] contiguous; db [B * H, sk]
// float32, or null when the key bias needs no gradient (or there is
// none). Returns the cudaError_t of the launch.
extern "C" int pt_flash_bwd_dkv(int device, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* bias, const void* qseg,
                                const void* kseg, const void* g,
                                const void* lse, const void* delta, void* dk,
                                void* dv, void* db, int B, int H, int sq,
                                int sk, int d, const long long* strides,
                                float scale, int causal, unsigned int seed,
                                unsigned int thresh, float inv_keep,
                                int block_q, int block_k, int b0, int h0,
                                int heads, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype < 0 || dtype > 2) || block_q < 0 ||
      block_k < 0 || (block_q > 0) != (block_k > 0) ||
      (qseg == nullptr) != (kseg == nullptr) ||
      drop_address_bad(block_q, H, b0, h0, heads))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, inv_keep, block_q, block_k, H, b0, h0,
                   heads};
  const Strides4 st = Strides4::from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype >= 1) {
    const void* views[4] = {q, k, v, g};
    const int vec = mma::vector_loads(views, strides, d);
    const int pow2 = mma::power_of_two(scale);
    return dtype == 1
        ? launch_mma<__nv_bfloat16>(q, k, v, bias, qseg, kseg, g, lse, delta,
                                    dk, dv, db, B, H, sq, sk, d, st, scale,
                                    causal, dr, vec, pow2, s)
        : launch_mma<__half>(q, k, v, bias, qseg, kseg, g, lse, delta, dk, dv,
                             db, B, H, sq, sk, d, st, scale, causal, dr, vec,
                             pow2, s);
  }
  return d <= 64
      ? launch<64>(q, k, v, bias, qseg, kseg, g, lse, delta, dk, dv,
                          db, B, H, sq, sk, d, st, scale, causal, dr, s)
      : launch<128>(q, k, v, bias, qseg, kseg, g, lse, delta, dk, dv,
                           db, B, H, sq, sk, d, st, scale, causal, dr, s);
}
