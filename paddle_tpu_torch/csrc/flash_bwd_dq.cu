// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/attention.py `dq_kernel` inside
// `flash_attention_bwd` (the Pallas dQ kernel, grid (b*h, query block),
// looping over key blocks), without and with segment ids (`has_segs`).
// Same math per (query row, key):
//   logits = round(q * scale) . k + bias, pairs of different segments
//            and causal keys (end-aligned) -1e30
//   p      = exp(logits - lse)                  (lse saved by the forward)
//   dp     = dO . v, dropped and upscaled by the forward's keep bits
//   ds     = p * (dp - delta)                   (delta = rowsum(dO * O))
//   dq    += round(ds) . round(k * scale)
// The scale folds into the query for the logits (as in the forward, so the
// recomputed logits match the saved lse) and into k for the product
// (`kbs` in the TPU kernel); "round" is a cast to the operand type.
// Segment ids (flash_common.cuh): a query tile visits only the key tiles
// of [lower_bound(kseg, min qseg), upper_bound(kseg, max qseg)), as the
// forward does; masked pairs get p = 0 and add nothing.
// Differences from the TPU kernel, by design: end-aligned causal for any
// sq / sk, ragged tails masked here (keys past sk get p = 0), no
// block-divisibility gate.
//
// What bounds it on an H100: 6 * b*h*sq*sk*d operations (two logits-sized
// products and the dq product), against reading q, dO, lse, delta once and
// k, v, bias once per query tile.
//
// bfloat16 (the training path) and float16 (the same body over __half,
// for amp.auto_cast(dtype="float16"): f16 wgmma, ds rounded to f16 where
// the bf16 instance rounds it to bf16, float32 accumulators; an unscaled
// loss keeps ds far inside f16's range, a GradScaler's scale may not, and
// the inf it then writes is what the scaler's check is for): the three products run on the tensor
// cores (bf16 wgmma, 989 TFLOP/s), so the exp, the masks and the dropout
// hash on the CUDA cores are the other half of the work. One warpgroup
// (128 threads) per (query tile of 64 rows, b*h). The tile's q and dO stay
// in swizzled shared memory, its lse, delta and ids in registers; k, v,
// the key bias and ids stream in 64-key tiles through a ring of three
// buffers, cp.async filling the next tile's under this tile's work.
// Per key tile: S = Q.K^T and dP = dO.V^T by wgmma from shared memory
// into fp32 registers; p, the dropout and ds = p * (dp - delta) in those
// registers; round(ds) packed straight into the A registers of
// dQ += dS.K (B = the same k tile read MN-major), which runs on under the
// next tile's copies and S. When the scale is a
// power of two (d = 64: 0.125), round(q * scale) = q * scale exactly, so
// the raw tiles feed the products and the scale multiplies the fp32
// results; any other scale stages round(q * scale) in place once and
// round(k * scale) per tile.
// float32 keeps the SIMT kernel below: tiles in shared memory as fp32
// with padded rows, every product an fmaf on the CUDA cores (67 TFLOP/s),
// each thread 4 rows x 8 key columns of p / dp and 4 rows x d/8 columns
// of dq, ds through shared memory to the dq product; it matches the plain
// version's float32 sums exactly on the ERNIE shapes.

#include <math.h>

#include "flash_mma.cuh"
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // q, dO, k, round(k*scale), v tiles [64][D + 1], ds tile [64][BK + 1],
  // bias tile [BK]; as int: the key tile's segment ids [BK] and the
  // segment range [2]
  return 5 * 64 * (D + 1) + BQ * (BK + 1) + BK + BK + 2;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg,
                    const float* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int sq, int sk, int d, Strides4 st,
                    float scale, int causal, Dropout dr) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int OPT = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;               // round(q * scale)
  float* gs = qs + BQ * LD;       // dO
  float* ks = gs + BQ * LD;       // k
  float* kbs = ks + BK * LD;      // round(k * scale)
  float* vs = kbs + BK * LD;      // v
  float* dss = vs + BK * LD;      // round(ds)
  float* bs = dss + BQ * LP;      // key bias
  int* kids = reinterpret_cast<int*>(bs + BK);  // key tile's segment ids
  int* seg_sh = kids + BK;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int off = sk - sq;
  const bool drop = dr.block_q > 0;

  const float* qp = q + b * st.v[0] + h * st.v[1];
  const float* kp = k + b * st.v[3] + h * st.v[4];
  const float* vp = v + b * st.v[6] + h * st.v[7];
  const float* gp = g + b * st.v[9] + h * st.v[10];
  const float* bp = bias ? bias + (long long)b * sk : nullptr;
  const int* qsp = qseg ? qseg + (long long)b * sq : nullptr;
  const int* ksp = kseg ? kseg + (long long)b * sk : nullptr;

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

  float lse_r[RPT], dl_r[RPT], acc[RPT][OPT];
  unsigned int row_key[RPT];
  int qid[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    const bool ok = row < sq;
    qid[i] = (qsp && ok) ? qsp[row] : 0;
    lse_r[i] = ok ? lse[(long long)bh * sq + row] : 0.f;
    dl_r[i] = ok ? delta[(long long)bh * sq + row] : 0.f;
    row_key[i] = drop ? drop_row_key(dr, bh, row) : 0u;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

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

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < sk && c < d) {
        kx = kp[(long long)(k0 + r) * st.v[5] + c];
        vx = vp[(long long)(k0 + r) * st.v[8] + c];
      }
      ks[r * LD + c] = kx;
      kbs[r * LD + c] = kx * scale;
      vs[r * LD + c] = vx;
    }
    if (tid < BK) {
      bs[tid] = (bp && k0 + tid < sk) ? bp[k0 + tid] : 0.f;
      kids[tid] = (ksp && k0 + tid < sk) ? ksp[k0 + tid] : 0;
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
      const int row = q0 + rg * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (ksp && qid[i] != kids[cg + 8 * j]) x = NEG;
        if (causal && col > row + off) x = NEG;
        const float p = (col < sk && row < sq) ? expf(x - lse_r[i]) : 0.f;
        float dpv = dp[i][j];
        if (drop)
          dpv = drop_keep(dr, row_key[i], col) ? dpv * dr.inv_keep : 0.f;
        dss[(rg * RPT + i) * LP + cg + 8 * j] =
            p * (dpv - dl_r[i]);
      }
    }
    __syncwarp();                 // a row's ds is written by its own warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dv_[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dv_[i] = dss[(rg * RPT + i) * LP + j];
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const float kk = kbs[j * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dv_[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg * RPT + i;
    if (row >= sq) continue;
    float* op = dq + ((long long)bh * sq + row) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) op[col] = acc[i][c];
    }
  }
}

// ------------------------------------------------------- bf16 and f16

// dynamic shared memory of the wgmma kernel: q, dO, NS k and NS v tiles,
// round(k * scale) unless the scale is a power of two; per key tile (NS
// buffers) the bias, the ids and the dropout column keys; the segment
// range; 1 KiB to align the tiles to the swizzle's 1024 bytes
constexpr int NS = 3;             // key-tile buffers of the wgmma kernel

template <int D>
constexpr int mma_smem_bytes(bool pow2) {
  return (2 + 2 * NS + (pow2 ? 0 : 1)) * (D / 64) * mma::TILE_BYTES +
         3 * NS * BK * 4 + 16 + 1024;
}

template <int D, typename T>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma(const T* __restrict__ q,
                 const T* __restrict__ k,
                 const T* __restrict__ v,
                 const float* __restrict__ bias, const int* __restrict__ qseg,
                 const int* __restrict__ kseg,
                 const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 T* __restrict__ dq, int H, int sq, int sk, int d,
                 Strides4 st, float scale, int causal, Dropout dr, int vec,
                 int pow2) {
  using namespace mma;
  constexpr int TB = (D / 64) * TILE_BYTES;   // one tile of D columns
  constexpr int NB = D / 64;                  // 64-column blocks of dq
  constexpr int KS = D / 16;                  // reduction steps of S, dP
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                 // q, or round(q * scale)
  uint8_t* gs = qs + TB;              // dO
  uint8_t* ks = gs + TB;              // k, NS buffers
  uint8_t* vs = ks + NS * TB;         // v, NS buffers
  uint8_t* kt = vs + NS * TB;         // round(k * scale) (!pow2)
  float* bs = reinterpret_cast<float*>(kt + (pow2 ? 0 : TB));  // [NS][BK]
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
  const T* gp = g + b * st.v[9] + h * st.v[10];
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
  load_tile<D, T>(gs, gp, st.v[11], q0, sq, d, vec);
  if (nt > 0) fetch(0, 0);
  cp_async_commit();

  // this thread's two rows (accumulator rows frag_row(0) and + 8)
  float lse_r[2], dl_r[2];
  unsigned int rk[2];
  int qid[2], rows[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = q0 + frag_row(2 * x);
    const bool ok = row < sq;
    rows[x] = row;
    lse_r[x] = ok ? lse[(long long)bh * sq + row] : 0.f;
    dl_r[x] = ok ? delta[(long long)bh * sq + row] : 0.f;
    qid[x] = (qsp && ok) ? qsp[row] : 0;
    rk[x] = drop ? drop_row_key(dr, bh, row) : 0u;
  }

  // dq, set by the first tile's product (scale-d 0): zeros written here
  // would be register moves that ptxas finds beside a running product,
  // and it would then serialise every wgmma of the kernel (C7515)
  float acc[NB][32];

  // Per key tile t: S(t) and dP(t) are two wgmma groups, so p is computed
  // while dP(t) runs, and dQ(t) is left running into the next tile, under
  // its barrier and copies, until the wait for S(t + 1) retires it. Its k
  // tile (buffer t % NS) is refilled only at tile t + 2, after every warp
  // has waited for dQ(t) and passed that tile's barrier.
  for (int t = 0; t < nt; ++t) {
    const int buf = t % NS;
    const int k0 = kbeg + t * BK;
    cp_async_wait<0>();           // tile t (and q, dO) have landed
    fence_async_smem();
    __syncthreads();
    if (t + 1 < nt) fetch(t + 1, (t + 1) % NS);
    cp_async_commit();
    uint8_t* kb = ks + buf * TB;
    const uint8_t* kdq = kb;      // the B operand of the dq product
    if (!pow2) {                  // kt is read by dQ(t - 1): retire it
      wgmma_wait<0>();
      __syncthreads();
      if (t == 0) scale_tile<D, T>(qs, qs, scale);
      scale_tile<D, T>(kt, kb, scale);
      kdq = kt;
      fence_async_smem();
      __syncthreads();
    }

    float s[32], dp[32];
    wgmma_fence();
    wgmma_ss_k<KS, T>(s, qs, kb);
    wgmma_commit();
    wgmma_ss_k<KS, T>(dp, gs, vs + buf * TB);
    wgmma_commit();
    wgmma_wait<1>();              // dQ(t - 1) and S(t) are done
    fence_regs(s);

    const float* bt = bs + buf * BK;
    const int* kt_ids = kids + buf * BK;
    float p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      const int lc = frag_col(i);
      const int col = k0 + lc;
      float l = s[i] * s_scale + bt[lc];
      if (ksp && qid[x] != kt_ids[lc]) l = NEG;
      if (causal && col > rows[x] + off) l = NEG;
      p[i] = (col < sk && rows[x] < sq) ? expf(l - lse_r[x]) : 0.f;
    }
    wgmma_wait<0>();              // dP(t) is done
    fence_regs(dp);
    const unsigned int* ck = cks + buf * BK;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      float dpv = dp[i];
      if (drop)
        dpv = drop_keep_mixed(dr, rk[x] ^ ck[frag_col(i)]) ? dpv * dr.inv_keep
                                                           : 0.f;
      p[i] = p[i] * (dpv - dl_r[x]);  // ds
    }

    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a<T>(p, kk, a[kk]);
#pragma unroll
    for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        wgmma_rs<T>(acc[n], a[kk], desc(kdq, mn_major_step(kk, n)),
                    t > 0 || kk > 0);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
  cp_async_wait<0>();

  const float o_scale = pow2 ? scale : 1.f;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = rows[(i >> 1) & 1];
      const int col = 64 * n + frag_col(i);
      if (row >= sq || col >= d) continue;
      T* op = dq + ((long long)bh * sq + row) * d + col;
      op[0] = Half16<T>::from(nt > 0 ? acc[n][i] * o_scale : 0.f);
      if (col + 1 < d)
        op[1] = Half16<T>::from(nt > 0 ? acc[n][i + 1] * o_scale : 0.f);
    }
}

template <typename T>
int launch_mma(const void* q, const void* k, const void* v,
               const void* bias, const void* qseg, const void* kseg,
               const void* g, const void* lse, const void* delta, void* dq,
               int B, int H, int sq, int sk, int d, const Strides4& st,
               float scale, int causal, Dropout dr, int vec, int pow2,
               cudaStream_t stream) {
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
        static_cast<const int*>(kseg), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), H, sq, sk, d, st, scale, causal, dr,
        vec, pow2);
    return (int)cudaGetLastError();
  };
  return d <= 64 ? run(flash_bwd_dq_mma<64, T>, mma_smem_bytes<64>(pow2))
                 : run(flash_bwd_dq_mma<128, T>, mma_smem_bytes<128>(pow2));
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* qseg, const void* kseg, const void* g,
           const void* lse, const void* delta, void* dq,
           int B, int H, int sq, int sk, int d, const Strides4& st,
           float scale, int causal, Dropout dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg),
      static_cast<const float*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), H, sq, sk, d,
      st, scale, causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the bf16 kernels of this library and of flash_bwd_dkv.cu copy
// the tiles of these four views (q, k, v, dO; strides as in
// pt_flash_bwd_dq) by 16-byte cp.async (1) or element by element (0):
// the one rule the entry points apply, asked by the wrapper to count the
// element-copy launches.
extern "C" int pt_flash_bwd_vector_loads(const void* q, const void* k,
                                         const void* v, const void* g,
                                         const long long* strides, int d) {
  const void* views[4] = {q, k, v, g};
  return mma::vector_loads(views, strides, d);
}

// C entry point, bound with ctypes. dtype: 0 = float32 (the SIMT kernel),
// 1 = bfloat16, 2 = float16 (the wgmma kernel's two instances). q / dO [B, H, sq, d], k / v
// [B, H, sk, d] with unit stride on d and element strides (batch, head,
// row) in `strides` (q, k, v, dO: 12 values, host memory); bias [B, sk]
// float32 or null; qseg / kseg as in pt_flash_fwd; lse and delta
// [B * H, sq] float32; dq [B, H, sq, d] contiguous. Dropout as in pt_flash_fwd (block_q = 0: none). Returns the
// cudaError_t of the launch.
extern "C" int pt_flash_bwd_dq(int device, int dtype, const void* q,
                               const void* k, const void* v,
                               const void* bias, const void* qseg,
                               const void* kseg, const void* g,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int sq, int sk, int d,
                               const long long* strides, float scale,
                               int causal, unsigned int seed,
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
                                    dq, B, H, sq, sk, d, st, scale, causal,
                                    dr, vec, pow2, s)
        : launch_mma<__half>(q, k, v, bias, qseg, kseg, g, lse, delta, dq, B,
                             H, sq, sk, d, st, scale, causal, dr, vec, pow2,
                             s);
  }
  return d <= 64
      ? launch<64>(q, k, v, bias, qseg, kseg, g, lse, delta, dq, B, H,
                          sq, sk, d, st, scale, causal, dr, s)
      : launch<128>(q, k, v, bias, qseg, kseg, g, lse, delta, dq, B, H,
                           sq, sk, d, st, scale, causal, dr, s);
}
