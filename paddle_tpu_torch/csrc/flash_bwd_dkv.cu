// Flash-attention backward, dK / dV (and the key-bias gradient), for Hopper
// (sm_90a).
//
// Replaces: paddle_tpu/ops/attention.py `dkv_kernel` inside
// `flash_attention_bwd` (the Pallas dK/dV kernel, grid (b*h, key block),
// looping over query blocks). Same math per (query row, key):
//   qbs      = round(q * scale)     (the forward's folded query; it is
//                                    also the s*q that dk needs)
//   logits   = qbs . k + bias, causal keys (end-aligned) -1e30
//   p        = exp(logits - lse)
//   dp       = dO . v;  with dropout pd = D(p), dp = D(dp), where D drops
//              and upscales with the forward's keep bits
//   dlogits  = p * (dp - delta)
//   dv      += round(pd)^T . dO
//   dk      += round(dlogits)^T . qbs
//   dbias   += sum over rows of dlogits   (per b*h; the wrapper sums heads)
// "round" is a cast to the operand type, as in the TPU kernel.
// Differences from the TPU kernel, by design: end-aligned causal for any
// sq / sk (the query loop starts at the first tile that can see the key
// tile), ragged tails masked here, no block-divisibility gate; segment ids
// are not taken yet.
//
// What bounds it on an H100: 8 * b*h*sq*sk*d operations (two logits-sized
// products, dv and dk) on the CUDA cores in fp32 (67 TFLOP/s), against
// reading k, v, bias once and q, dO, lse, delta once per key tile. At the
// ERNIE shapes it is bound by the FMAs and their shared-memory operands.
// Design: one 128-thread block per (key tile of 64, b*h); the block keeps
// its k and v tiles and key bias for the whole query loop and stages
// round(q * scale), dO, lse and delta tile by tile (64 rows). For the two
// logits-sized products each thread owns 4 rows x 8 keys; round(pd) and
// dlogits then go through shared memory, where each thread reads them
// transposed for its 4 keys x d/8 columns of the dk and dv accumulators
// (and its 4 keys' dbias sums). wgmma/TMA are left for a later PR.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr int smem_floats() {
  // k, v, round(q*scale), dO tiles [64][D + 1]; round(pd), dlogits tiles
  // [64][BK + 1]; key bias [BK]; lse, delta [BQ]
  return 4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + BK + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ db, int H,
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

  const T* qp = q + b * st.v[0] + h * st.v[1];
  const T* kp = k + b * st.v[3] + h * st.v[4];
  const T* vp = v + b * st.v[6] + h * st.v[7];
  const T* gp = g + b * st.v[9] + h * st.v[10];

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < sk && c < d) {
      kx = to_f(kp[(long long)(k0 + r) * st.v[5] + c]);
      vx = to_f(vp[(long long)(k0 + r) * st.v[8] + c]);
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

  // first query tile that sees any key of this tile: row >= k0 - off
  int q_lo = 0;
  if (causal) q_lo = max(0, k0 - off) / BQ * BQ;

  for (int q0 = q_lo; q0 < sq; q0 += BQ) {
    __syncthreads();              // previous tile fully consumed
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float qx = 0.f, gx = 0.f;
      if (q0 + r < sq && c < d) {
        qx = round_to<T>(to_f(qp[(long long)(q0 + r) * st.v[2] + c]) * scale);
        gx = to_f(gp[(long long)(q0 + r) * st.v[11] + c]);
      }
      qs[r * LD + c] = qx;
      gs[r * LD + c] = gx;
    }
    if (tid < BQ) {
      const bool ok = q0 + tid < sq;
      ls[tid] = ok ? lse[(long long)bh * sq + q0 + tid] : 0.f;
      des[tid] = ok ? delta[(long long)bh * sq + q0 + tid] : 0.f;
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
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + cg + 8 * j;
        float x = s[i][j] + bs[cg + 8 * j];
        if (causal && col > row + off) x = NEG;
        const float p = (col < sk && row < sq) ? expf(x - lse_r) : 0.f;
        float pd = p, dpv = dp[i][j];
        if (drop) {
          const bool keep = drop_keep(dr, row_key, col);
          pd = keep ? p * dr.inv_keep : 0.f;
          dpv = keep ? dpv * dr.inv_keep : 0.f;
        }
        pds[lr * LP + cg + 8 * j] = round_to<T>(pd);
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
        lv[i] = round_to<T>(lv[i]);
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
    T* kop = dk + ((long long)bh * sk + key) * d;
    T* vop = dv + ((long long)bh * sk + key) * d;
#pragma unroll
    for (int c = 0; c < OPT; ++c) {
      const int col = cg + 8 * c;
      if (col < d) {
        kop[col] = from_f<T>(dk_acc[i][c]);
        vop[col] = from_f<T>(dv_acc[i][c]);
      }
    }
    if (db && cg == 0) db[(long long)bh * sk + key] = db_acc[i];
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* g, const void* lse, const void* delta, void* dk,
           void* dv, void* db, int B, int H, int sq, int sk, int d,
           const Strides4& st, float scale, int causal, Dropout dr,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(db), H, sq, sk, d, st, scale,
      causal, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Operands as in pt_flash_bwd_dq; dk / dv [B, H, sk, d] contiguous; db
// [B * H, sk] float32, or null when the key bias needs no gradient (or
// there is none). Returns the cudaError_t of the launch.
extern "C" int pt_flash_bwd_dkv(int device, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* bias, const void* g,
                                const void* lse, const void* delta, void* dk,
                                void* dv, void* db, int B, int H, int sq,
                                int sk, int d, const long long* strides,
                                float scale, int causal, unsigned int seed,
                                unsigned int thresh, float inv_keep,
                                int block_q, int block_k, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || (dtype != 0 && dtype != 1) || block_q < 0 ||
      block_k < 0 || (block_q > 0) != (block_k > 0))
    return (int)cudaErrorInvalidValue;
  const Dropout dr{seed, thresh, inv_keep, block_q, block_k};
  const Strides4 st = Strides4::from(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return dtype == 0
        ? launch<float, 64>(q, k, v, bias, g, lse, delta, dk, dv, db, B, H,
                            sq, sk, d, st, scale, causal, dr, s)
        : launch<__nv_bfloat16, 64>(q, k, v, bias, g, lse, delta, dk, dv,
                                    db, B, H, sq, sk, d, st, scale, causal,
                                    dr, s);
  return dtype == 0
      ? launch<float, 128>(q, k, v, bias, g, lse, delta, dk, dv, db, B, H,
                           sq, sk, d, st, scale, causal, dr, s)
      : launch<__nv_bfloat16, 128>(q, k, v, bias, g, lse, delta, dk, dv, db,
                                   B, H, sq, sk, d, st, scale, causal, dr,
                                   s);
}
