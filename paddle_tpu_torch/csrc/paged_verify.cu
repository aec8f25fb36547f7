// Paged flash verify for Hopper (sm_90a): T query tokens per (slot, head)
// row, just written through the page table at the slot's own offset,
// against K/V read through the table, causal within the block, int8 pages
// dequantized in the kernel. Two routes, chosen by `pt_paged_verify_route`:
//
//  * split (T <= 8: the speculative verify step): paged_split_kernel, the
//    shared kernel body of attn_merge.cuh over paged keys at R = 4 or 8
//    query rows a block: whole key tiles through a cp.async ring, 16 keys
//    in flight a block, R online softmaxes a group, the key splits (runs
//    of whole pages, the paged decode's plan) merged over a cluster.
//  * tiled (T > 8: the tail prefill of a radix partial prefix hit,
//    `PagedLayout.pattach`, T = the tail's bucket, 16 to 512):
//    paged_tiled_kernel below.
// Both write the final [S, H, T, d] output in q's type: one launch a call.
//
// Replaces: paddle_tpu/ops/attention.py `_paged_flash_verify_call` (the
// Pallas block-table verify kernel, called from `paged_flash_verify`). Same
// math as paged_decode.cu with the verify mask: key j hidden from row i past
// position n_valid - T + i (-1e30), then the optional [S, L] f32 key bias.
// q, K, V and p stay float32 after the dequant (K = int8 * scale), as in the
// TPU kernel.
//
// What bounds the tiled route on an H100: float32 operations. A tail prefill
// of T rows over n keys does ~4 T n d flops (q.k and p.v) against 2 n d
// elements of K/V, far above the card's ~20 flop/byte fp32 ridge once T >= 16
// (phase 8 of chip_smoke.py: 1.75 GFLOP of visible pairs at S8 h8 T256).
// The split route's 8 lanes a key would reduce each q.k with shuffles for
// every one of up to 512 rows, so here:
//  * a 256-thread block owns (key split, slot * head, a tile of BQ = 16, 32
//    or 64 query rows) and walks only the keys its rows can see, in tiles of
//    BK = 64 keys (four 16-key pages), so each K/V row is fetched once per
//    BQ rows;
//  * each key tile's page rows are resolved from the table one tile ahead
//    and copied with 16-byte cp.async into a double-buffered shared-memory
//    ring (zero fill past the visible keys), the bias row and the int8
//    scales with them; int8 and bf16 pages are copied raw and dequantized
//    into a float32 tile when read;
//  * each thread computes a register micro-tile of S = Q.K^T (BQ/16 rows x 4
//    keys) with float32 FMAs from padded rows (no bank conflicts on the
//    16-byte reads), applies the mask and bias, and keeps an online softmax
//    for its rows (the -1e30 convention of attn_merge.cuh: a row whose keys
//    so far were all hidden gets zero weight once a visible key arrives);
//    P goes through shared memory into O += P.V, the same rows per thread;
//  * where one key split covers the keys (a grid that fills the card), the
//    block writes the normalised output; else (`plan`: about a block an
//    SM) each block writes its partial and the last block of a query tile to
//    arrive (an atomic count) merges the partials in split order, the same
//    arithmetic as the torch combine, so nothing runs after the kernel and
//    the result does not depend on the order the blocks ran in.
// No tensor cores: the serving contract keeps these products in float32.

#include "attn_merge.cuh"

namespace split {

using amerge::Args;
using amerge::PagedKeys;

template <typename TQ, typename TKV, int D, int R>
__global__ void __launch_bounds__(amerge::THREADS)
paged_split_kernel(const Args a) {
  amerge::attend<TQ, TKV, D, R, false, PagedKeys<TKV>>(a);
}

template <typename TQ, typename TKV, int D, int R>
int launch(const Args& a, int rows, int C, cudaStream_t s) {
  return amerge::launch(paged_split_kernel<TQ, TKV, D, R>, a,
                        amerge::smem_bytes<TKV, D, R, PagedKeys<TKV>>(a),
                        rows, (a.T + R - 1) / R, C, s);
}

// Query rows a block: 4 for T <= 4; 8 at d <= 64, else two tiles of 4 (a
// lane would hold 8 x 16 q and accumulator values at d 128).
template <typename TQ, typename TKV>
int by_rows(const Args& a, int rows, int C, cudaStream_t s) {
  if (a.d > 64) return launch<TQ, TKV, 128, 4>(a, rows, C, s);
  return a.T <= 4 ? launch<TQ, TKV, 64, 4>(a, rows, C, s)
                  : launch<TQ, TKV, 64, 8>(a, rows, C, s);
}

template <typename TQ>
int by_kv(int kvdtype, const Args& a, int rows, int C, cudaStream_t s) {
  switch (kvdtype) {
    case 0: return by_rows<TQ, float>(a, rows, C, s);
    case 1: return by_rows<TQ, __nv_bfloat16>(a, rows, C, s);
    default: return by_rows<TQ, signed char>(a, rows, C, s);
  }
}

}  // namespace split

namespace tiled {

using amerge::NEG;
using amerge::to_f;

constexpr int THREADS = 256;
constexpr int BK = 64;                  // keys per tile
constexpr int SPLIT_MAX_T = 8;          // T <= 8 stays on the split route
constexpr int BLOCKS_PER_SM = 1;        // the grid the plan aims for
constexpr int MAX_TILES_PER_SPLIT = 4;  // 256 keys: bounds the longest block
constexpr int MAX_SPLITS = 64;          // the merge keeps BQ x splits weights

// Shared memory of one block, in floats from the start (each region a
// multiple of 4 floats, so every row starts on 16 bytes): the scaled Q tile,
// the P tile, the float32 K and V tiles (two ring stages for float32 pages,
// one converted tile for bf16 / int8 pages), per stage the bias row and the
// k / v scales, three slots of page rows, then for bf16 / int8 pages the raw
// ring of two stages.
template <typename TKV, int D, int RI>
struct Layout {
  static constexpr int BQ = 16 * RI;
  static constexpr int DP = D + 4;       // float32 row stride, floats
  static constexpr int PP = BK + 4;      // P row stride, floats
  static constexpr bool F32 = sizeof(TKV) == 4;
  static constexpr int STAGE_F = F32 ? 2 : 1;
  // raw row stride, bytes (the float32 tile itself for float32 pages)
  static constexpr int RAW = F32 ? DP * 4 : D * (int)sizeof(TKV) + 16;
  static constexpr int Q = 0;
  static constexpr int P = Q + BQ * DP;
  static constexpr int KF = P + BQ * PP;
  static constexpr int VF = KF + STAGE_F * BK * DP;
  static constexpr int SC = VF + STAGE_F * BK * DP;   // [2][3][BK]
  static constexpr int PG = SC + 2 * 3 * BK;          // [3][BK] int
  static constexpr int RAWF = PG + 3 * BK;
  static constexpr int BYTES = 4 * RAWF + (F32 ? 0 : 2 * 2 * BK * RAW);
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  const float* bias;
  void* out;           // [S, H, T, d], q's type
  float* pacc;         // [S * H, ns, T, d] (ns > 1)
  float* pm;           // [S * H, ns, T]
  float* pl;
  int* counters;       // [S * H * ceil(T / BQ)], zeroed before the launch
  int H, T, mp, psz, n_rows, d, L, split, ns, vec;
  long long qsb, qsh, qst, kps, kph, kss, vps, vph, vss;
  float scale;
};

template <typename TQ, typename TKV, int D, int RI>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
paged_tiled_kernel(const Args a) {
  using Lay = Layout<TKV, D, RI>;
  constexpr int BQ = Lay::BQ, DP = Lay::DP, PP = Lay::PP;
  constexpr bool F32 = Lay::F32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sf = reinterpret_cast<float*>(smem);
  float* Qs = sf + Lay::Q;
  float* Ps = sf + Lay::P;
  float* Kf = sf + Lay::KF;
  float* Vf = sf + Lay::VF;
  float* Sc = sf + Lay::SC;
  int* Pg = reinterpret_cast<int*>(sf + Lay::PG);
  unsigned char* rawk = F32 ? reinterpret_cast<unsigned char*>(Kf)
                            : smem + 4 * Lay::RAWF;
  unsigned char* rawv = F32 ? reinterpret_cast<unsigned char*>(Vf)
                            : rawk + 2 * BK * Lay::RAW;
  __shared__ int s_last;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int si = blockIdx.x, bh = blockIdx.y, qt = blockIdx.z;
  const int b = bh / a.H, h = bh % a.H;
  const int T = a.T, d = a.d;
  const int t0 = qt * BQ;
  const int rows = min(BQ, T - t0);
  const int qpos0 = a.lengths[b] - T + t0;     // position of row 0
  const int end_all = min(a.L, qpos0 + rows);  // keys the tile can see
  const int start = si * a.split;
  const int end = min(start + a.split, end_all);
  TQ* out = static_cast<TQ*>(a.out);

  if (start < end) {
    const int* tb = a.table + (long long)b * a.mp;
    const float* bp = a.bias ? a.bias + (long long)b * a.L : nullptr;
    const TKV* kbase = static_cast<const TKV*>(a.k) + h * a.kph;
    const TKV* vbase = static_cast<const TKV*>(a.v) + h * a.vph;
    const int nt = (end - start + BK - 1) / BK;
    // the physical page row of key j (the trash row past the visible keys
    // or for an entry outside [0, n_rows))
    auto page_of = [&](int j) {
      int p = a.n_rows - 1;
      if (j < end) {
        const int e = tb[j / a.psz];
        if (e >= 0 && e < a.n_rows) p = e;
      }
      return p;
    };
    if (d < D)   // pad columns of the float32 K / V tiles must read zero
      for (int i = tid; i < Lay::SC - Lay::KF; i += THREADS)
        Kf[i] = 0.f;
    if (tid < BK) {
      Pg[tid] = page_of(start + tid);
      if (nt > 1) Pg[BK + tid] = page_of(start + BK + tid);
    }
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      float x = 0.f;
      if (r < rows && c < d)
        x = to_f(static_cast<const TQ*>(a.q)[b * a.qsb + h * a.qsh +
                                             (long long)(t0 + r) * a.qst +
                                             c]) * a.scale;
      Qs[r * DP + c] = x;
    }
    __syncthreads();

    // cp.async of key tile i into ring stage i & 1: K and V rows, the bias
    // row and (int8) the scales; rows past the visible keys zero-filled
    const int cpr = d * (int)sizeof(TKV) / 16;   // 16-byte chunks a row
    auto issue = [&](int i) {
      const int st = i & 1, kt = start + i * BK;
      const int* pg = Pg + (i % 3) * BK;
      unsigned char* dk = rawk + st * BK * Lay::RAW;
      unsigned char* dv = rawv + st * BK * Lay::RAW;
      for (int idx = tid; idx < BK * cpr; idx += THREADS) {
        const int r = idx / cpr, ch = idx - r * cpr, j = kt + r;
        const bool ok = j < end;
        const int p = pg[r], off = ok ? j % a.psz : 0;
        const TKV* ksrc = kbase + p * a.kps + off * a.kss;
        const TKV* vsrc = vbase + p * a.vps + off * a.vss;
        hopper::cp_async16(dk + r * Lay::RAW + ch * 16,
                           reinterpret_cast<const char*>(ksrc) + ch * 16,
                           ok ? 16 : 0);
        hopper::cp_async16(dv + r * Lay::RAW + ch * 16,
                           reinterpret_cast<const char*>(vsrc) + ch * 16,
                           ok ? 16 : 0);
      }
      float* sc = Sc + st * 3 * BK;
      if (tid < BK) {
        const int j = kt + tid;
        const bool ok = j < end && bp;   // else zero fill (from any
        //                                    valid address)
        hopper::cp_async4(sc + tid, ok ? bp + j : reinterpret_cast<const
                          float*>(a.lengths), ok ? 4 : 0);
      } else if (!F32 && a.ks && tid < 2 * BK) {
        const int r = tid - BK, p = pg[r];
        hopper::cp_async4(sc + BK + r, a.ks + (long long)p * a.H + h, 4);
        hopper::cp_async4(sc + 2 * BK + r, a.vs + (long long)p * a.H + h, 4);
      }
    };
    if (a.vec) issue(0);
    hopper::cp_async_commit();

    float o[RI][D / 64][4], m_run[RI], l_run[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      m_run[r] = -INFINITY;
      l_run[r] = 0.f;
#pragma unroll
      for (int e = 0; e < D / 64; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[r][e][u] = 0.f;
    }

    // one barrier a tile orders everything: tile i has landed and every
    // thread is done with tile i - 1 (its stage, P, the converted tiles),
    // so tile i + 1's copies go into the other stage while i is computed
    for (int i = 0; i < nt; ++i) {
      const int kt = start + i * BK, st = i & 1;
      int pnext = 0;
      if (i + 2 < nt && tid < BK) pnext = page_of(kt + 2 * BK + tid);
      hopper::cp_async_wait<0>();
      __syncthreads();
      if (a.vec && i + 1 < nt) issue(i + 1);
      hopper::cp_async_commit();

      const float* Kc = Kf;
      const float* Vc = Vf;
      const float* Bc = Sc + st * 3 * BK;
      if (a.vec) {
        if (F32) {
          Kc = Kf + st * BK * DP;
          Vc = Vf + st * BK * DP;
        } else {   // dequantize the raw stage into the float32 tiles
          const TKV* rk = reinterpret_cast<const TKV*>(rawk + st * BK *
                                                       Lay::RAW);
          const TKV* rv = reinterpret_cast<const TKV*>(rawv + st * BK *
                                                       Lay::RAW);
          constexpr int RS = Lay::RAW / (int)sizeof(TKV);
          for (int idx = tid; idx < BK * d; idx += THREADS) {
            const int r = idx / d, c = idx - r * d;
            const float ksc = a.ks ? Bc[BK + r] : 1.f;
            const float vsc = a.vs ? Bc[2 * BK + r] : 1.f;
            Kf[r * DP + c] = to_f(rk[r * RS + c]) * ksc;
            Vf[r * DP + c] = to_f(rv[r * RS + c]) * vsc;
          }
          __syncthreads();
        }
      } else {   // element loads (rows not on 16 bytes, or odd d)
        const int* pg = Pg + (i % 3) * BK;
        float* bc = Sc + st * 3 * BK;
        for (int idx = tid; idx < BK * d; idx += THREADS) {
          const int r = idx / d, c = idx - r * d, j = kt + r;
          float kx = 0.f, vx = 0.f;
          if (j < end) {
            const int p = pg[r], off = j % a.psz;
            kx = to_f(kbase[p * a.kps + off * a.kss + c]) *
                 (a.ks ? a.ks[(long long)p * a.H + h] : 1.f);
            vx = to_f(vbase[p * a.vps + off * a.vss + c]) *
                 (a.vs ? a.vs[(long long)p * a.H + h] : 1.f);
          }
          Kf[r * DP + c] = kx;
          Vf[r * DP + c] = vx;
        }
        if (tid < BK) {
          const int j = kt + tid;
          bc[tid] = (bp && j < end) ? bp[j] : 0.f;
        }
        __syncthreads();
      }

      // S = Q.K^T: rows ty + 16 r, keys tx + 16 u of the tile
      float s[RI][4];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r][u] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float4 qa[RI], kb[4];
#pragma unroll
        for (int r = 0; r < RI; ++r)
          qa[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * DP +
                                                   c);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          kb[u] = *reinterpret_cast<const float4*>(Kc + (tx + 16 * u) * DP +
                                                   c);
#pragma unroll
        for (int r = 0; r < RI; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float x = s[r][u];
            x = fmaf(qa[r].x, kb[u].x, x);
            x = fmaf(qa[r].y, kb[u].y, x);
            x = fmaf(qa[r].z, kb[u].z, x);
            x = fmaf(qa[r].w, kb[u].w, x);
            s[r][u] = x;
          }
      }

      // mask, bias, online softmax; p into the P tile
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int row = ty + 16 * r;
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jj = tx + 16 * u, j = kt + jj;
          float x = -INFINITY;            // past the visible keys: never
          if (j < end)                    // enters
            x = (j <= qpos0 + row ? s[r][u] : NEG) + Bc[jj];
          s[r][u] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[r], mx);   // finite: key kt visible
        const float alpha = expf(m_run[r] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = expf(s[r][u] - m_new);
          Ps[row * PP + tx + 16 * u] = p;
          ps += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[r] = l_run[r] * alpha + ps;
        m_run[r] = m_new;
#pragma unroll
        for (int e = 0; e < D / 64; ++e)
#pragma unroll
          for (int u = 0; u < 4; ++u) o[r][e][u] *= alpha;
      }
      __syncthreads();

      // O += P.V: rows ty + 16 r, columns 4 tx + 64 e .. + 3
      auto pv4 = [&](int k0) {
        float4 pa[RI];
#pragma unroll
        for (int r = 0; r < RI; ++r)
          pa[r] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * r) * PP +
                                                   k0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < D / 64; ++e) {
            const float4 vv = *reinterpret_cast<const float4*>(
                Vc + (k0 + kk) * DP + 4 * tx + 64 * e);
#pragma unroll
            for (int r = 0; r < RI; ++r) {
              const float p = kk == 0 ? pa[r].x : kk == 1 ? pa[r].y
                            : kk == 2 ? pa[r].z : pa[r].w;
              o[r][e][0] = fmaf(p, vv.x, o[r][e][0]);
              o[r][e][1] = fmaf(p, vv.y, o[r][e][1]);
              o[r][e][2] = fmaf(p, vv.z, o[r][e][2]);
              o[r][e][3] = fmaf(p, vv.w, o[r][e][3]);
            }
          }
      };
      const int kn = min(BK, end - kt);
      if (kn == BK) {
#pragma unroll 4
        for (int k0 = 0; k0 < BK; k0 += 4) pv4(k0);
      } else {
        for (int k0 = 0; k0 < kn; k0 += 4) pv4(k0);
      }
      if (i + 2 < nt && tid < BK) Pg[((i + 2) % 3) * BK + tid] = pnext;
    }
    __syncthreads();

    // the output (one split), else this split's partial
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int row = ty + 16 * r, t = t0 + row;
      if (row >= rows) continue;
      const long long base = a.ns == 1
          ? ((long long)bh * T + t) * d
          : (((long long)bh * a.ns + si) * T + t) * d;
      const float den = fmaxf(l_run[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < D / 64; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = 4 * tx + 64 * e + u;
          if (c >= d) continue;
          if (a.ns == 1)
            out[base + c] = amerge::from_f<TQ>(o[r][e][u] / den);
          else
            a.pacc[base + c] = o[r][e][u];
        }
      if (a.ns > 1 && tx == 0) {
        const long long mi = ((long long)bh * a.ns + si) * T + t;
        a.pm[mi] = m_run[r];
        a.pl[mi] = l_run[r];
      }
    }
    if (a.ns == 1) return;
  } else if (a.ns == 1) {
    // no key visible to the tile: the combine of exact-zero partials
    for (int i = tid; i < rows * d; i += THREADS)
      out[((long long)bh * T + t0) * d + i] = amerge::from_f<TQ>(0.f);
    return;
  }

  // the last block of this query tile to arrive merges the partials of
  // the splits that hold keys the tile can see, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(a.counters + (long long)bh * gridDim.z + qt, 1) ==
             a.ns - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int nse = end_all > 0
      ? min(a.ns, (end_all + a.split - 1) / a.split) : 0;
  float* al = Ps;   // [rows][nse] weights exp(m - m_star)
  float* dn = Qs;   // [rows] denominators
  if (tid < rows) {
    const long long mi = (long long)bh * a.ns * T + t0 + tid;
    float ms = -INFINITY;
    for (int k = 0; k < nse; ++k) ms = fmaxf(ms, __ldcg(a.pm + mi + k * T));
    float den = 0.f;
    for (int k = 0; k < nse; ++k) {
      const float w = expf(__ldcg(a.pm + mi + k * T) - ms);
      al[tid * MAX_SPLITS + k] = w;
      den += __ldcg(a.pl + mi + k * T) * w;
    }
    dn[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < rows * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    float num = 0.f;
    for (int k = 0; k < nse; ++k)
      num += __ldcg(a.pacc + (((long long)bh * a.ns + k) * T + t0 + r) * d +
                    c) * al[r * MAX_SPLITS + k];
    out[((long long)bh * T + t0 + r) * d + c] =
        amerge::from_f<TQ>(num / dn[r]);
  }
}

struct Plan {
  int ri, ns, split;
};

// Query tile and key splits: BQ = 16 RI rows (64 for T > 32, fewer for a
// short block or a grid too small to fill the card), then enough splits of
// whole key tiles for about BLOCKS_PER_SM blocks an SM (rounded to fewer,
// longer splits) and at most MAX_TILES_PER_SPLIT tiles a split (the longest
// rows bound the kernel). The constants were chosen on the card
// (PERF.md §6): two blocks an SM, or splits of 8 tiles, were slower
// at the tail prefills. A legal `tuned` (the tuning table's
// tiles_per_split: 1..tiles, at most MAX_SPLITS splits) replaces the
// rule's tiles a split; 0, or an illegal value, keeps the rule.
inline Plan plan(int sms, int S, int H, int T, int L, int tuned) {
  const int tiles = max(1, (L + BK - 1) / BK);
  const long long target = (long long)BLOCKS_PER_SM * sms;
  int ri = T <= 16 ? 1 : T <= 32 ? 2 : 4;
  auto base = [&](int r) {
    return (long long)S * H * ((T + 16 * r - 1) / (16 * r));
  };
  while (ri > 1 && base(ri) * min(tiles, MAX_SPLITS) < target) ri /= 2;
  const long long bq = max(1LL, base(ri));
  long long want = max((target + bq - 1) / bq,
                       (long long)(tiles + MAX_TILES_PER_SPLIT - 1) /
                           MAX_TILES_PER_SPLIT);
  want = min(want, (long long)min(tiles, MAX_SPLITS));
  const bool legal = tuned >= 1 && tuned <= tiles &&
                     (tiles + tuned - 1) / tuned <= MAX_SPLITS;
  const int tps = legal ? tuned : (tiles + (int)want - 1) / (int)want;
  return {ri, (tiles + tps - 1) / tps, tps * BK};
}

template <typename TQ, typename TKV, int D, int RI>
int launch(const Args& a, int S, const Plan& p, cudaStream_t stream) {
  const int bytes = Layout<TKV, D, RI>::BYTES;
  auto kernel = paged_tiled_kernel<TQ, TKV, D, RI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.ns, S * a.H, (a.T + 16 * RI - 1) / (16 * RI));
  kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
int by_rows(const Args& a, int S, const Plan& p, cudaStream_t stream) {
  switch (p.ri) {
    case 1: return launch<TQ, TKV, D, 1>(a, S, p, stream);
    case 2: return launch<TQ, TKV, D, 2>(a, S, p, stream);
    default: return launch<TQ, TKV, D, 4>(a, S, p, stream);
  }
}

template <typename TQ, typename TKV>
int by_width(const Args& a, int S, const Plan& p, cudaStream_t stream) {
  return a.d <= 64 ? by_rows<TQ, TKV, 64>(a, S, p, stream)
                   : by_rows<TQ, TKV, 128>(a, S, p, stream);
}

template <typename TQ>
int by_kv(int kvdtype, const Args& a, int S, const Plan& p,
          cudaStream_t stream) {
  switch (kvdtype) {
    case 0: return by_width<TQ, float>(a, S, p, stream);
    case 1: return by_width<TQ, __nv_bfloat16>(a, S, p, stream);
    default: return by_width<TQ, signed char>(a, S, p, stream);
  }
}

}  // namespace tiled

// The route rule: 1 = the tiled kernel (T > 8, tail prefills), 0 = the
// split kernel (decode widths and the speculative verify step).
extern "C" int pt_paged_verify_route(int T, int d) {
  return T > tiled::SPLIT_MAX_T && d >= 1 && d <= 128;
}

// The tiled route's plan for S slots, H heads, T rows and L = mp * psz
// keys on `device`: out = (query rows a block, key splits, keys a split),
// tiles_per_split the plan's override (0 = the rule). The wrapper sizes
// the partials (splits > 1) and the counters by it.
extern "C" int pt_paged_verify_plan(int device, int S, int H, int T, int L,
                                    int tiles_per_split, int* out) {
  const tiled::Plan p = tiled::plan(amerge::sm_count(device), S, H, T, L,
                                    tiles_per_split);
  out[0] = 16 * p.ri;
  out[1] = p.ns;
  out[2] = p.split;
  return 0;
}

// C entry point, bound with ctypes. qdtype: 0 = float32, 1 = bfloat16;
// kvdtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale / v_scale then
// required). q [S, H, T, d]; pages [n_rows, H, psz, d], each with unit
// stride on d; `strides` holds (q slot, q head, q row, k page, k head, k
// row, v page, v head, v row) in elements. scales [n_rows, H, 1, 1]
// float32; table [S, mp] int32 (entries outside [0, n_rows) read the trash
// row n_rows - 1); lengths [S] int32 written counts (after the T-token
// write); bias [S, mp * psz] float32 or null. out [S, H, T, d] contiguous,
// q's type: the final output on both routes (`pt_paged_verify_route`).
// The split route's key splits are `pt_paged_decode_plan`'s (the same
// rule, `amerge::plan` over S * H rows and mp pages); acc, m, l and
// counters unused. The tiled route with its plan's splits > 1 keeps its
// partials in acc [S * H, splits, T, d], m and l [S * H, splits, T]
// (float32) and counters [S * H * ceil(T / rows)] int32 (zeroed here).
// split_k overrides the split route's plan, tiles_per_split the tiled
// route's (0 = the rule; the wrapper sizes the partials by the same
// override). Returns the launch's cudaError_t.
extern "C" int pt_paged_verify(int device, int qdtype, int kvdtype,
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, const void* bias, void* acc, void* m, void* l,
    void* out, void* counters, int S, int H, int T, int mp, int psz,
    int n_rows, int d, const long long* strides, float scale, int split_k,
    int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || T < 1 || psz < 1 || mp < 1 || n_rows < 1 ||
      H < 1 || S < 0 || (qdtype != 0 && qdtype != 1) || kvdtype < 0 ||
      kvdtype > 2 || (kvdtype == 2 && (!k_scale || !v_scale)) || !out)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int elt = kvdtype == 0 ? 4 : kvdtype == 1 ? 2 : 1;
  if (!pt_paged_verify_route(T, d)) {
    if ((long long)S * H > 65535) return (int)cudaErrorInvalidValue;
    int C = 0, pps = 0;
    amerge::plan(amerge::sm_count(device), S * H, mp, &C, &pps, split_k);
    const amerge::Args a = amerge::paged_args(
        q, k_pages, v_pages, k_scale, v_scale, table, lengths, bias, out, H,
        T, mp, psz, n_rows, d, elt, pps, strides, scale);
    return qdtype == 0 ? split::by_kv<float>(kvdtype, a, S * H, C, st)
                       : split::by_kv<__nv_bfloat16>(kvdtype, a, S * H, C,
                                                     st);
  }
  const int L = mp * psz;
  const tiled::Plan p = tiled::plan(amerge::sm_count(device), S, H, T, L,
                                    tiles_per_split);
  const int nqt = (T + 16 * p.ri - 1) / (16 * p.ri);
  if (p.ns > 1) {
    if (!acc || !m || !l || !counters) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(counters, 0, sizeof(int) * (size_t)S * H * nqt,
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = amerge::vector_rows(k_pages, v_pages, d, elt, strides);
  tiled::Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(table),
                static_cast<const int*>(lengths),
                static_cast<const float*>(bias), out,
                static_cast<float*>(acc), static_cast<float*>(m),
                static_cast<float*>(l), static_cast<int*>(counters), H, T,
                mp, psz, n_rows, d, L, p.split, p.ns, vec ? 1 : 0,
                strides[0], strides[1], strides[2], strides[3], strides[4],
                strides[5], strides[6], strides[7], strides[8], scale};
  return qdtype == 0 ? tiled::by_kv<float>(kvdtype, a, S, p, st)
                     : tiled::by_kv<__nv_bfloat16>(kvdtype, a, S, p, st);
}
