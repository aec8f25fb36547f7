// Split-K attention of a tile of R query rows against a KV cache, the key
// splits merged in the kernel, for Hopper (sm_90a): one launch writes the
// output in q's type. Four kernels instantiate it:
//  * flash_decode.cu: the dense decode (R 1, keys by (b, h, j) strides, the
//    dense kernels' rounding);
//  * flash_verify.cu: the dense verify (any T in tiles of R 1, 4 or 8 rows,
//    keys and rounding as the dense decode's);
//  * paged_decode.cu: the paged decode (R 1, keys through the page table);
//  * paged_verify.cu: the paged verify's split route (T <= 8, the
//    speculative step; R 4 or 8, keys through the page table).
//
// Query row t of a block of T sits at position n_valid - T + t (n_valid =
// the row's written keys after the block's write) and sees key j while
// j <= that position and j < L (T 1: the decode, keys below n_valid).
// Per visible key: x = (q * scale) . k (int8 k: (q . bytes) * k_scale),
// plus the optional [B, L] f32 key bias in logical positions; the softmax
// over the visible keys; p . v / sum(p). A row with no visible key writes
// 0, as the JAX combine's 1e-30 clamp gives. Keys no row of the tile sees
// are not read.
//
// Rounding (ROUND, the dense kernels): q * scale is rounded to q's type and
// p to it for p . v, while l sums the unrounded p; without ROUND (the paged
// kernels) q, K, V and p stay float32 after the dequant.
//
// What bounds it on an H100: device-memory bandwidth (each visible K / V
// row read once per tile of query rows, 4 R flops a key element against
// 2 to 8 bytes). Design:
//  * the key splits of a row (blockIdx.y = b * H + h, blockIdx.z a tile of
//    R query rows) are the blocks of a thread-block cluster (`plan`: about
//    TARGET_PER_SM blocks an SM, at most MAX_CLUSTER a row); a split is a
//    whole number of key tiles (dense) or pages (paged);
//  * key tiles of KT = 2048 / D keys go by 16-byte cp.async (element copies
//    where the views do not allow it) into a ring of STAGES tiles, the key
//    bias beside them, the next tile's copies under this tile's arithmetic
//    (two stages: a third holds the fp32 split route to 47 clusters of 7
//    at once on an H100, too few for 64 rows in one wave; PERF.md §6);
//    a paged block first resolves its pages' table entries and (page, head)
//    scales into shared memory, once a page, and never reads through a -1;
//  * the block's 16 groups of 8 lanes each take every 16th key of a tile
//    (a lane holds d / 8 elements of each row: float4 reads from shared
//    memory, bf16 and int8 widened there), reduce the R dot products with
//    three shuffles and keep R online softmaxes (m, l, acc) in registers,
//    one step a row for a group's visible keys of a tile;
//  * the groups' partials merge in group order in shared memory, and the
//    blocks' (the key splits') in rank order through distributed shared
//    memory: no partials in device memory, no second launch, the same bits
//    on every run. A split with no key visible to a row gives that row
//    (m -1e30, l 0, acc 0), which weighs nothing beside a visible key.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace amerge {

namespace cg = cooperative_groups;

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr int LANES = 8;                    // lanes a key
constexpr int GROUPS = THREADS / LANES;     // keys in flight a block
constexpr int STAGES = 2;                   // the cp.async ring
constexpr int MAX_CLUSTER = 8;              // key splits a row, portable
constexpr int TARGET_PER_SM = 3;            // blocks an SM the plan aims for
constexpr int UNIT = 32;                    // keys: the dense plan's step,
                                            // whole tiles at every width

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(signed char x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// value as it is after a cast to the operand type (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Keys a tile: 32 at d <= 64, 16 at d <= 128 (8 KB of float32 K a tile).
template <int D>
struct Tile {
  static constexpr int KT = 2048 / D;
  static constexpr int KPG = KT / GROUPS;   // keys a group a tile
  static constexpr int E = D / 32;          // float4 slices a lane
};

// Whether `split` key splits of n units is a plan the kernels take: a
// portable cluster (1..MAX_CLUSTER blocks) with at least one unit a split.
inline bool legal_split(int split, int n) {
  return split >= 1 && split <= MAX_CLUSTER && split <= n;
}

// (blocks a cluster = key splits, units a split) of `rows` rows over n
// units (pages, or UNIT-key steps) on `sms` SMs: about TARGET_PER_SM
// blocks an SM, at most MAX_CLUSTER splits and one unit a split. A legal
// `tuned` (the tuning table's split_k) replaces the rule's split; 0, or an
// illegal value, keeps the rule.
inline void plan(int sms, int rows, int n, int* c, int* per, int tuned) {
  const int want = (TARGET_PER_SM * sms + max(rows, 1) - 1) / max(rows, 1);
  const int split = legal_split(tuned, n)
                        ? tuned
                        : max(1, min(min(MAX_CLUSTER, n), want));
  *per = (n + split - 1) / split;
  *c = (n + *per - 1) / *per;
}

// The dense kernels' plan (flash_decode.cu, flash_verify.cu): `rows` rows
// over L keys in whole UNIT-key steps; (blocks a cluster, keys a split).
inline void dense_plan(int sms, int rows, int L, int* c, int* keys,
                       int tuned) {
  int per = 0;
  plan(sms, rows, (L + UNIT - 1) / UNIT, c, &per, tuned);
  *keys = per * UNIT;
}

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;           // paged: [n_rows, H] scales, or null
  const float* vs;
  const int* table;          // paged: [B, mp] int32
  const int* lengths;        // [B] written keys (after a block's write)
  const float* bias;         // [B, L] float32, or null
  void* out;                 // [B, H, T, d], q's type, contiguous
  int H, T, L, d, split, vec;
  int mp, psz, n_rows;       // paged
  // element strides: q (batch, head, row); K and V (batch for dense keys,
  // page for paged keys; head; row)
  long long qsb, qsh, qst, kb, kh, kr, vb, vh, vr;
  float scale;
};

// elements i .. i + 3 of a key row in shared memory, as float32 (int8
// bytes by the magic-number add: 2^23 + v + 128 minus 2^23 + 128 is v)
__device__ __forceinline__ void load4(const float* row, int i, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(row + i);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* row, int i,
                                      float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(row + i);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xFFFF0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(const signed char* row, int i,
                                      float (&o)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + i) ^
                     0x80808080u;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    o[u] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | u)) -
           8388736.f;
}

// Key rows of a dense cache k / v [B, H, L, d].
template <typename TKV>
struct DenseKeys {
  static constexpr bool SCALED = false;
  const TKV* kp;
  const TKV* vp;
  long long kr, vr;

  static int tail_bytes(const Args&) { return 0; }
  __device__ __forceinline__ void bind(const Args& a, int b, int h, int,
                                       unsigned char*, int) {
    kp = static_cast<const TKV*>(a.k) + b * a.kb + h * a.kh;
    vp = static_cast<const TKV*>(a.v) + b * a.vb + h * a.vh;
    kr = a.kr;
    vr = a.vr;
  }
  __device__ __forceinline__ const TKV* krow(int j) const {
    return kp + j * kr;
  }
  __device__ __forceinline__ const TKV* vrow(int j) const {
    return vp + j * vr;
  }
  __device__ __forceinline__ float kscale(int) const { return 1.f; }
  __device__ __forceinline__ float vscale(int) const { return 1.f; }
};

// Key rows read through a page table: pages [n_rows, H, psz, d] (row
// n_rows - 1 is the trash page; a table entry outside [0, n_rows) reads
// it), int8 pages dequantized by [n_rows, H] scales. A split is a run of
// whole pages; `bind` resolves their rows and scales into shared memory.
template <typename TKV>
struct PagedKeys {
  static constexpr bool SCALED = true;
  const TKV* kbase;
  const TKV* vbase;
  const long long* koff;      // per page of the split: element offsets of
  const long long* voff;      // its (page, head) rows of K and V,
  const float* ksc;           // then its k and v scales
  const float* vsc;
  long long kr, vr;
  int p0, psz, psh;

  static int tail_bytes(const Args& a) { return 24 * (a.split / a.psz); }
  __device__ __forceinline__ void bind(const Args& a, int b, int h,
                                       int start, unsigned char* tail,
                                       int tid) {
    const int pps = a.split / a.psz;
    long long* ko = reinterpret_cast<long long*>(tail);
    long long* vo = ko + pps;
    float* ks = reinterpret_cast<float*>(vo + pps);
    float* vs = ks + pps;
    kbase = static_cast<const TKV*>(a.k);
    vbase = static_cast<const TKV*>(a.v);
    koff = ko;
    voff = vo;
    ksc = ks;
    vsc = vs;
    kr = a.kr;
    vr = a.vr;
    psz = a.psz;
    psh = (psz & (psz - 1)) == 0 ? __ffs(psz) - 1 : -1;
    p0 = start / psz;
    const int np = min(pps, a.mp - p0);
    for (int i = tid; i < np; i += THREADS) {
      int p = a.table[(long long)b * a.mp + p0 + i];
      if (p < 0 || p >= a.n_rows) p = a.n_rows - 1;
      ko[i] = p * a.kb + h * a.kh;
      vo[i] = p * a.vb + h * a.vh;
      ks[i] = a.ks ? a.ks[(long long)p * a.H + h] : 1.f;
      vs[i] = a.vs ? a.vs[(long long)p * a.H + h] : 1.f;
    }
  }
  // the page of key j (relative to the split's first) and its row: by a
  // shift for a power-of-two page size
  __device__ __forceinline__ int page(int j, int& r) const {
    const int lp = psh >= 0 ? j >> psh : j / psz;
    r = j - lp * psz;
    return lp - p0;
  }
  __device__ __forceinline__ const TKV* krow(int j) const {
    int r;
    const int lp = page(j, r);
    return kbase + koff[lp] + r * kr;
  }
  __device__ __forceinline__ const TKV* vrow(int j) const {
    int r;
    const int lp = page(j, r);
    return vbase + voff[lp] + r * vr;
  }
  __device__ __forceinline__ float kscale(int j) const {
    int r;
    return ksc[page(j, r)];
  }
  __device__ __forceinline__ float vscale(int j) const {
    int r;
    return vsc[page(j, r)];
  }
};

// The body of every kernel: block (rank blockIdx.x = key split, row
// blockIdx.y = b * H + h, query tile blockIdx.z) takes keys [rank * split,
// (rank + 1) * split) that a row of its tile sees. Group gi (lanes 8 gi ..
// 8 gi + 7) takes keys gi + 16 kk of each tile; lane s of a group holds
// elements 32 e + 4 s .. 32 e + 4 s + 3 of each row.
template <typename TQ, typename TKV, int D, int R, bool ROUND, class Keys>
__device__ __forceinline__ void attend(const Args& a) {
  using Tl = Tile<D>;
  constexpr int KT = Tl::KT, KPG = Tl::KPG, E = Tl::E;
  constexpr int ROWB = D * (int)sizeof(TKV);      // bytes a key row
  constexpr int STAGE = 2 * KT * ROWB + KT * 4;   // K, V, the bias
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, gi = tid / LANES, s = tid % LANES;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = blockIdx.z * R, rows = min(R, a.T - t0);
  const int qpos0 = a.lengths[b] - a.T + t0;      // position of row 0
  const int start = rank * a.split;
  // keys some row of the tile sees: j <= qpos0 + rows - 1, j < L
  const int end = min(min(start + a.split, a.L), qpos0 + rows);
  const int nt = end > start ? (end - start + KT - 1) / KT : 0;
  const int d = a.d;
  int lim[R];                                     // row i sees j < lim[i]
#pragma unroll
  for (int i = 0; i < R; ++i) lim[i] = i < rows ? min(end, qpos0 + i + 1)
                                                : start;
  Keys keys;
  keys.bind(a, b, h, start, smem + STAGES * STAGE, tid);
  if (d < D) {                            // the rows' tails stay zero
    for (int i = tid; i < STAGES * STAGE / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // 16-byte chunks a row: the tile's rows are whole chunks, the first
  // `chn` of them copied (all of them when d == D)
  constexpr int CH = ROWB / 16;
  const int chn = d * (int)sizeof(TKV) / 16;
  auto fetch = [&](int tile, int slot) {
    const int j0 = start + tile * KT;
    unsigned char* st = ring + slot * STAGE;
    if (a.vec) {
      // copy i of this thread: K or V (which), key kl, chunk c; every
      // divisor a power of two known at compile time
#pragma unroll
      for (int u = 0; u < 2 * KT * CH / THREADS; ++u) {
        const int i = tid + THREADS * u;
        const int which = i / (KT * CH), kl = (i / CH) % KT, c = i % CH;
        const int j = j0 + kl;
        if (j >= end || c >= chn) continue;
        const TKV* src = which ? keys.vrow(j) : keys.krow(j);
        hopper::cp_async16(st + (which * KT + kl) * ROWB + 16 * c,
                           reinterpret_cast<const unsigned char*>(src) +
                               16 * c, 16);
      }
    } else {
      for (int i = tid; i < 2 * KT * d; i += THREADS) {
        const int which = i / (KT * d), rem = i - which * KT * d;
        const int kl = rem / d, c = rem - kl * d;
        const int j = j0 + kl;
        if (j >= end) continue;
        const TKV* src = which ? keys.vrow(j) : keys.krow(j);
        reinterpret_cast<TKV*>(st + (which * KT + kl) * ROWB)[c] = src[c];
      }
    }
    if (a.bias && tid < KT && j0 + tid < end)
      hopper::cp_async4(st + 2 * KT * ROWB + 4 * tid,
                        a.bias + (long long)b * a.L + j0 + tid, 4);
  };

  // q . scale, this lane's elements of each row (zero past d and rows)
  float qv[R][E][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qsb + h * a.qsh +
                   (long long)(t0 + i) * a.qst;
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 32 * e + 4 * s + u;
        float x = 0.f;
        if (i < rows && c < d) {
          x = to_f(qp[c]) * a.scale;
          if (ROUND) x = round_to<TQ>(x);
        }
        qv[i][e][u] = x;
      }
  }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) fetch(t, t);
    hopper::cp_async_commit();
  }
  float mg[R], lg[R], acc[R][E][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mg[i] = -INFINITY;
    lg[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][e][u] = 0.f;
  }

  for (int tile = 0; tile < nt; ++tile) {
    hopper::cp_async_wait<STAGES - 2>();  // tile has landed
    __syncthreads();                      // ... for every thread
    if (tile + STAGES - 1 < nt)
      fetch(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const unsigned char* st = ring + (tile % STAGES) * STAGE;
    const float* bt = reinterpret_cast<const float*>(st + 2 * KT * ROWB);
    const int j0 = start + tile * KT;
    // this group's keys of the tile (gi + 16 kk): every q . k first, the
    // shuffles of all of them together, then one online-softmax step a row
    float x[R][KPG];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk) x[i][kk] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const TKV* kr =
          reinterpret_cast<const TKV*>(st + (gi + GROUPS * kk) * ROWB);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float kv[4];
        load4(kr, 32 * e + 4 * s, kv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            x[i][kk] = fmaf(qv[i][e][u], kv[u], x[i][kk]);
      }
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int kk = 0; kk < KPG; ++kk)
          x[i][kk] += __shfl_xor_sync(0xffffffffu, x[i][kk], o);
    if (j0 + gi >= end) continue;         // the same for the whole group
    // the tile's keys below `end` (a prefix of kk): int8 k = byte * scale,
    // so q . k = (q . bytes) * scale; then the bias
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const int kl = gi + GROUPS * kk;
      if (j0 + kl < end) {
        const float ksj = Keys::SCALED ? keys.kscale(j0 + kl) : 1.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (Keys::SCALED) x[i][kk] *= ksj;
          if (a.bias) x[i][kk] += bt[kl];
        }
      }
    }
    // each row's visible keys (a prefix of kk): one online-softmax step;
    // p = 0 for a key the row does not see
    float p[R][KPG];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk) p[i][kk] = 0.f;
      if (j0 + gi >= lim[i]) continue;    // the same for the whole group
      float m_new = mg[i];
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk)
        if (j0 + gi + GROUPS * kk < lim[i]) m_new = fmaxf(m_new, x[i][kk]);
      const float alpha = expf(mg[i] - m_new);
      lg[i] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][e][u] *= alpha;
      mg[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < KPG; ++kk) {
        if (j0 + gi + GROUPS * kk < lim[i]) {
          float pk = expf(x[i][kk] - m_new);
          lg[i] += pk;
          if (ROUND) pk = round_to<TQ>(pk);
          p[i][kk] = pk;
        }
      }
    }
    // p . v: each V row read once for every row of the tile
#pragma unroll
    for (int kk = 0; kk < KPG; ++kk) {
      const int kl = gi + GROUPS * kk;
      if (j0 + kl >= end) break;
      const float vsj = Keys::SCALED ? keys.vscale(j0 + kl) : 1.f;
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        pv[i] = Keys::SCALED ? p[i][kk] * vsj : p[i][kk];
      const TKV* vr = reinterpret_cast<const TKV*>(st + (KT + kl) * ROWB);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float vv[4];
        load4(vr, 32 * e + 4 * s, vv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[i][e][u] = fmaf(pv[i], vv[u], acc[i][e][u]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                        // the ring is free

  // the groups' partials [GROUPS][R][D], maxima and sums [GROUPS][R], the
  // groups' weights [R][GROUPS]; then the block's: out [R][D], (max, sum)
  // [R][2]
  float* wo = reinterpret_cast<float*>(smem);
  float* wm = wo + GROUPS * R * D;
  float* wl = wm + GROUPS * R;
  float* ww = wl + GROUPS * R;
  float* bo = ww + R * GROUPS;
  float* bml = bo + R * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      *reinterpret_cast<float4*>(wo + (gi * R + i) * D + 32 * e + 4 * s) =
          make_float4(acc[i][e][0], acc[i][e][1], acc[i][e][2],
                      acc[i][e][3]);
    if (s == 0) {
      wm[gi * R + i] = mg[i];
      wl[gi * R + i] = lg[i];
    }
  }
  __syncthreads();
  if (tid < R * GROUPS) {
    // row i's maximum over the groups (NEG where no key of the block is
    // visible to it: every weight is then 0), group g's weight
    const int i = tid / GROUPS, g = tid % GROUPS;
    float ms = -INFINITY;
#pragma unroll
    for (int g2 = 0; g2 < GROUPS; ++g2) ms = fmaxf(ms, wm[g2 * R + i]);
    if (ms == -INFINITY) ms = NEG;
    ww[i * GROUPS + g] = expf(wm[g * R + i] - ms);
    if (g == 0) bml[2 * i] = ms;
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(a.out) + ((long long)bh * a.T + t0) * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i >= rows) break;
    float den = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      den += wl[g * R + i] * ww[i * GROUPS + g];
    for (int c = tid; c < d; c += THREADS) {
      float num = 0.f;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
        num += wo[(g * R + i) * D + c] * ww[i * GROUPS + g];
      if (C == 1)
        out[i * d + c] = from_f<TQ>(num / fmaxf(den, 1e-30f));
      else
        bo[i * D + c] = num;
    }
    if (tid == 0) bml[2 * i + 1] = den;
  }
  if (C == 1) return;
  // rank `rank` finishes a slice of the rows * d outputs, merging the
  // ranks' partials in rank order through distributed shared memory
  cl.sync();
  const int total = rows * d;
  const int per = (total + C - 1) / C;
  const int c1 = min(total, (rank + 1) * per);
  for (int idx = rank * per + tid; idx < c1; idx += THREADS) {
    const int i = R == 1 ? 0 : idx / d, c = idx - i * d;
    // every rank's (max, sum, out) loaded first, then merged in order
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER], ro[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < C) {
        const float* rk = cl.map_shared_rank(bml, k);
        rm[k] = rk[2 * i];
        rl[k] = rk[2 * i + 1];
        ro[k] = cl.map_shared_rank(bo, k)[i * D + c];
      }
    }
    float mstar = -INFINITY;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < C) mstar = fmaxf(mstar, rm[k]);
    float num = 0.f, dsum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < C) {
        const float w = expf(rm[k] - mstar);
        dsum += rl[k] * w;
        num += ro[k] * w;
      }
    }
    out[i * d + c] = from_f<TQ>(num / fmaxf(dsum, 1e-30f));
  }
  cl.sync();                              // no rank leaves while read
}

// Dynamic shared memory of a block: the ring and the keys' tail, or the
// merge's buffers, whichever is larger.
template <typename TKV, int D, int R, class Keys>
int smem_bytes(const Args& a) {
  constexpr int KT = Tile<D>::KT;
  const int ring = STAGES * (2 * KT * D * (int)sizeof(TKV) + KT * 4) +
                   Keys::tail_bytes(a);
  const int merge = 4 * (GROUPS * R * D + 3 * GROUPS * R + R * D + 2 * R);
  return ring > merge ? ring : merge;
}

// Launch `kernel` over (C key splits, rows, query tiles), the C splits of
// a row one cluster.
template <class Kernel>
int launch(Kernel kernel, const Args& a, int bytes, int rows, int tiles,
           int C, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows, tiles);
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
}

// Whether 16-byte copies can take whole key rows of K / V (elements of
// esz bytes, element strides st[3..8] as below): d holds whole 16-byte
// chunks and every row of both views starts on 16 bytes.
inline bool vector_rows(const void* k, const void* v, int d, int esz,
                        const long long* st) {
  bool vec = (d * esz) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && (st[i] * esz) % 16 == 0;
  return vec;
}

// The arguments of a launch over dense keys: q [B, H, T, d], K / V with
// element strides st = (q batch, head, row; K batch, head, row; V batch,
// head, row), unit stride on d. A paged launch sets the page fields after
// it (the K / V batch strides then step pages).
inline Args dense_args(const void* q, const void* k, const void* v,
                       const void* lengths, const void* bias, void* out,
                       int H, int T, int L, int d, int esz, int split,
                       const long long* st, float scale) {
  const bool vec = vector_rows(k, v, d, esz, st);
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.H = H;
  a.T = T;
  a.L = L;
  a.d = d;
  a.split = split;
  a.vec = vec ? 1 : 0;
  a.qsb = st[0];
  a.qsh = st[1];
  a.qst = st[2];
  a.kb = st[3];
  a.kh = st[4];
  a.kr = st[5];
  a.vb = st[6];
  a.vh = st[7];
  a.vr = st[8];
  a.scale = scale;
  return a;
}

// ... over paged keys: pages [n_rows, H, psz, d], table [B, mp], scales
// [n_rows, H] or null; a split of pps pages.
inline Args paged_args(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* table,
                       const void* lengths, const void* bias, void* out,
                       int H, int T, int mp, int psz, int n_rows, int d,
                       int esz, int pps, const long long* st, float scale) {
  Args a = dense_args(q, k, v, lengths, bias, out, H, T, mp * psz, d, esz,
                      pps * psz, st, scale);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.mp = mp;
  a.psz = psz;
  a.n_rows = n_rows;
  return a;
}

}  // namespace amerge
