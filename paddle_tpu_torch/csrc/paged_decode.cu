// Paged flash decode for Hopper (sm_90a): one query token per (slot, head)
// row against K/V read through a page table, with int8 pages dequantized in
// the kernel by per-(page, head) scales; the key splits are merged in the
// kernel, which writes the [S, H, 1, d] output in q's type.
//
// Replaces: paddle_tpu/ops/attention.py `_paged_flash_decode_call` (the
// Pallas block-table decode kernel, called from `paged_flash_decode`), the
// decode step of the paged serving pool. Same math: q, K, V and p in float32
// after the dequant (K = int8 * scale), logits = (q * scale) . k, keys at or
// past the slot's written length not read, then the [S, L] f32 key bias in
// logical positions (indexed by logical page, no table lookup); the softmax
// over the visible keys, p . v / sum(p). A slot with no written key gives 0,
// as the JAX combine's clamp does.
//
// Differences from the TPU kernel, by design: the TPU grid took one 16-key
// page per step and combined the per-page partials in XLA; here a thread-
// block cluster of C blocks owns a (slot, head) row, each block a run of
// whole pages (`plan`), and the blocks' partials are merged in the kernel.
// The table is read in the kernel (the TPU kernel took it by scalar
// prefetch); an unmapped (-1) or out-of-range entry reads the trash page,
// never through the -1.
//
// What bounds it on an H100: device-memory bandwidth (at S8 h8 and ~1k keys
// a row, 16 MB of float32 K/V against 4 flops a byte pair). Design:
//  * a block first resolves its pages' table entries and (page, head)
//    scales into shared memory, once a page; a page-head row of K or V
//    (psz x d elements) is contiguous, and its key rows are copied by
//    16-byte cp.async (element copies where the views do not allow it) into
//    a ring of STAGES tiles of KT keys, the key bias beside them, the next
//    tiles' copies under this tile's arithmetic;
//  * the block's 16 groups of 8 lanes each take every 16th key of the tile
//    (a lane holds d / 8 elements: float4 reads from shared memory, int8
//    and bf16 widened there), reduce their q . k with three shuffles and
//    keep their own online softmax (m, l, acc) in registers, one step for
//    a group's keys of a tile; keys past the split's visible range are
//    not read;
//  * the groups' partials merge in group order in shared memory, and the
//    blocks' (the key splits') in rank order through distributed shared
//    memory: no partials in device memory, no second launch, the same bits
//    on every run. A split with no visible key contributes (m -1e30, l 0,
//    acc 0), which weighs nothing beside a visible key, and a slot with no
//    visible key at all divides 0 by the clamp 1e-30.
// split_attn_kernel (split_attn.cuh) keeps the dense verify and the paged
// verify's speculative step.

#include <cooperative_groups.h>

#include "hopper_mma.cuh"
#include "split_attn.cuh"

namespace cg = cooperative_groups;

namespace pdec {

using split_attn::from_f;
using split_attn::NEG;
using split_attn::to_f;

constexpr int THREADS = 128;
constexpr int LANES = 8;                    // lanes a key
constexpr int GROUPS = THREADS / LANES;     // keys in flight a block
constexpr int STAGES = 3;                   // the cp.async ring
constexpr int MAX_CLUSTER = 8;              // key splits a row, portable
constexpr int TARGET_PER_SM = 3;            // blocks an SM the plan aims for

// Keys a tile: 32 at d <= 64, 16 at d <= 128 (8 KB of float32 K a tile).
template <int D>
struct Tile {
  static constexpr int KT = 2048 / D;
  static constexpr int KPG = KT / GROUPS;   // keys a group a tile
  static constexpr int E = D / 32;          // float4 slices a lane
};

// (blocks a cluster = key splits, pages a split) of S * H rows over mp
// pages on `sms` SMs: about TARGET_PER_SM blocks an SM, at most
// MAX_CLUSTER splits and one page a split.
inline void plan(int sms, int rows, int mp, int* c, int* pps) {
  const int want = (TARGET_PER_SM * sms + max(rows, 1) - 1) / max(rows, 1);
  const int split = max(1, min(min(MAX_CLUSTER, mp), want));
  *pps = (mp + split - 1) / split;
  *c = (mp + *pps - 1) / *pps;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  const float* bias;
  void* out;                 // [S, H, 1, d], q's type, contiguous
  int H, mp, psz, n_rows, d, L, pps, vec;
  long long qsb, qsh, kps, kph, kss, vps, vph, vss;
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

// Block (rank blockIdx.x = key split, row blockIdx.y = slot * H + head):
// keys [rank * pps * psz, (rank + 1) * pps * psz) below the slot's written
// length. Group gi (lanes 8 gi .. 8 gi + 7) takes keys gi + 16 kk of each
// tile; lane s of a group holds elements 32 e + 4 s .. 32 e + 4 s + 3.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const Args a) {
  using Tl = Tile<D>;
  constexpr int KT = Tl::KT, E = Tl::E;
  constexpr int ROWB = D * (int)sizeof(TKV);      // bytes a key row
  constexpr int STAGE = 2 * KT * ROWB + KT * 4;   // K, V, the bias
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  // per page of the split: the element offsets of its (page, head) rows of
  // K and V, then its k and v scales
  long long* koff = reinterpret_cast<long long*>(smem + STAGES * STAGE);
  long long* voff = koff + a.pps;
  float* ksc = reinterpret_cast<float*>(voff + a.pps);
  float* vsc = ksc + a.pps;
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, gi = tid / LANES, s = tid % LANES;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int p0 = rank * a.pps;
  const int np = min(a.pps, a.mp - p0);
  const int start = p0 * a.psz;
  const int end = min(min(start + np * a.psz, a.L), a.lengths[b]);
  const int nt = end > start ? (end - start + KT - 1) / KT : 0;
  const int d = a.d;
  // the page of key j (relative to the split's first) and its row: by a
  // shift for a power-of-two page size
  const int psh = (a.psz & (a.psz - 1)) == 0 ? __ffs(a.psz) - 1 : -1;
  auto page_of = [&](int j, int& r) {
    const int lp = psh >= 0 ? j >> psh : j / a.psz;
    r = j - lp * a.psz;
    return lp - p0;
  };

  // the pages of this split: rows (trash-clipped), offsets and scales
  for (int i = tid; i < np; i += THREADS) {
    int p = a.table[(long long)b * a.mp + p0 + i];
    if (p < 0 || p >= a.n_rows) p = a.n_rows - 1;
    koff[i] = p * a.kps + h * a.kph;
    voff[i] = p * a.vps + h * a.vph;
    ksc[i] = a.ks ? a.ks[(long long)p * a.H + h] : 1.f;
    vsc[i] = a.vs ? a.vs[(long long)p * a.H + h] : 1.f;
  }
  if (d < D) {                            // the rows' tails stay zero
    for (int i = tid; i < STAGES * STAGE / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const TKV* kbase = static_cast<const TKV*>(a.k);
  const TKV* vbase = static_cast<const TKV*>(a.v);
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
        int r;
        const int lp = page_of(j, r);
        const TKV* src = which ? vbase + voff[lp] + r * a.vss
                               : kbase + koff[lp] + r * a.kss;
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
        int r;
        const int lp = page_of(j, r);
        const TKV* src = which ? vbase + voff[lp] + r * a.vss
                               : kbase + koff[lp] + r * a.kss;
        reinterpret_cast<TKV*>(st + (which * KT + kl) * ROWB)[c] = src[c];
      }
    }
    if (a.bias && tid < KT && j0 + tid < end)
      hopper::cp_async4(st + 2 * KT * ROWB + 4 * tid,
                        a.bias + (long long)b * a.L + j0 + tid, 4);
  };

  // q . scale, this lane's elements (zero past d)
  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qsb + h * a.qsh;
  float qv[E][4];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 32 * e + 4 * s + u;
      qv[e][u] = c < d ? to_f(qp[c]) * a.scale : 0.f;
    }

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nt) fetch(t, t);
    hopper::cp_async_commit();
  }
  float mg = -INFINITY, lg = 0.f, acc[E][4];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[e][u] = 0.f;

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
    // shuffles of all of them together, then one online-softmax step
    float x[Tl::KPG];
#pragma unroll
    for (int kk = 0; kk < Tl::KPG; ++kk) {
      const TKV* kr =
          reinterpret_cast<const TKV*>(st + (gi + GROUPS * kk) * ROWB);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float kv[4];
        load4(kr, 32 * e + 4 * s, kv);
#pragma unroll
        for (int u = 0; u < 4; ++u) dot = fmaf(qv[e][u], kv[u], dot);
      }
      x[kk] = dot;
    }
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1)
#pragma unroll
      for (int kk = 0; kk < Tl::KPG; ++kk)
        x[kk] += __shfl_xor_sync(0xffffffffu, x[kk], o);
    if (j0 + gi >= end) continue;         // the same for the whole group
    // the visible keys (a prefix of kk): int8 k = byte * scale, so q . k
    // = (q . bytes) * scale; then the bias
    int lp[Tl::KPG];
    float m_new = mg;
#pragma unroll
    for (int kk = 0; kk < Tl::KPG; ++kk) {
      const int kl = gi + GROUPS * kk;
      if (j0 + kl < end) {
        int r;
        lp[kk] = page_of(j0 + kl, r);
        x[kk] *= ksc[lp[kk]];
        if (a.bias) x[kk] += bt[kl];
        m_new = fmaxf(m_new, x[kk]);
      }
    }
    const float alpha = expf(mg - m_new);
    lg *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[e][u] *= alpha;
    mg = m_new;
#pragma unroll
    for (int kk = 0; kk < Tl::KPG; ++kk) {
      const int kl = gi + GROUPS * kk;
      if (j0 + kl >= end) break;
      const float p = expf(x[kk] - m_new);
      lg += p;
      const float pv = p * vsc[lp[kk]];
      const TKV* vr = reinterpret_cast<const TKV*>(st + (KT + kl) * ROWB);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float vv[4];
        load4(vr, 32 * e + 4 * s, vv);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[e][u] = fmaf(pv, vv[u], acc[e][u]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                        // the ring is free

  // the groups' partials [GROUPS][D], max and sum [GROUPS]; then the
  // block's: out [D], max, sum
  float* wo = reinterpret_cast<float*>(smem);
  float* wm = wo + GROUPS * D;
  float* wl = wm + GROUPS;
  float* bo = wl + GROUPS;
  float* bml = bo + D;
#pragma unroll
  for (int e = 0; e < E; ++e)
    *reinterpret_cast<float4*>(wo + gi * D + 32 * e + 4 * s) =
        make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
  if (s == 0) {
    wm[gi] = mg;
    wl[gi] = lg;
  }
  __syncthreads();
  float ms = NEG, den = 0.f;
  if (nt > 0) {                           // a visible key: ms is finite
    ms = -INFINITY;
#pragma unroll
    for (int g2 = 0; g2 < GROUPS; ++g2) ms = fmaxf(ms, wm[g2]);
#pragma unroll
    for (int g2 = 0; g2 < GROUPS; ++g2) den += wl[g2] * expf(wm[g2] - ms);
  }
  TQ* out = static_cast<TQ*>(a.out) + (long long)bh * d;
  for (int c = tid; c < d; c += THREADS) {
    float num = 0.f;
    if (nt > 0) {
#pragma unroll
      for (int g2 = 0; g2 < GROUPS; ++g2)
        num += wo[g2 * D + c] * expf(wm[g2] - ms);
    }
    if (C == 1)
      out[c] = from_f<TQ>(num / fmaxf(den, 1e-30f));
    else
      bo[c] = num;
  }
  if (C == 1) return;
  if (tid == 0) {
    bml[0] = ms;
    bml[1] = den;
  }
  // rank `rank` finishes a slice of the d outputs, merging the ranks'
  // partials in rank order through distributed shared memory
  cl.sync();
  const int per = (d + C - 1) / C;
  const int c1 = min(d, (rank + 1) * per);
  for (int c = rank * per + tid; c < c1; c += THREADS) {
    // every rank's (max, sum, out[c]) loaded first, then merged in order
    float rm[MAX_CLUSTER], rl[MAX_CLUSTER], ro[MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < C) {
        const float* rk = cl.map_shared_rank(bml, k);
        rm[k] = rk[0];
        rl[k] = rk[1];
        ro[k] = cl.map_shared_rank(bo, k)[c];
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
    out[c] = from_f<TQ>(num / fmaxf(dsum, 1e-30f));
  }
  cl.sync();                              // no rank leaves while read
}

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

template <typename TQ, typename TKV, int D>
int launch(const Args& a, int rows, int C, cudaStream_t stream) {
  constexpr int KT = Tile<D>::KT;
  constexpr int STAGE = 2 * KT * D * (int)sizeof(TKV) + KT * 4;
  const int ring = STAGES * STAGE + 24 * a.pps;
  const int merge = 4 * (GROUPS * D + 2 * GROUPS + D + 2);
  const int bytes = ring > merge ? ring : merge;
  auto kernel = paged_decode_kernel<TQ, TKV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, rows);
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

template <typename TQ, typename TKV>
int by_width(const Args& a, int rows, int C, cudaStream_t s) {
  return a.d <= 64 ? launch<TQ, TKV, 64>(a, rows, C, s)
                   : launch<TQ, TKV, 128>(a, rows, C, s);
}

template <typename TQ>
int by_kv(int kvdtype, const Args& a, int rows, int C, cudaStream_t s) {
  switch (kvdtype) {
    case 0: return by_width<TQ, float>(a, rows, C, s);
    case 1: return by_width<TQ, __nv_bfloat16>(a, rows, C, s);
    default: return by_width<TQ, signed char>(a, rows, C, s);
  }
}

}  // namespace pdec

// The kernel's plan for S * H rows over mp pages on `device`: out[0] the
// blocks a cluster (key splits, merged in the kernel), out[1] the pages a
// split. `ops.attention.paged_decode_plan` writes the same rule out for
// the CPU.
extern "C" int pt_paged_decode_plan(int device, int S, int H, int mp,
                                    int* out) {
  if (S < 0 || H < 1 || mp < 1) return (int)cudaErrorInvalidValue;
  pdec::plan(pdec::sm_count(device), S * H, mp, out, out + 1);
  return 0;
}

// C entry point, bound with ctypes. qdtype: 0 = float32, 1 = bfloat16;
// kvdtype: 0 = float32, 1 = bfloat16, 2 = int8 (k_scale / v_scale then
// required). q [S, H, 1, d]; pages [n_rows, H, psz, d], each with unit
// stride on d; `strides` holds (q slot, q head, q row, k page, k head, k
// row, v page, v head, v row) in elements. scales [n_rows, H, 1, 1]
// float32; table [S, mp] int32 (entries outside [0, n_rows) read the trash
// row n_rows - 1); lengths [S] int32 written counts; bias [S, mp * psz]
// float32 or null. out [S, H, 1, d] contiguous, q's type. Returns the
// launch's cudaError_t.
extern "C" int pt_paged_decode(int device, int qdtype, int kvdtype,
                               const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* table,
                               const void* lengths, const void* bias,
                               void* out, int S, int H, int mp, int psz,
                               int n_rows, int d, const long long* strides,
                               float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d < 1 || d > 128 || psz < 1 || mp < 1 || n_rows < 1 || H < 1 ||
      S < 0 || (qdtype != 0 && qdtype != 1) || kvdtype < 0 || kvdtype > 2 ||
      (kvdtype == 2 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  if ((long long)S * H > 65535) return (int)cudaErrorInvalidValue;
  int plan[2];
  pt_paged_decode_plan(device, S, H, mp, plan);
  const int esz = kvdtype == 0 ? 4 : kvdtype == 1 ? 2 : 1;
  // 16-byte copies of whole key rows: every row of both views starts on
  // 16 bytes and holds whole 16-byte chunks
  bool vec = (d * esz) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  for (int i = 3; i < 9; ++i) vec = vec && (strides[i] * esz) % 16 == 0;
  const pdec::Args a{q, k_pages, v_pages,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(table),
                     static_cast<const int*>(lengths),
                     static_cast<const float*>(bias), out, H, mp, psz,
                     n_rows, d, mp * psz, plan[1], vec ? 1 : 0, strides[0],
                     strides[1], strides[3], strides[4], strides[5],
                     strides[6], strides[7], strides[8], scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return qdtype == 0 ? pdec::by_kv<float>(kvdtype, a, S * H, plan[0], s)
                     : pdec::by_kv<__nv_bfloat16>(kvdtype, a, S * H,
                                                  plan[0], s);
}
