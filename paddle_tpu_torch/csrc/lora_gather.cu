// Gathered LoRA delta for Hopper (sm_90a): for every batch row i,
//   out[i] = (x[i] @ A[ids[i]]) @ B[ids[i]]
// with x [b, s, d] float32, the stacked adapter banks A [cap, d, r] and
// B [cap, r, n] float32, ids [b] int32 and out [b, s, n] float32. The
// wrapper (ops/quant.py `lora_delta`) casts a bf16 x to float32 first and
// the result back to x's type.
//
// Replaces: paddle_tpu/ops/quant.py `_lora_gather_call` (the Pallas
// kernel behind `lora_delta`, whose A/B index maps dereference the
// scalar-prefetched ids). Same math in float32: xa = x[i] @ A[id], then
// xa @ B[id]. Bank row 0 is the base model and holds zeros, so a base
// row gets an exact zero through the same arithmetic (no short cut: a
// NaN in x stays a NaN, as in the plain version). Each block loads its
// own row's id, which takes the place of the scalar prefetch; the
// wrapper has checked every id against [0, cap) on the host, and an id
// outside it would only write NaN here, never read past the banks.
//
// What bounds it on an H100: device-memory bandwidth, far below the card's
// float32 ridge (a rank-r product: 2 s r (d + n) flops against x, the A and
// B rows of the adapter and out), and on the serving shapes mostly latency:
// a decode step moves ~0.1 MB. Design: a thread-block cluster of C CTAs
// (C up to 8, `lora_plan`) owns one tile of RT rows of s of one batch row,
// so that the grid spreads over the SMs even at b 8 s 1:
//  * CTA q reduces its d/C slice of x @ A[id] for the tile: the slice of x
//    and the matching contiguous rows of A[id] stream through a two-stage
//    ring of 16-byte cp.async copies (the next 256-wide chunk in flight while
//    the FMAs run on this one); each row's k's are spread over 256/RT
//    threads and reduced with warp shuffles, then across warps in shared
//    memory, in a fixed order;
//  * the C partial xa tiles are summed through distributed shared memory
//    (`map_shared_rank`), every CTA reading ranks 0..C-1 in order: no
//    atomics, the same result every run; a CTA arrives on the cluster
//    barrier that keeps its partial alive once it has read the others',
//    and waits on it only after phase 2;
//  * CTA q then expands its n/C slice of columns, out = xa @ B[id], each
//    thread holding 4 columns of B[id]'s r rows in registers (read once per
//    row tile) and writing 16-byte rows of out.
// x and A[id] are read once per row tile (never again per column slice, as
// the single-block design did), B[id] once per row tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 32;        // the largest rank (ops/quant.py checks)
constexpr int KC = 256;         // k per chunk of the ring
constexpr int KP = KC + 16;     // x row stride in shared memory, floats
constexpr int ROWS = 16;        // the largest row tile
constexpr int CLUSTER_MAX = 8;  // the portable cluster size

// floats: x ring [2][ROWS][KP], A ring [2][KC * RP], the CTA's partial xa
// [ROWS][RP], the summed xa [ROWS][RP], warp partials [ROWS][RP]
template <int RP>
constexpr int smem_bytes() {
  return 4 * (2 * ROWS * KP + 2 * KC * RP + 3 * ROWS * RP);
}

template <int RP>
__global__ void __launch_bounds__(THREADS)
lora_cluster_kernel(const float* __restrict__ x, const float* __restrict__ A,
                    const float* __restrict__ B, const int* __restrict__ ids,
                    float* __restrict__ out, int s, int d, int r, int n,
                    int cap, int RT, int K, int NC, int vec) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                        // [2][ROWS][KP]
  float* as = xs + 2 * ROWS * KP;        // [2][KC * RP]
  float* part = as + 2 * KC * RP;        // [ROWS][RP]
  float* xa = part + ROWS * RP;          // [ROWS][RP]
  float* red = xa + ROWS * RP;           // [ROWS][RP]
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int q = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int i = blockIdx.z, s0 = blockIdx.y * RT;
  const int sv = min(RT, s - s0);        // valid rows of this tile
  const int c0 = q * NC, cn = min(NC, n - c0);
  float* orow = out + ((long long)i * s + s0) * n;
  const int id = ids[i];                 // in flight while x is copied
  const float* xi = x + ((long long)i * s + s0) * d;

  // phase 1: this CTA's k in [k0, k1), tpr threads a row
  const int k0 = min(d, q * K), k1 = min(d, k0 + K);
  const int nch = (k1 - k0 + KC - 1) / KC;
  const int tpr = THREADS / RT, t = tid / tpr, lr = tid % tpr;
  auto issue_x = [&](int ch) {
    const int kc0 = k0 + ch * KC, kcn = min(KC, k1 - kc0);
    float* xd = xs + (ch & 1) * ROWS * KP;
    if (vec) {
      const int q4 = (kcn + 3) / 4;
      for (int idx = tid; idx < sv * q4; idx += THREADS) {
        const int tt = idx / q4, c = 4 * (idx - tt * q4);
        hopper::cp_async16(xd + tt * KP + c, xi + (long long)tt * d + kc0 + c,
                           4 * min(4, kcn - c));
      }
    } else {
      for (int idx = tid; idx < sv * kcn; idx += THREADS) {
        const int tt = idx / kcn, c = idx - tt * kcn;
        hopper::cp_async4(xd + tt * KP + c, xi + (long long)tt * d + kc0 + c,
                          4);
      }
    }
  };
  if (nch > 0) issue_x(0);
  if (id < 0 || id >= cap) {             // the same for the whole cluster
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    for (int idx = tid; idx < sv * max(cn, 0); idx += THREADS)
      orow[(long long)(idx / cn) * n + c0 + idx % cn] =
          __int_as_float(0x7fc00000);
    return;
  }
  const float* ai = A + (long long)id * d * r;
  const float* bi = B + (long long)id * r * n;
  auto issue_a = [&](int ch) {
    const int kc0 = k0 + ch * KC, kcn = min(KC, k1 - kc0);
    float* ad = as + (ch & 1) * KC * RP;
    const float* asrc = ai + (long long)kc0 * r;
    const int na = kcn * r;
    if (vec) {
      for (int idx = tid; idx < (na + 3) / 4; idx += THREADS)
        hopper::cp_async16(ad + 4 * idx, asrc + 4 * idx,
                           4 * min(4, na - 4 * idx));
    } else {
      for (int idx = tid; idx < na; idx += THREADS)
        hopper::cp_async4(ad + idx, asrc + idx, 4);
    }
  };
  if (nch > 0) issue_a(0);
  hopper::cp_async_commit();

  // phase 2's columns: 4 (or 1) a thread, G groups side by side and rg
  // threads down the rows
  const int w = vec ? 4 : 1;
  const int ncg = cn > 0 ? (cn + w - 1) / w : 0;
  const int G = max(1, min(ncg, THREADS)), rg = THREADS / G;
  const int cg0 = tid % G, rr = tid / G;
  auto load_b = [&](int g, float (&bv)[RP][4]) {
    const int c = c0 + w * g;
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      if (j < r && vec) {
        const float4 v4 = __ldg(reinterpret_cast<const float4*>(
            bi + (long long)j * n + c));
        bv[j][0] = v4.x;
        bv[j][1] = v4.y;
        bv[j][2] = v4.z;
        bv[j][3] = v4.w;
      } else {
        bv[j][0] = j < r ? __ldg(bi + (long long)j * n + c) : 0.f;
        bv[j][1] = bv[j][2] = bv[j][3] = 0.f;
      }
    }
  };
  float bv[RP][4];
  const bool writes = rr < rg && cg0 < ncg;

  float acc[RP];
#pragma unroll
  for (int j = 0; j < RP; ++j) acc[j] = 0.f;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      issue_x(ch + 1);
      issue_a(ch + 1);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const int st = ch & 1, kcn = min(KC, k1 - (k0 + ch * KC));
    const float* xr = xs + st * ROWS * KP + t * KP;
    const float* ar = as + st * KC * RP;
    if (t < sv)
      for (int kk = lr; kk < kcn; kk += tpr) {
        const float xv = xr[kk];
#pragma unroll
        for (int j = 0; j < RP; ++j)
          if (j < r) acc[j] = fmaf(xv, ar[kk * r + j], acc[j]);
      }
    __syncthreads();
  }
  // reduce each row's tpr threads: lanes (shuffles), then warps (in order)
  const int span = min(tpr, 32), wpr = max(1, tpr / 32);
#pragma unroll
  for (int j = 0; j < RP; ++j)
    for (int off = span >> 1; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  if (lr % 32 == 0)
#pragma unroll
    for (int j = 0; j < RP; ++j)
      red[(t * wpr + lr / 32) * RP + j] = acc[j];
  __syncthreads();
  for (int idx = tid; idx < RT * RP; idx += THREADS) {
    const int tt = idx / RP, j = idx - tt * RP;
    float v = 0.f;
    for (int w2 = 0; w2 < wpr; ++w2) v += red[(tt * wpr + w2) * RP + j];
    part[idx] = v;
  }
  // the cluster's partials, summed in rank order (all C loads in flight)
  cluster.sync();
  for (int idx = tid; idx < RT * RP; idx += THREADS) {
    float pv[CLUSTER_MAX];
#pragma unroll
    for (int k = 0; k < CLUSTER_MAX; ++k)
      pv[k] = k < C ? cluster.map_shared_rank(part, k)[idx] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < CLUSTER_MAX; ++k)
      if (k < C) v += pv[k];
    xa[idx] = v;
  }
  // no CTA may leave while another reads its partial: arrive now, wait
  // after phase 2, so the barrier's latency hides behind it
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // phase 2: out[t, c0 + c] = sum_j xa[t][j] * B[id][j, c0 + c]
  for (int g = writes ? cg0 : ncg; g < ncg; g += G) {
    load_b(g, bv);
    const int c = c0 + w * g;
    for (int tt = rr; tt < sv; tt += rg) {
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        if (j >= r) break;
        const float xv = xa[tt * RP + j];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] = fmaf(xv, bv[j][u], o[u]);
      }
      float* dst = orow + (long long)tt * n + c;
      if (vec)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        *dst = o[0];
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

// Set the kernel's dynamic shared memory limit (once per device).
template <int RP>
cudaError_t prepare(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      lora_cluster_kernel<RP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<RP>());
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

// Row tile RT (a power of two up to 16, no more than s needs) and cluster
// size C (a power of two up to 8): the smallest C whose grid covers every
// SM once, so a decode step (b 8, s 1) runs 8 clusters of 8 CTAs. Clusters
// of 16 (non-portable) were slower there on an H100 (PERF.md §6). A legal
// `tuned` (the tuning table's cluster: 1..CLUSTER_MAX CTAs, each with 4 or
// more of d and of n) replaces the rule's C; 0, or an illegal value, keeps
// the rule.
void lora_plan(int sms, int b, int s, int d, int n, int* RT, int* C,
               int tuned) {
  int rt = 1;
  while (rt < s && rt < ROWS) rt *= 2;
  const long long tiles = (long long)b * ((s + rt - 1) / rt);
  int c = 1;
  while (c < CLUSTER_MAX && tiles * c < sms && 4 * c < d) c *= 2;
  *RT = rt;
  *C = tuned >= 1 && tuned <= CLUSTER_MAX && 4 * tuned <= d + 3 &&
               4 * tuned <= n + 3
           ? tuned
           : c;
}

template <int RP>
int launch(int device, const float* x, const float* A, const float* B,
           const int* ids, float* out, int b, int s, int d, int r, int n,
           int cap, int cluster, cudaStream_t stream) {
  cudaError_t err = prepare<RP>(device);
  if (err != cudaSuccess) return (int)err;
  int RT, C;
  lora_plan(sm_count(device), b, s, d, n, &RT, &C, cluster);
  const int K = ((d + C - 1) / C + 3) / 4 * 4;
  const int NC = ((n + C - 1) / C + 3) / 4 * 4;
  const bool vec = d % 4 == 0 && n % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(A) |
        reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (s + RT - 1) / RT, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<RP>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lora_cluster_kernel<RP>, x, A, B, ids, out,
                           s, d, r, n, cap, RT, K, NC, vec ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a launch on `device` for x [b, s, d] and n output columns:
// out = (rows of s a row tile, CTAs a cluster), `cluster` the plan's
// override (0 = the rule). The grid is b * ceil(s / rows) clusters.
extern "C" int pt_lora_gather_plan(int device, int b, int s, int d, int n,
                                   int cluster, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  lora_plan(sm_count(device), b, s, d, n, out, out + 1, cluster);
  return 0;
}

// C entry point, bound with ctypes. x [b, s, d], A [cap, d, r] and
// B [cap, r, n] float32, ids [b] int32 (each in [0, cap)), all contiguous;
// out [b, s, n] float32. 1 <= r <= 32. cluster: the plan's override
// (`pt_lora_gather_plan`). Returns the launch's cudaError_t.
extern "C" int pt_lora_gather(int device, const void* x, const void* A,
                              const void* B, const void* ids, void* out,
                              int b, int s, int d, int r, int n, int cap,
                              int cluster, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r < 1 || r > RMAX || b < 0 || s < 0 || d < 0 || n < 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || n == 0) return 0;
  if ((s + ROWS - 1) / ROWS > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const float*>(x);
  auto ap = static_cast<const float*>(A);
  auto bp = static_cast<const float*>(B);
  auto ip = static_cast<const int*>(ids);
  auto op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (r <= 8)
    return launch<8>(device, xp, ap, bp, ip, op, b, s, d, r, n, cap,
                     cluster, st);
  if (r <= 16)
    return launch<16>(device, xp, ap, bp, ip, op, b, s, d, r, n, cap,
                     cluster, st);
  return launch<32>(device, xp, ap, bp, ip, op, b, s, d, r, n, cap,
                     cluster, st);
}
