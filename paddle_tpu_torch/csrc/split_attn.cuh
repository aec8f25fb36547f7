// Split-K attention of a block of R query rows against a KV cache: the dense
// verify kernel (flash_verify.cu) alone. The decodes (flash_decode.cu,
// paged_decode.cu) and both routes of the paged verify (paged_verify.cu)
// merge their key splits in their kernels (attn_merge.cuh, and the tiled
// route's own); this one does not.
//
// One 128-thread block owns (key split, batch*head row, tile of R query rows)
// and emits one partial softmax (acc, m, l) per query row of the tile; its
// callers' logsumexp combine of the partials runs outside, in torch ops, as
// the JAX package does it in XLA. Query row t of T sits at position n_valid - T + t
// (n_valid = the row's written-key count after the T-token write) and sees
// key j while j <= that position (T == 1 is the plain decode step). Per key:
// logits = q_scaled . k, keys past the row's position set to -1e30, then the
// optional [rows, L] f32 key bias added; m = max over the split, p = exp(x -
// m), l = sum(p), acc = p . v.
//
// Keys a tile can never see (past its last row's position, past n_valid or
// past L) are not read: every row of the tile would give them p = 0 exactly
// (or, for a row with no visible key in the split, a partial whose weight the
// combine's alpha = exp(-1e30 - m_star) flushes to zero). A split with no
// such key emits the exact-zero partial acc = 0, m = -1e30, l = 0, as the TPU
// kernels do for a split past the written region.
//
// What bounds these kernels on an H100: device-memory bandwidth. Each needed
// K and V element is read once per query tile against 4 R flops, under the
// card's ~20 flop/byte fp32 ridge for the tiles the serving paths use (R <= 8
// rows, keys of 4 bytes or fewer). Design: each warp takes every 4th key of
// the split; its 32 lanes read a key row as consecutive elements (coalesced),
// reduce the R dot products with warp shuffles and keep R running (m, l, acc)
// online softmaxes in registers; U keys per iteration keep several row loads
// in flight. The four warps' partials merge in shared memory by a logsumexp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace split_attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Key rows of a contiguous-per-row cache k/v [B, H, L, d] (element strides
// per batch, head and row).
template <typename TKV> struct DenseKeys {
  const TKV* k;
  const TKV* v;
  long long ksb, ksh, kss, vsb, vsh, vss;
  const TKV* kb;
  const TKV* vb;

  __device__ __forceinline__ void bind(int b, int h) {
    kb = k + b * ksb + h * ksh;
    vb = v + b * vsb + h * vsh;
  }
  __device__ __forceinline__ void row(int j, const TKV*& kr, const TKV*& vr,
                                      float& ks, float& vs) const {
    kr = kb + (long long)j * kss;
    vr = vb + (long long)j * vss;
    ks = 1.f;
    vs = 1.f;
  }
};

// ROUND: the dense verify's rounding (the scaled q rounded to q's type, p
// rounded to it before p . v); without it q, K, V and p stay float32.
template <typename TQ, typename TKV, int D, int R, bool ROUND, class Keys>
__global__ void __launch_bounds__(THREADS)
split_attn_kernel(const TQ* __restrict__ q, Keys keys,
                  const float* __restrict__ bias,
                  const int* __restrict__ lengths, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int H,
                  int T, int L, int d, int split, int n_splits, long long qsb,
                  long long qsh, long long qst, float scale) {
  constexpr int PER = D / 32;          // elements of a row per lane
  constexpr int U = R == 1 ? 4 : 2;    // keys per warp per iteration
  __shared__ float sm_m[WARPS][R], sm_l[WARPS][R], sm_a[WARPS][R][D];

  const int si = blockIdx.x, bh = blockIdx.y, t0 = blockIdx.z * R;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_valid = lengths[b];
  const int rows = min(R, T - t0);
  const int start = si * split;
  // keys past the tile's last row position are hidden from every row
  const int end = min(min(start + split, L), n_valid - T + t0 + rows);
  const long long part0 = ((long long)bh * n_splits + si) * T + t0;

  if (start >= end) {
    // no key of the split is visible to the tile: the exact-zero partial
    for (int i = 0; i < rows; ++i) {
      for (int c = threadIdx.x; c < d; c += THREADS)
        acc_out[(part0 + i) * d + c] = 0.f;
      if (threadIdx.x == 0) {
        m_out[part0 + i] = NEG;
        l_out[part0 + i] = 0.f;
      }
    }
    return;
  }
  keys.bind(b, h);
  const float* bp = bias ? bias + (long long)b * L : nullptr;

  float qv[R][PER];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const TQ* qp = q + b * qsb + h * qsh + (long long)(t0 + i) * qst;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int c = lane + 32 * e;
      float x = 0.f;
      if (i < rows && c < d) {
        x = to_f(qp[c]) * scale;
        if (ROUND) x = round_to<TQ>(x);
      }
      qv[i][e] = x;
    }
  }

  float mw[R], lw[R], aw[R][PER];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    mw[i] = -INFINITY;
    lw[i] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) aw[i][e] = 0.f;
  }
  const int qpos0 = n_valid - T + t0;   // position of the tile's row 0

  for (int j0 = start + warp; j0 < end; j0 += WARPS * U) {
    float kr[U][PER], vr[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + WARPS * u;
      const TKV* kp = nullptr;
      const TKV* vp = nullptr;
      float ksc = 1.f, vsc = 1.f;
      if (j < end) keys.row(j, kp, vp, ksc, vsc);
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int c = lane + 32 * e;
        const bool ok = j < end && c < d;
        kr[u][e] = ok ? to_f(kp[c]) * ksc : 0.f;
        vr[u][e] = ok ? to_f(vp[c]) * vsc : 0.f;
      }
    }
    float sc[R][U];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) s = fmaf(qv[i][e], kr[u][e], s);
        sc[i][u] = s;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[i][u] += __shfl_xor_sync(0xffffffffu, sc[i][u], o);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + WARPS * u;
        float x = -INFINITY;           // past the tile's keys: never enters
        if (j < end) {
          x = j <= qpos0 + i ? sc[i][u] : NEG;
          if (bp) x += bp[j];
        }
        sc[i][u] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(mw[i], mx);   // finite: key j0 is in range
      const float alpha = expf(mw[i] - m_new);
      float p[U];
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(sc[i][u] - m_new);
        ps += p[u];
        if (ROUND) p[u] = round_to<TQ>(p[u]);
      }
      lw[i] = lw[i] * alpha + ps;
      mw[i] = m_new;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        float a = aw[i][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vr[u][e], a);
        aw[i][e] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = mw[i];
      sm_l[warp][i] = lw[i];
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) sm_a[warp][i][lane + 32 * e] = aw[i][e];
  }
  __syncthreads();
  for (int i = 0; i < rows; ++i) {
    float ms = sm_m[0][i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) ms = fmaxf(ms, sm_m[w][i]);
    for (int c = threadIdx.x; c < d; c += THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a += sm_a[w][i][c] * expf(sm_m[w][i] - ms);
      acc_out[(part0 + i) * d + c] = a;
    }
    if (threadIdx.x == 0) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ls += sm_l[w][i] * expf(sm_m[w][i] - ms);
      m_out[part0 + i] = ms;
      l_out[part0 + i] = ls;
    }
  }
}

// Launch over the grid (n_splits, B * H, ceil(T / R)).
template <typename TQ, typename TKV, int D, int R, bool ROUND, class Keys>
int launch(const void* q, const Keys& keys, const void* bias,
           const void* lengths, void* acc, void* m, void* l, int B, int H,
           int T, int L, int d, int split, long long qsb, long long qsh,
           long long qst, float scale, cudaStream_t stream) {
  const int n_splits = (L + split - 1) / split;
  dim3 grid(n_splits, B * H, (T + R - 1) / R);
  split_attn_kernel<TQ, TKV, D, R, ROUND, Keys><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), keys, static_cast<const float*>(bias),
      static_cast<const int*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), H, T, L, d, split,
      n_splits, qsb, qsh, qst, scale);
  return (int)cudaGetLastError();
}

}  // namespace split_attn
