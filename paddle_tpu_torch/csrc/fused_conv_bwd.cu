// Fused 1x1-conv + BatchNorm backward for Hopper (sm_90a). From the
// forward's x, its stored z, the cotangent dz of z and the cotangents ds,
// dss of the stats (sum z, sum z^2):
//   dz_eff = f32(dz) + ds[o] + 2 * f32(z) * dss[o], rounded to x's type (dzb)
//   dxn[b, c, p] = sum_o W[o, c] * dzb[b, o, p]
//   dpre = dxn masked by the forward's ReLU (pre > 0 with a norm, x > 0
//          without)
//   dx = dpre * scale[c] with a norm, else dpre, in x's type
//   dW[o, c] = sum_{b,p} dzb[b, o, p] * xn[b, c, p]          (float32)
//   dscale[c] = sum_{b,p} dpre * f32(x),  dshift[c] = sum_{b,p} dpre
// with xn recomputed as the forward computed it. dz_eff uses the STORED z
// (rounded to x's type), as the JAX kernel does.
//
// Replaces: paddle_tpu/ops/fused_conv.py `_bwd_call`. The TPU kernel made
// one pass over (x, z, dz) per image and carried dW, dscale and dshift
// across its sequential grid. Here the work is two products that run in
// parallel blocks:
//  * dx: a product over Co for each (input channel, column) tile, whose
//    epilogue reads x again for the ReLU mask, writes dx and the per-tile
//    partials of dscale and dshift;
//  * dW: a product over the B * HW columns, split into k-ranges across
//    blocks (the H100 needs hundreds of blocks, and a 64 x 64 tile of dW
//    is only a few blocks at ResNet-50's widths); each block writes its
//    float32 partial and a second pass adds them in a fixed order.
// Both recompute xn from x and dz_eff from (z, dz) while staging their
// slices in shared memory: neither ever exists in device memory, which is
// the whole point of the TPU kernel. No float atomics: every sum is taken
// in the same order on every run.
//
// What bounds it: twice the forward's 2 * B * Co * Ci * HW operations
// against reading x, z, dz and writing dx once. Like the forward, this
// first kernel runs float32 FMAs on the CUDA cores (register-tiled 64 x 64
// tiles, 16-deep slices), so it is operation-bound on them; tensor-core
// products are later work.

#include "fused_conv.cuh"

namespace {

using namespace fc;

// dz_eff rounded to T, as a float: ((dz + ds) + (2 z) dss) in float32,
// each op rounded on its own (the plain version's order).
template <typename T>
__device__ __forceinline__ float dz_eff(T dzv, T zv, float ds, float dss) {
  const float t = __fmul_rn(__fmul_rn(2.f, to_f(zv)), dss);
  return round_to<T>(__fadd_rn(__fadd_rn(to_f(dzv), ds), t));
}

// Block (column tile blockIdx.x, input-channel tile blockIdx.y): dx, and
// the partials of dscale / dshift over the tile's columns.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_conv_bwd_dx(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const float* __restrict__ w,
                  const T* __restrict__ z, const T* __restrict__ dz,
                  const float* __restrict__ ds, const float* __restrict__ dss,
                  T* __restrict__ dx, float* __restrict__ part, int B, int Ci,
                  int Co, int HW, int P, int has_norm, int relu) {
  __shared__ __align__(16) float ws[TK][TM + 4];   // W slice: ws[o][c]
  __shared__ __align__(16) float gs[TK][TN + 4];   // dzb slice: gs[o][col]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = B * HW;
  const int n0 = blockIdx.x * TN, c0 = blockIdx.y * TM;
  const int lc = tid & (TN - 1), lk = tid >> 6;
  const bool col_ok = n0 + lc < N;
  const long long zoff = col_ok ? col_offset(n0 + lc, Co, HW) : 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Co; k0 += TK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * THREADS;          // 16 o x 64 c
      const int r = idx & 63, kk = idx >> 6;
      const int o = k0 + kk, c = c0 + r;
      ws[kk][r] = (o < Co && c < Ci) ? w[(long long)o * Ci + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = lk + 4 * u, o = k0 + kk;
      const long long at = zoff + (long long)o * HW;
      gs[kk][lc] = (col_ok && o < Co)
          ? dz_eff<T>(dz[at], z[at], ds[o], dss[o]) : 0.f;
    }
    __syncthreads();
    mma_slice(ws, gs, acc, ty, tx);
    __syncthreads();
  }

  float dsc[4] = {0.f, 0.f, 0.f, 0.f}, dsh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const long long xo = col_offset(n, Ci, HW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= Ci) continue;
      const long long at = xo + (long long)c * HW;
      const float xv = to_f(x[at]);
      float dpre = acc[i][j];
      if (has_norm) {
        if (relu && !(affine(xv, scale[c], shift[c]) > 0.f)) dpre = 0.f;
        dx[at] = from_f<T>(__fmul_rn(dpre, scale[c]));
        dsc[i] += dpre * xv;
        dsh[i] += dpre;
      } else {
        if (relu && !(xv > 0.f)) dpre = 0.f;
        dx[at] = from_f<T>(dpre);
      }
    }
  }
  if (has_norm) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = half_warp_sum(dsc[i]), b = half_warp_sum(dsh[i]);
      const int c = c0 + ty * 4 + i;
      if (tx == 0 && c < Ci) {
        part[(long long)c * P + blockIdx.x] = a;
        part[(long long)(Ci + c) * P + blockIdx.x] = b;
      }
    }
  }
}

// Block (input-channel tile blockIdx.x, output-channel tile blockIdx.y,
// k-range blockIdx.z of k_per_split columns): the partial dW of its tile
// over its k-range, into out[blockIdx.z] (out is dW itself when there is
// one k-range).
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_conv_bwd_dw(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const T* __restrict__ z,
                  const T* __restrict__ dz, const float* __restrict__ ds,
                  const float* __restrict__ dss, float* __restrict__ out,
                  int B, int Ci, int Co, int HW, int k_per_split,
                  int has_norm, int relu) {
  __shared__ __align__(16) float gs[TK][TM + 4];   // dzb slice: gs[n][o]
  __shared__ __align__(16) float xs[TK][TN + 4];   // xn slice: xs[n][c]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = B * HW;
  const int c0 = blockIdx.x * TN, o0 = blockIdx.y * TM;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(N, kb + k_per_split);
  // this thread stages column k0 + kk of rows rr + 16 u: a half-warp reads
  // 16 consecutive columns of a row
  const int kk = tid & 15, rr = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += TK) {
    const int n = k0 + kk;
    const bool ok = n < ke;
    const long long zo = ok ? col_offset(n, Co, HW) : 0;
    const long long xo = ok ? col_offset(n, Ci, HW) : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = rr + 16 * u;
      const int o = o0 + r, c = c0 + r;
      const long long at = zo + (long long)o * HW;
      gs[kk][r] = (ok && o < Co) ? dz_eff<T>(dz[at], z[at], ds[o], dss[o])
                                 : 0.f;
      xs[kk][r] = (ok && c < Ci)
          ? act_in<T>(x[xo + (long long)c * HW], scale, shift, c, has_norm,
                      relu)
          : 0.f;
    }
    __syncthreads();
    mma_slice(gs, xs, acc, ty, tx);
    __syncthreads();
  }

  float* dst = out + (long long)blockIdx.z * Co * Ci;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty * 4 + i;
    if (o >= Co) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < Ci) dst[(long long)o * Ci + c] = acc[i][j];
    }
  }
}

// The second pass of a split dW: dw = the sum of the k-range partials,
// added in k order.
__global__ void __launch_bounds__(THREADS)
dw_reduce(const float* __restrict__ work, float* __restrict__ dw,
          long long total, int splits) {
  const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (o >= total) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += work[t * total + o];
  dw[o] = s;
}

template <typename T>
int launch(const void* x, const void* scale, const void* shift, const void* w,
           const void* z, const void* dz, const void* ds, const void* dss,
           void* dx, void* dw, void* dscale, void* dshift, void* part,
           void* work, int B, int Ci, int Co, int HW, int P, int splits,
           int has_norm, int relu, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* scp = static_cast<const float*>(scale);
  const float* shp = static_cast<const float*>(shift);
  const T* zp = static_cast<const T*>(z);
  const T* dzp = static_cast<const T*>(dz);
  const float* dsp = static_cast<const float*>(ds);
  const float* dssp = static_cast<const float*>(dss);
  float* partp = static_cast<float*>(part);
  const int N = B * HW;
  const dim3 gdx(P, (Ci + TM - 1) / TM);
  if (gdx.y > 65535) return (int)cudaErrorInvalidValue;
  fused_conv_bwd_dx<T><<<gdx, THREADS, 0, st>>>(
      xp, scp, shp, static_cast<const float*>(w), zp, dzp, dsp, dssp,
      static_cast<T*>(dx), partp, B, Ci, Co, HW, P, has_norm, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (has_norm) {
    reduce_partials<<<Ci, THREADS, 0, st>>>(partp,
                                            static_cast<float*>(dscale),
                                            static_cast<float*>(dshift), Ci,
                                            P);
  } else {
    err = cudaMemsetAsync(dscale, 0, sizeof(float) * Ci, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(dshift, 0, sizeof(float) * Ci, st);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Co == 0) return 0;
  // whole 16-column slices a k-range; splits shrinks to the ranges needed
  int k_per_split = (N + splits - 1) / splits;
  k_per_split = (k_per_split + TK - 1) / TK * TK;
  splits = (N + k_per_split - 1) / k_per_split;
  float* out = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(dw);
  const dim3 gdw((Ci + TN - 1) / TN, (Co + TM - 1) / TM, splits);
  if (gdw.y > 65535 || gdw.z > 65535) return (int)cudaErrorInvalidValue;
  fused_conv_bwd_dw<T><<<gdw, THREADS, 0, st>>>(xp, scp, shp, zp, dzp, dsp,
                                                dssp, out, B, Ci, Co, HW,
                                                k_per_split, has_norm, relu);
  if (splits > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)Co * Ci;
    dw_reduce<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
                st>>>(static_cast<const float*>(work),
                      static_cast<float*>(dw), total, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 float32, 1 bf16 (x, z, dz and
// dx). x [B, Ci, HW], z and dz [B, Co, HW], W [Co, Ci] float32, scale /
// shift [Ci] float32 (null without a norm), ds / dss [Co] float32, all
// contiguous. Outputs: dx [B, Ci, HW]; dw [Co, Ci], dscale, dshift [Ci]
// float32 (zeros without a norm). Scratch: part, float32 of 2 * Ci * P
// with P = ceil(B * HW / 64); with splits > 1, work, float32 of splits *
// Co * Ci (the k-range partials of dW). Up to four launches: dx with the
// dscale / dshift partials, their fixed-order sum, the split dW product,
// and its fixed-order sum. Returns the first failing cudaError_t.
extern "C" int pt_fused_conv_bwd(int device, int dtype, const void* x,
                                 const void* scale, const void* shift,
                                 const void* w, const void* z, const void* dz,
                                 const void* ds, const void* dss, void* dx,
                                 void* dw, void* dscale, void* dshift,
                                 void* part, void* work, int B, int Ci,
                                 int Co, int HW, int P, int splits,
                                 int has_norm, int relu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long N = (long long)B * HW;
  if (B < 0 || Ci < 0 || Co < 0 || HW < 0 || N > 0x7fffffffLL ||
      P != (int)((N + TN - 1) / TN) || splits < 1 ||
      (splits > 1 && work == nullptr) || (has_norm && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  if (Ci == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    void* zeroed[3] = {dw, dscale, dshift};
    const size_t bytes[3] = {sizeof(float) * Co * Ci, sizeof(float) * Ci,
                             sizeof(float) * Ci};
    for (int i = 0; i < 3; ++i) {
      err = cudaMemsetAsync(zeroed[i], 0, bytes[i], st);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (dtype == 0)
    return launch<float>(x, scale, shift, w, z, dz, ds, dss, dx, dw, dscale,
                         dshift, part, work, B, Ci, Co, HW, P, splits,
                         has_norm, relu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, shift, w, z, dz, ds, dss, dx, dw,
                                 dscale, dshift, part, work, B, Ci, Co, HW,
                                 P, splits, has_norm, relu, st);
  return (int)cudaErrorInvalidValue;
}
