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
// against reading x, z, dz and writing dx once. On the tensor cores one
// product's operations take 0.013 ms at every ResNet-50 shape (batch
// 128), the bytes of its stream 0.02-0.15 ms; on the CUDA cores (67
// TFLOP/s of float32 FMAs) a product takes at least 0.2 ms.
//
// bfloat16 x (the ResNet path): dW runs on the tensor cores (bf16 wgmma
// m64n64k16, float32 accumulators; `hopper_mma.cuh`, `fused_conv_mma.cuh`):
// both of its operands, dzb and xn, are bf16 whatever W's type, so its
// products are exact, and its sums are split into k-ranges anyway
// (fixed-order second pass). dx runs there too when W is bf16 as well
// (its products dzb * W are then exact; a float32 W promotes them to
// float32, which stays on the SIMT kernel). Either tensor-core product
// sums the same products as the plain version in another float32 order,
// so its bf16 output is held to one bf16 ulp plus 2^-20 of each element's
// sum of |products| (`paddle_tpu_torch/testing.py` judge_bf16_sum).
// `pt_fused_conv_bwd_tensor_cores` is the route rule; the wrapper asks it
// to pass W in the type dx takes and to count the launches of each route.
// Raw tiles of z, dz and x stream into 128-byte-swizzled shared memory by
// cp.async (16 bytes a thread when HW is a multiple of 8, 8 when of 4,
// else element loads), each thread then turns the chunks it copied into
// dzb and xn in place (the products' bf16 operands), and the tile goes to
// wgmma while the next stages land.
//  * dW[o, c] = sum_n dzb[o, n] xn[c, n], both operands K-major (n is the
//    reduction axis); a block (four warpgroups, three stages in the ring)
//    owns 128 output x 256 input channels and one k-range of the B * HW
//    columns, 64 a stage, and writes its float32 partial; the k-range
//    partials are added by the same fixed-order second pass as the SIMT
//    kernel's.
//  * dx[c, n] = sum_o W[o, c] dzb[o, n], A = W^T read MN-major from W's
//    rows and B = dzb MN-major (n contiguous within an image); a block
//    (two warpgroups, three stages, 64 output channels a stage, two blocks
//    an SM) owns 128 input channels of a run of 64-column tiles, the
//    ring running on from one tile into the next, and a tile's epilogue
//    works from the float32 fragments: the ReLU mask from x (loaded at
//    the start of the tile's last stage), the dscale / dshift partials of
//    the tile, as the SIMT kernel's, and dx rounded to bf16 into the
//    warpgroup's spent W tile, stored in whole rows.
//
// float32 x (and dx of a bf16 x with a float32 W) keeps the SIMT kernels
// below: float32 FMAs on the CUDA cores (register-tiled 64 x 64 tiles,
// 16-deep slices), operation-bound on them (an fp32 input must: the
// port's contract has no TF32).

#include "fused_conv.cuh"
#include "fused_conv_mma.cuh"

namespace {

using namespace fc;

// dz_eff rounded to T, as a float: ((dz + ds) + (2 z) dss) in float32,
// each op rounded on its own (the plain version's order).
template <typename T>
__device__ __forceinline__ float dz_eff(T dzv, T zv, float ds, float dss) {
  const float t = __fmul_rn(__fmul_rn(2.f, to_f(zv)), dss);
  return round_to<T>(__fadd_rn(__fadd_rn(to_f(dzv), ds), t));
}

// Block (column tile blockIdx.x / nct, input-channel tile blockIdx.x %
// nct of nct): dx, and the partials of dscale / dshift over the tile's
// columns. The input-channel tiles of a column tile are adjacent blocks,
// so they run together and all but the first read its z and dz from L2.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_conv_bwd_dx(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const float* __restrict__ w,
                  const T* __restrict__ z, const T* __restrict__ dz,
                  const float* __restrict__ ds, const float* __restrict__ dss,
                  T* __restrict__ dx, float* __restrict__ part, int B, int Ci,
                  int Co, int HW, int P, int has_norm, int relu) {
  const int nct = (Ci + TM - 1) / TM, tile = blockIdx.x / nct;
  __shared__ __align__(16) float ws[TK][TM + 4];   // W slice: ws[o][c]
  __shared__ __align__(16) float gs[TK][TN + 4];   // dzb slice: gs[o][col]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = B * HW;
  const int n0 = tile * TN, c0 = (blockIdx.x - tile * nct) * TM;
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
        part[(long long)c * P + tile] = a;
        part[(long long)(Ci + c) * P + tile] = b;
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

// ---------------------------------------------------- bf16 on wgmma

constexpr int MMA_ROWS = 128;     // output rows of a block (64 a warpgroup)
constexpr int DW_THREADS = 512;   // dW: four warpgroups, 2 x 2 over its tile
constexpr int DW_NS = 3;          // dW: stages of the tile ring
constexpr int DW_NW = 4;          // dW: 64-column blocks of input channels

// Columns n .. n + 7 of the flattened (image, position) axis as (image,
// position) pairs (`cols8`: one division, then steps across an image's
// end), and the element offset of column e in channel ch of a [B, C, HW]
// tensor (`col_at`).
struct Cols8 {
  int b[8], p[8];
};

__device__ __forceinline__ Cols8 cols8(int n, int HW) {
  Cols8 c;
  int bb = n / HW, pp = n - bb * HW;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    c.b[e] = bb;
    c.p[e] = pp;
    const bool wrap = pp + 1 == HW;
    pp = wrap ? 0 : pp + 1;
    bb = wrap ? bb + 1 : bb;
  }
  return c;
}

__device__ __forceinline__ long long col_at(const Cols8& c, int e, int C,
                                            int HW, int ch) {
  return ((long long)c.b[e] * C + ch) * HW + c.p[e];
}

// Copy the 8 columns `cols` (the first n) of channel ch of a [B, C, HW]
// tensor into the 16 bytes at dst: vec 8, one 16-byte cp.async (HW a
// multiple of 8, so the eight columns are one run); vec 4, two 8-byte
// ones. Columns >= end and channels that are not `ok` read as zeros.
__device__ __forceinline__ void copy8(uint8_t* dst, const bf16* src,
                                      const Cols8& cols, int n, int end,
                                      int C, int HW, int ch, bool ok,
                                      int vec) {
  using namespace hopper;
  if (vec == 8) {
    const bool in = ok && n < end;
    cp_async16(dst, in ? src + col_at(cols, 0, C, HW, ch) : src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = ok && n + 4 * h < end;
      cp_async8(dst + 8 * h, in ? src + col_at(cols, 4 * h, C, HW, ch) : src,
                in ? 8 : 0);
    }
  }
}

// dW on the tensor cores. Block (input-channel tile blockIdx.x of 256,
// output-channel tile blockIdx.y of 128, k-range blockIdx.z of
// k_per_split columns, a multiple of 64): the partial dW of its tile over
// its k-range into out[blockIdx.z]. A stage holds 64 columns: the z and dz
// rows of the tile's output channels (128 x 64, dz then dzb in place of z)
// and the x rows of its input channels (256 x 64, then xn in place); rows
// past Co or Ci are zeros, written once. Warpgroup w owns rows
// 64 (w % 2) and the two column blocks from 2 (w / 2) of the tile (one
// column block a warpgroup, 128 input channels a tile, is a shape ptxas
// of CUDA 12.8 crashes on).
__global__ void __launch_bounds__(DW_THREADS, 1)
fused_conv_bwd_dw_mma(const bf16* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const bf16* __restrict__ z, const bf16* __restrict__ dz,
                      const float* __restrict__ ds,
                      const float* __restrict__ dss, float* __restrict__ out,
                      int B, int Ci, int Co, int HW, int k_per_split,
                      int has_norm, int relu, int vec) {
  using namespace hopper;
  constexpr int NW = DW_NW;
  constexpr int ZB = MMA_ROWS * 128;         // one z (or dz) tile
  constexpr int STAGE = 2 * ZB + NW * TILE_BYTES;
  constexpr int NWG = NW / 2;                // column blocks a warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* rv = reinterpret_cast<float*>(ring + DW_NS * STAGE);
  float* s_ds = rv;                          // [128] per output channel
  float* s_dss = rv + MMA_ROWS;
  float* s_sc = rv + 2 * MMA_ROWS;           // [64 NW] per input channel
  float* s_sh = s_sc + 64 * NW;

  const int tid = threadIdx.x;
  const int N = B * HW;
  const int c0 = blockIdx.x * 64 * NW, o0 = blockIdx.y * MMA_ROWS;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(N, kb + k_per_split);
  const int nt = (ke - kb + 63) / 64;

  // rows past Co or Ci are zeros for the whole block: written once here,
  // never copied or transformed
  if (o0 + MMA_ROWS > Co || c0 + 64 * NW > Ci)
    for (int i = tid; i < DW_NS * STAGE / 16; i += DW_THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < MMA_ROWS; i += DW_THREADS) {
    const bool ok = o0 + i < Co;
    s_ds[i] = ok ? ds[o0 + i] : 0.f;
    s_dss[i] = ok ? dss[o0 + i] : 0.f;
  }
  for (int i = tid; i < 64 * NW; i += DW_THREADS) {
    const bool ok = has_norm && c0 + i < Ci;
    s_sc[i] = ok ? scale[c0 + i] : 1.f;
    s_sh[i] = ok ? shift[c0 + i] : 0.f;
  }
  __syncthreads();

  // this thread's chunks of a stage: rows tid / 8 + 64 j of the z, dz and
  // x tiles, 16-byte column chunk tid % 8 of the stage's 64 columns; it
  // copies them and turns them into operands. With element loads (vec 1)
  // the thread takes column tid % 64 of rows tid / 64 + 8 k instead, so a
  // warp reads 32 adjacent columns of a row, and stores the operands
  // themselves.
  const int cr = tid >> 3, cc = tid & 7;
  auto issue = [&](int t, int slot) {
    uint8_t* st = ring + slot * STAGE;
    if (vec == 1) {
      // rows rg + 8 k share their swizzle (r % 8 == rg % 8): row rg + 8 k
      // of a tile sits 1 KiB k past row rg
      const int col = tid & 63, rg = tid >> 6;
      const int n = kb + t * 64 + col;
      const bool in = n < ke;
      const int b = in ? n / HW : 0, p = in ? n - b * HW : 0;
      const int at = rg * 128 + (((col >> 3) ^ (rg & 7)) << 4) + 2 * (col & 7);
      const unsigned short* zs = reinterpret_cast<const unsigned short*>(z) +
          ((long long)b * Co + o0 + rg) * HW + p;
      const unsigned short* dzs = reinterpret_cast<const unsigned short*>(dz) +
          ((long long)b * Co + o0 + rg) * HW + p;
      const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) +
          ((long long)b * Ci + c0 + rg) * HW + p;
      const long long step = 8LL * HW;
#pragma unroll
      for (int k0 = 0; k0 < MMA_ROWS / 8; k0 += EB) {
        uint32_t zv[EB], dv[EB];
#pragma unroll
        for (int k = 0; k < EB; ++k) {
          const bool ok = in && o0 + rg + 8 * (k0 + k) < Co;
          zv[k] = ok ? __ldg(zs + (k0 + k) * step) : 0u;
          dv[k] = ok ? __ldg(dzs + (k0 + k) * step) : 0u;
        }
#pragma unroll
        for (int k = 0; k < EB; ++k) {
          const int r = rg + 8 * (k0 + k);
          if (o0 + r < Co)
            *reinterpret_cast<bf16*>(st + at + 1024 * (k0 + k)) =
                __float2bfloat16_rn(
                    in ? dz_eff_f(bf_f(dv[k]), bf_f(zv[k]), s_ds[r],
                                  s_dss[r])
                       : 0.f);
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < 64 * NW / 8; k0 += EB) {
        uint32_t xv[EB];
#pragma unroll
        for (int k = 0; k < EB; ++k)
          xv[k] = in && c0 + rg + 8 * (k0 + k) < Ci
              ? __ldg(xs + (k0 + k) * step) : 0u;
#pragma unroll
        for (int k = 0; k < EB; ++k) {
          const int r = rg + 8 * (k0 + k);
          if (c0 + r < Ci)
            *reinterpret_cast<bf16*>(st + 2 * ZB + at + 1024 * (k0 + k)) =
                __float2bfloat16_rn(
                    in ? xn_f(bf_f(xv[k]), s_sc[r], s_sh[r], has_norm, relu)
                       : 0.f);
        }
      }
      return;
    }
    const int n = kb + t * 64 + 8 * cc;
    const Cols8 cols = cols8(n, HW);
#pragma unroll
    for (int j = 0; j < MMA_ROWS / 64; ++j) {
      const int r = cr + 64 * j, o = o0 + r;
      const int at = r * 128 + ((cc ^ (r & 7)) << 4);
      if (o >= Co) continue;
      copy8(st + at, z, cols, n, ke, Co, HW, o, true, vec);
      copy8(st + ZB + at, dz, cols, n, ke, Co, HW, o, true, vec);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int r = cr + 64 * j, c = c0 + r;
      if (c >= Ci) continue;
      copy8(st + 2 * ZB + r * 128 + ((cc ^ (r & 7)) << 4), x, cols, n, ke,
            Ci, HW, c, true, vec);
    }
  };
  auto transform = [&](int t, int slot) {
    const int n = kb + t * 64 + 8 * cc;
    uint8_t* st = ring + slot * STAGE;
#pragma unroll
    for (int j = 0; j < MMA_ROWS / 64; ++j) {
      const int r = cr + 64 * j;
      const int at = r * 128 + ((cc ^ (r & 7)) << 4);
      if (o0 + r < Co) dzb8(st + at, st + ZB + at, s_ds[r], s_dss[r], n, ke);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int r = cr + 64 * j;
      if (c0 + r < Ci)
        xn8(st + 2 * ZB + r * 128 + ((cc ^ (r & 7)) << 4), s_sc[r],
            s_sh[r], has_norm, relu, n, ke);
    }
  };

#pragma unroll
  for (int t = 0; t < DW_NS - 1; ++t) {
    if (t < nt) issue(t, t);
    cp_async_commit();
  }
  const int wg = tid >> 7, rh = wg & 1, cb = (wg >> 1) * NWG;
  float acc[NWG][32];
  // Per stage t: its chunks land (this thread's own copies) and become
  // operands (element loads stored operands already); after the barrier
  // the warpgroups start the products, and stage t + 2 is copied into the
  // slot of stage t - 1, whose products every warpgroup has waited for
  // before the barrier.
  for (int t = 0; t < nt; ++t) {
    const int slot = t % DW_NS;
    cp_async_wait<DW_NS - 2>();
    if (vec != 1) transform(t, slot);
    fence_async_smem();
    wgmma_wait<0>();
    __syncthreads();
    const uint8_t* a = ring + slot * STAGE + rh * TILE_BYTES;
    const uint8_t* b = ring + slot * STAGE + 2 * ZB + cb * TILE_BYTES;
#pragma unroll
    for (int n = 0; n < NWG; ++n) fence_regs(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NWG; ++n)
        wgmma_ss(acc[n], desc(a, k_major_step(kk)),
                 desc(b + n * TILE_BYTES, k_major_step(kk)), t > 0 || kk > 0);
    wgmma_commit();
    if (t + DW_NS - 1 < nt) issue(t + DW_NS - 1, (t + DW_NS - 1) % DW_NS);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NWG; ++n) fence_regs(acc[n]);
  cp_async_wait<0>();

  float* dst = out + (long long)blockIdx.z * Co * Ci;
#pragma unroll
  for (int n = 0; n < NWG; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int o = o0 + 64 * rh + frag_row(i) - 64 * wg;
      const int c = c0 + 64 * (cb + n) + frag_col(i);
      if (o < Co && c < Ci)
        dst[(long long)o * Ci + c] = nt > 0 ? acc[n][i] : 0.f;
    }
}

constexpr int DX_WG = 2;          // dx: consumer warpgroups
constexpr int DX_THREADS = 128 * DX_WG;
constexpr int DX_ROWS = 64 * DX_WG;  // dx: input channels of a block
constexpr int DX_NB = 1;          // dx: 64-column blocks of a column tile
constexpr int DX_NS = 3;          // dx: stages of the tile ring
constexpr int DX_COLS = 64 * DX_NB;
constexpr int DX_A = DX_WG * hopper::TILE_BYTES;   // W: 64 o x DX_ROWS c
static_assert(DX_NS >= 3, "a barrier must separate a stage's copies "
              "by other threads from its transform");
constexpr int DX_Z = DX_NB * hopper::TILE_BYTES;   // z (dz): 64 o rows
constexpr int DX_STAGE = DX_A + 2 * DX_Z;

// the ring, then each stage's ds and dss of its 64 output channels
constexpr int dx_mma_smem() { return DX_NS * (DX_STAGE + 2 * 64 * 4) + 1024; }

// dx on the tensor cores: dxn[c, n] = sum_o W[o, c] dzb[o, n]. Block
// (column tiles j0 .. j0 + per_block - 1 of DX_COLS columns, j0 =
// blockIdx.x / nct * per_block; input-channel tile blockIdx.x % nct of
// DX_ROWS): dx of its tiles and the partials of dscale / dshift over each
// of their 64-column blocks; the input-channel tiles of a column group are
// adjacent blocks, so all but the first read its z and dz from L2. Stage
// t of its ring is output channels 64 (t % nt) .. + 63 of tile j0 + t /
// nt: W[k0 .. k0 + 63][c0 .. c0 + DX_ROWS - 1] (A = W^T read MN-major:
// one 64-column tile a warpgroup) and the z and dz rows k0 .. k0 + 63
// of the tile's columns (B, MN-major), then dzb in place of z; output
// channels past Co are zeros in both. A tile's epilogue runs while the
// next tile's first stages land.
__global__ void __launch_bounds__(DX_THREADS, 2)
fused_conv_bwd_dx_mma(const bf16* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const bf16* __restrict__ w, const bf16* __restrict__ z,
                      const bf16* __restrict__ dz,
                      const float* __restrict__ ds,
                      const float* __restrict__ dss, bf16* __restrict__ dx,
                      float* __restrict__ part, int B, int Ci, int Co, int HW,
                      int P, int has_norm, int relu, int vec, int dxvec,
                      int wide, int per_block) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* vecs = reinterpret_cast<float*>(ring + DX_NS * DX_STAGE);
  const int tid = threadIdx.x;
  const int N = B * HW;
  const int nct = (Ci + DX_ROWS - 1) / DX_ROWS;
  const int grp = blockIdx.x / nct;
  const int c0 = (blockIdx.x - grp * nct) * DX_ROWS;
  const int j0 = grp * per_block;
  const int nj = min(per_block, (N + DX_COLS - 1) / DX_COLS - j0);
  const int nt = (Co + 63) / 64;
  const int T = nj * nt;

  // this thread's z and dz chunks of a stage: column chunk cc of rows
  // cr + RSTEP j; with element loads (vec 1) column tid % DX_COLS of rows
  // tid / DX_COLS + ESTEP k instead
  constexpr int CPR = DX_COLS / 8;
  constexpr int RSTEP = DX_THREADS / CPR;
  constexpr int ESTEP = DX_THREADS / DX_COLS;
  const int cc = tid % CPR, cr = tid / CPR;
  const int ecol = tid % DX_COLS, erow = tid / DX_COLS;

  auto issue = [&](int t) {
    const int slot = t % DX_NS;
    uint8_t* st = ring + slot * DX_STAGE;
    const int n0 = (j0 + t / nt) * DX_COLS, k0 = (t % nt) * 64;
    copy_rows<64, 8 * DX_WG, DX_THREADS>(st, w, Ci, k0, Co, c0, Ci, wide);
    if (tid < 64) {
      const bool ok = k0 + tid < Co;
      vecs[slot * 128 + tid] = ok ? ds[k0 + tid] : 0.f;
      vecs[slot * 128 + 64 + tid] = ok ? dss[k0 + tid] : 0.f;
    }
    uint8_t* zs = st + DX_A;
    if (vec == 1) {
      const int n = n0 + ecol;
      const long long off = n < N ? col_offset(n, Co, HW) : 0;
      copy_elements(zs, z, off, n < N, ecol, erow, ESTEP, k0, Co, HW);
      copy_elements(zs + DX_Z, dz, off, n < N, ecol, erow, ESTEP, k0, Co,
                    HW);
      return;
    }
    const Chunk ck = chunk_at(n0 + 8 * cc, N, Co, HW);
#pragma unroll
    for (int j = 0; j < 64 / RSTEP; ++j) {
      const int r = cr + RSTEP * j, o = k0 + r;
      copy_chunk(zs + sw_off(r, cc), z, ck, (long long)o * HW, o < Co, vec);
      copy_chunk(zs + DX_Z + sw_off(r, cc), dz, ck, (long long)o * HW,
                 o < Co, vec);
    }
  };
  // z and dz chunks -> dzb in place of z (element copies were stored by
  // other threads, which a barrier since then has made visible)
  auto transform = [&](int t) {
    const int slot = t % DX_NS;
    uint8_t* zs = ring + slot * DX_STAGE + DX_A;
    const float* sv = vecs + slot * 128;
    const int n0 = (j0 + t / nt) * DX_COLS, k0 = (t % nt) * 64;
#pragma unroll
    for (int j = 0; j < 64 / RSTEP; ++j) {
      const int r = cr + RSTEP * j;
      if (k0 + r < Co)
        dzb8(zs + sw_off(r, cc), zs + DX_Z + sw_off(r, cc), sv[r],
             sv[64 + r], n0 + 8 * cc, N);
    }
  };

#pragma unroll
  for (int t = 0; t < DX_NS - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  __syncthreads();
  const int wg = tid >> 7, lane = tid & 31, warp = tid >> 5;
  const bool live = c0 + 64 * wg < Ci;     // a warpgroup past Ci idles
  // the epilogue's per-row scale and shift: rows r and r + 8 of a quad
  float sc[2], sh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * warp + (lane >> 2) + 8 * h;
    sc[h] = has_norm && c < Ci ? scale[c] : 1.f;
    sh[h] = has_norm && c < Ci ? shift[c] : 0.f;
  }
  float acc[DX_NB][32];
  // the ring as in fused_conv_fwd_mma: stage t + 2 is copied into the
  // slot of stage t - 1 once every warpgroup has waited for its products
  for (int t = 0; t < T; ++t) {
    const int slot = t % DX_NS, kt = t % nt;
    // a tile's x (for the epilogue's mask and dscale) is loaded at the
    // start of its last stage, so the loads land while the stage's
    // operands are made, its products run and the next copies are issued
    const bool last = kt == nt - 1 && live;
    const int n0 = (j0 + t / nt) * DX_COLS;
    uint32_t xr[DX_NB][16];
    if (last)
#pragma unroll
      for (int n = 0; n < DX_NB; ++n)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = c0 + frag_row(i);
          xr[n][i / 2] = c < Ci ? load_pair(x, n0 + 64 * n + frag_col(i), N,
                                            Ci, HW, c)
                                : 0u;
        }
    cp_async_wait<DX_NS - 2>();
    transform(t);
    fence_async_smem();
    wgmma_wait<0>();
    __syncthreads();
    if (live) {
      const uint8_t* a = ring + slot * DX_STAGE + wg * TILE_BYTES;
      const uint8_t* b = ring + slot * DX_STAGE + DX_A;
#pragma unroll
      for (int n = 0; n < DX_NB; ++n) fence_regs(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < DX_NB; ++n)
          wgmma_ss_t<1, 1>(acc[n], desc(a, mn_major_step(kk, 0)),
                           desc(b, mn_major_step(kk, n)), kt > 0 || kk > 0);
      wgmma_commit();
    }
    if (t + DX_NS - 1 < T) issue(t + DX_NS - 1);
    cp_async_commit();
    if (!last) continue;

    // the epilogue: each thread holds rows r and r + 8 (input channels) of
    // 16 columns of a 64-column block, a quad a row. The ReLU mask from x
    // (pre > 0 with a norm, x > 0 without), dx = dpre * scale, and the
    // partials of dscale (sum dpre * x) and dshift (sum dpre); columns
    // past the end hold dpre = 0 and x = 0, and add nothing. dx in bf16
    // is staged in this warpgroup's W tile of the slot (its products are
    // done, and the slot is not copied into before the next barrier) and
    // stored in whole rows.
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < DX_NB; ++n) fence_regs(acc[n]);
    uint8_t* stage = ring + slot * DX_STAGE + wg * TILE_BYTES;
#pragma unroll
    for (int n = 0; n < DX_NB; ++n) {
      const int nb0 = n0 + 64 * n;
      float dsc[2] = {0.f, 0.f}, dsh[2] = {0.f, 0.f}, d[32];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float x0 = bf_f(xr[n][i / 2]);
        const float x1 = __uint_as_float(xr[n][i / 2] & 0xffff0000u);
        float d0 = acc[n][i], d1 = acc[n][i + 1];
        if (relu) {
          const bool on0 = has_norm ? affine(x0, sc[h], sh[h]) > 0.f
                                    : x0 > 0.f;
          const bool on1 = has_norm ? affine(x1, sc[h], sh[h]) > 0.f
                                    : x1 > 0.f;
          d0 = on0 ? d0 : 0.f;
          d1 = on1 ? d1 : 0.f;
        }
        dsc[h] += d0 * x0 + d1 * x1;
        dsh[h] += d0 + d1;
        d[i] = has_norm ? __fmul_rn(d0, sc[h]) : d0;
        d[i + 1] = has_norm ? __fmul_rn(d1, sc[h]) : d1;
      }
      if (has_norm) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a = quad_sum(dsc[h]), b = quad_sum(dsh[h]);
          const int c = c0 + 16 * warp + (lane >> 2) + 8 * h;
          if ((lane & 3) == 0 && c < Ci && nb0 < N) {
            part[(long long)c * P + nb0 / 64] = a;
            part[(long long)(Ci + c) * P + nb0 / 64] = b;
          }
        }
      }
      wg_sync(wg);
      stage_tile(stage, d, wg);
      wg_sync(wg);
      store_tile(dx, stage, nb0, N, c0 + 64 * wg, Ci, HW, dxvec, tid & 127);
    }
  }
  cp_async_wait<0>();
}

constexpr int dw_mma_smem() {
  return DW_NS * (2 * MMA_ROWS * 128 + DW_NW * hopper::TILE_BYTES) +
         4 * (2 * MMA_ROWS + 2 * 64 * DW_NW) + 1024;
}

// dW (into dw, or the k-range partials in work and their sum) on the
// route the rule picks
int launch_dw(int tc, int dtype, const void* x, const void* scale,
              const void* shift, const void* z, const void* dz,
              const void* ds, const void* dss, void* dw, void* work, int B,
              int Ci, int Co, int HW, int splits, int has_norm, int relu,
              cudaStream_t st) {
  const int N = B * HW;
  // whole k-steps a k-range; splits shrinks to the ranges needed
  const int step = tc ? 64 : TK;
  int k_per_split = (N + splits - 1) / splits;
  k_per_split = (k_per_split + step - 1) / step * step;
  splits = (N + k_per_split - 1) / k_per_split;
  float* out = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(dw);
  const float* scp = static_cast<const float*>(scale);
  const float* shp = static_cast<const float*>(shift);
  const float* dsp = static_cast<const float*>(ds);
  const float* dssp = static_cast<const float*>(dss);
  cudaError_t err = cudaSuccess;
  if (tc) {
    const dim3 g((Ci + 64 * DW_NW - 1) / (64 * DW_NW),
                 (Co + MMA_ROWS - 1) / MMA_ROWS, splits);
    if (g.y > 65535 || g.z > 65535) return (int)cudaErrorInvalidValue;
    const void* ptrs[3] = {x, z, dz};
    const int vec = copy_width(HW, ptrs, 3);
    const int smem = dw_mma_smem();
    err = cudaFuncSetAttribute(fused_conv_bwd_dw_mma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    fused_conv_bwd_dw_mma<<<g, DW_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), scp, shp, static_cast<const bf16*>(z),
        static_cast<const bf16*>(dz), dsp, dssp, out, B, Ci, Co, HW,
        k_per_split, has_norm, relu, vec);
  } else {
    const dim3 g((Ci + TN - 1) / TN, (Co + TM - 1) / TM, splits);
    if (g.y > 65535 || g.z > 65535) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      fused_conv_bwd_dw<float><<<g, THREADS, 0, st>>>(
          static_cast<const float*>(x), scp, shp,
          static_cast<const float*>(z), static_cast<const float*>(dz), dsp,
          dssp, out, B, Ci, Co, HW, k_per_split, has_norm, relu);
    else
      return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = (long long)Co * Ci;
  dw_reduce<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS, 0,
              st>>>(static_cast<const float*>(work),
                    static_cast<float*>(dw), total, splits);
  return (int)cudaGetLastError();
}

// dx and the dscale / dshift partials on the route the rule picks, then
// their fixed-order sum (zeros without a norm)
int launch_dx(int tc, int dtype, const void* x, const void* scale,
              const void* shift, const void* w, const void* z,
              const void* dz, const void* ds, const void* dss, void* dx,
              void* dscale, void* dshift, void* part, int B, int Ci, int Co,
              int HW, int P, int has_norm, int relu, cudaStream_t st) {
  const float* scp = static_cast<const float*>(scale);
  const float* shp = static_cast<const float*>(shift);
  const float* dsp = static_cast<const float*>(ds);
  const float* dssp = static_cast<const float*>(dss);
  float* partp = static_cast<float*>(part);
  cudaError_t err = cudaSuccess;
  if (tc) {
    const int smem = dx_mma_smem();
    err = cudaFuncSetAttribute(fused_conv_bwd_dx_mma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fused_conv_bwd_dx_mma,
          cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, device = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_conv_bwd_dx_mma, DX_THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (B * HW + DX_COLS - 1) / DX_COLS;
    const int rows = (Ci + DX_ROWS - 1) / DX_ROWS;
    const int per_block = tiles_per_block(device, tiles, rows, per_sm);
    const long long blocks =
        (long long)((tiles + per_block - 1) / per_block) * rows;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const void* zp[2] = {z, dz};
    const void* dxp[1] = {dx};
    fused_conv_bwd_dx_mma<<<(unsigned)blocks, DX_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), scp, shp, static_cast<const bf16*>(w),
        static_cast<const bf16*>(z), static_cast<const bf16*>(dz), dsp, dssp,
        static_cast<bf16*>(dx), partp, B, Ci, Co, HW, P, has_norm, relu,
        copy_width(HW, zp, 2), copy_width(HW, dxp, 1), rows_wide(w, Ci),
        per_block);
  } else {
    const float* wp = static_cast<const float*>(w);
    const long long blocks = (long long)P * ((Ci + TM - 1) / TM);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 g((unsigned)blocks);
    if (dtype == 0)
      fused_conv_bwd_dx<float><<<g, THREADS, 0, st>>>(
          static_cast<const float*>(x), scp, shp, wp,
          static_cast<const float*>(z), static_cast<const float*>(dz), dsp,
          dssp, static_cast<float*>(dx), partp, B, Ci, Co, HW, P, has_norm,
          relu);
    else
      fused_conv_bwd_dx<bf16><<<g, THREADS, 0, st>>>(
          static_cast<const bf16*>(x), scp, shp, wp,
          static_cast<const bf16*>(z), static_cast<const bf16*>(dz), dsp,
          dssp, static_cast<bf16*>(dx), partp, B, Ci, Co, HW, P, has_norm,
          relu);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (has_norm) {
    reduce_partials<<<Ci, THREADS, 0, st>>>(partp,
                                            static_cast<float*>(dscale),
                                            static_cast<float*>(dshift), Ci,
                                            P);
    return (int)cudaGetLastError();
  }
  err = cudaMemsetAsync(dscale, 0, sizeof(float) * Ci, st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dshift, 0, sizeof(float) * Ci, st);
  return (int)err;
}

}  // namespace

// 1 when pt_fused_conv_bwd runs a product on the tensor cores, 0 when on
// the SIMT kernel, for an x of type dtype and a W of type wdtype (0
// float32, 1 bf16). product 0, dx: both bf16, whose products dzb * W are
// exact in float32 (a bf16 x with a float32 W promotes them to float32);
// product 1, dW: a bf16 x, whose dW operands (dz_eff and the normalized
// activation) are bf16 whatever W's type. The rule of the entry point,
// asked by the wrapper to pass W in the type dx takes and to count the
// launches of each route.
extern "C" int pt_fused_conv_bwd_tensor_cores(int dtype, int wdtype,
                                              int product) {
  return product == 0 ? dtype == 1 && wdtype == 1 : dtype == 1;
}

// How many k-ranges of the B * HW columns pt_fused_conv_bwd's dW blocks
// take for an x of type dtype (the `splits` the caller passes, and sizes
// `work` by): on the CUDA cores enough for ~528 blocks of a 64 x 64 tile
// (four an SM on the H100's 132), on the tensor cores as many as fit in
// 264 blocks of a 128 x 256 tile (two waves of one block an SM); each
// k-range at least 512 columns.
extern "C" int pt_fused_conv_bwd_splits(int dtype, int B, int Ci, int Co,
                                        int HW) {
  const long long N = (long long)B * HW;
  const bool tc = pt_fused_conv_bwd_tensor_cores(dtype, 0, 1);
  const long long rows = tc ? MMA_ROWS : TM, cols = tc ? 64 * DW_NW : TN;
  const long long tiles = ((Co + rows - 1) / rows) * ((Ci + cols - 1) / cols);
  if (tiles == 0) return 1;
  const long long per_tile = tc ? 264 / tiles : (528 + tiles - 1) / tiles;
  const long long s = per_tile < N / 512 ? per_tile : N / 512;
  return s > 1 ? (int)s : 1;
}

// C entry point, bound with ctypes. dtype: 0 float32, 1 bf16 (x, z, dz
// and dx); wdtype: W's, 1 (bf16) only where dx runs on the tensor cores
// (a bf16 x), else 0. x [B, Ci, HW], W [Co, Ci], z and dz [B, Co, HW],
// ds, dss [Co] and scale / shift [Ci] float32 (null without a norm), all
// contiguous; dx [B, Ci, HW]; dw [Co, Ci], dscale, dshift [Ci] float32;
// part: float32 scratch of 2 * Ci * P, P = ceil(B * HW / 64); work:
// float32 scratch of splits * Co * Ci (`pt_fused_conv_bwd_splits`; null
// for 1). Returns the first failing cudaError_t.
extern "C" int pt_fused_conv_bwd(int device, int dtype, int wdtype,
                                 const void* x, const void* scale,
                                 const void* shift, const void* w,
                                 const void* z, const void* dz,
                                 const void* ds, const void* dss, void* dx,
                                 void* dw, void* dscale, void* dshift,
                                 void* part, void* work, int B, int Ci,
                                 int Co, int HW, int P, int splits,
                                 int has_norm, int relu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long N = (long long)B * HW;
  if (B < 0 || Ci < 0 || Co < 0 || HW < 0 || N > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || (wdtype != 0 && wdtype != 1) ||
      (wdtype == 1 && dtype != 1) || P != (int)((N + TN - 1) / TN) ||
      splits < 1 || (splits > 1 && work == nullptr) ||
      (has_norm && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  if (Ci == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || Co == 0) {   // no products: dx, dW, dscale, dshift = 0
    void* zeroed[4] = {dx, dw, dscale, dshift};
    const size_t bytes[4] = {(size_t)N * Ci * (dtype == 1 ? 2 : 4),
                             sizeof(float) * Co * Ci, sizeof(float) * Ci,
                             sizeof(float) * Ci};
    for (int i = 0; i < 4; ++i) {
      err = cudaMemsetAsync(zeroed[i], 0, bytes[i], st);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  const int e = launch_dx(pt_fused_conv_bwd_tensor_cores(dtype, wdtype, 0),
                          dtype, x, scale, shift, w, z, dz, ds, dss, dx,
                          dscale, dshift, part, B, Ci, Co, HW, P, has_norm,
                          relu, st);
  if (e != 0) return e;
  return launch_dw(pt_fused_conv_bwd_tensor_cores(dtype, wdtype, 1), dtype,
                   x, scale, shift, z, dz, ds, dss, dw, work, B, Ci, Co, HW,
                   splits, has_norm, relu, st);
}
