// Fused 1x1-conv + BatchNorm forward for Hopper (sm_90a):
//   z[b, o, p] = sum_c W[o, c] * xn[b, c, p],
//   xn = act(f32(x) * scale[c] + shift[c]) rounded to x's type (or act(x)),
//   s[o] = sum_{b,p} z_f32[b, o, p],  ss[o] = sum_{b,p} z_f32[b, o, p]^2,
// with x [B, Ci, HW] float32 or bf16, z [B, Co, HW] in x's type, W
// [Co, Ci] bf16 (with a bf16 x) or float32, scale / shift [Ci] float32
// (unused without a norm).
//
// Replaces: paddle_tpu/ops/fused_conv.py `_fwd_call` (the Pallas kernel
// behind `fused_scale_act_mm_stats`). Same math: the normalize runs in
// float32, the activation is rounded to x's type before the product, the
// product accumulates in float32, and the stats come from the float32 z
// before it is rounded for the store. The TPU kernel took one whole image
// per grid step and carried the stats across its sequential grid; here
// blocks run in parallel in no order, so each block writes the stats of
// its own tile as partials and a second pass adds them in a fixed order
// (no float atomics: the stats do not change from run to run).
//
// What bounds it on an H100, and what the design does about it: at
// ResNet-50's bottleneck shapes (batch 128) the work is 2 * B * Co * Ci *
// HW operations (3.3-13.2 GFLOP) against reading x and writing z once.
//
// bf16 x and bf16 W (the ResNet path): the products run on the tensor
// cores (bf16 wgmma m64n64k16, float32 accumulators; hopper_mma.cuh),
// where they take 0.003-0.013 ms, so the kernel is a stream over x and z.
// Each product is exact in float32, as in the plain version; only the
// order of the float32 sums differs. A block owns 128 output channels
// (two consumer warpgroups of 64) of a run of column tiles (128 columns
// of the flattened (image, position) axis each, two 64-column blocks),
// enough runs for one wave of the card; the output-channel tiles of a run
// are adjacent blocks, so x comes from device memory once and from L2
// after that. A ring of three stages of 64 input channels runs on from
// one tile into the next: W's rows (K-major) and x's rows (MN-major, n
// contiguous within an image) land by cp.async, 16 bytes a thread when
// HW is a multiple of 8, 8 when of 4, else by element loads (HW 49); each
// thread turns the x chunks it copied into xn in place (fused_conv_mma.cuh
// `xn8`), and the stage goes to wgmma while the next ones land. A tile's
// epilogue sums the unrounded float32 fragments of each row across the
// quad that holds it into the 64-column blocks' partials of the stats,
// and rounds z to bf16 into the warpgroup's spent W rows of the ring, to
// store it in whole 128-byte rows rather than in the fragments' scattered
// 4-byte pieces (z is the larger stream at the Co > Ci shapes).
//
// float32 x, or a bf16 x with a float32 W (whose products promote to
// float32): float32 FMAs on the CUDA cores (the port's contract has no
// TF32), operation-bound on them: the classic register-tiled product, a
// block owns 64 output channels x 64 columns, stages 16-deep slices of W
// and of the activation in shared memory, and each thread keeps a 4 x 4
// tile of sums; the activation is computed while staging, from x, and the
// stats are reduced across a half-warp with shuffles in the epilogue, so
// z is never read back. `pt_fused_conv_fwd_tensor_cores` is the route
// rule; the wrapper asks it to count the launches of each route.

#include "fused_conv.cuh"
#include "fused_conv_mma.cuh"

namespace {

using namespace fc;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_conv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const float* __restrict__ w, T* __restrict__ z,
                      float* __restrict__ part, int B, int Ci, int Co, int HW,
                      int P, int has_norm, int relu) {
  __shared__ __align__(16) float ws[TK][TM + 4];   // W slice: ws[k][o]
  __shared__ __align__(16) float xs[TK][TN + 4];   // xn slice: xs[k][col]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = B * HW;
  const int n0 = blockIdx.x * TN, o0 = blockIdx.y * TM;
  // the column this thread stages, fixed over the whole loop
  const int lc = tid & (TN - 1), lk = tid >> 6;
  const bool col_ok = n0 + lc < N;
  const long long xoff = col_ok ? col_offset(n0 + lc, Ci, HW) : 0;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += TK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * THREADS;          // 64 rows x 16 k
      const int r = idx >> 4, kk = idx & 15;
      const int o = o0 + r, k = k0 + kk;
      ws[kk][r] = (o < Co && k < Ci) ? w[(long long)o * Ci + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = lk + 4 * u, k = k0 + kk;
      xs[kk][lc] = (col_ok && k < Ci)
          ? act_in<T>(x[xoff + (long long)k * HW], scale, shift, k,
                      has_norm, relu)
          : 0.f;
    }
    __syncthreads();
    mma_slice(ws, xs, acc, ty, tx);
    __syncthreads();
  }

  // z in x's type; the stats of the float32 z over this tile's columns
  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const long long zoff = col_offset(n, Co, HW);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = o0 + ty * 4 + i;
      if (o < Co) z[zoff + (long long)o * HW] = from_f<T>(acc[i][j]);
      s[i] += acc[i][j];
      ss[i] += acc[i][j] * acc[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = half_warp_sum(s[i]), b = half_warp_sum(ss[i]);
    const int o = o0 + ty * 4 + i;
    if (tx == 0 && o < Co) {
      part[(long long)o * P + blockIdx.x] = a;
      part[(long long)(Co + o) * P + blockIdx.x] = b;
    }
  }
}

// ---------------------------------------------------- bf16 on wgmma

constexpr int MMA_THREADS = 256;  // two consumer warpgroups
constexpr int MMA_ROWS = 128;     // output channels of a block (64 a warpgroup)
constexpr int MMA_NB = 2;         // 64-column blocks of a column tile
constexpr int MMA_NS = 3;         // stages of the tile ring
constexpr int MMA_COLS = 64 * MMA_NB;
static_assert(MMA_NS >= 3, "a barrier must separate a stage's copies by "
              "other threads from its transform");
constexpr int MMA_A = MMA_ROWS * 128;                  // W: 128 rows x 64 k
constexpr int MMA_STAGE = MMA_A + MMA_NB * hopper::TILE_BYTES;  // + x: 64 k
// the ring, then each stage's scale and shift of its 64 input channels
constexpr int fwd_mma_smem() {
  return MMA_NS * (MMA_STAGE + 2 * 64 * 4) + 1024;
}

// Block (column tiles j0 .. j0 + per_block - 1 of MMA_COLS columns, j0 =
// blockIdx.x / nrt * per_block; output-channel tile blockIdx.x % nrt of
// MMA_ROWS): z of its tiles and the partials of the stats over each of
// their 64-column blocks. Stage t of its ring is input channels 64 (t %
// nt) .. + 63 of tile j0 + t / nt: W[o0 .. o0 + 127][k0 .. k0 + 63]
// (K-major, 128-byte rows) and x[k0 .. k0 + 63][the tile's columns]
// (MN-major: MMA_NB 64-column tiles), then xn in place of x; input
// channels past Ci are zeros in both. A tile's epilogue runs while the
// next tile's first stages land.
__global__ void __launch_bounds__(MMA_THREADS, 2)
fused_conv_fwd_mma(const bf16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const bf16* __restrict__ w,
                   bf16* __restrict__ z, float* __restrict__ part, int B,
                   int Ci, int Co, int HW, int P, int has_norm, int relu,
                   int vec, int zvec, int wide, int per_block) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* vecs = reinterpret_cast<float*>(ring + MMA_NS * MMA_STAGE);
  const int tid = threadIdx.x;
  const int N = B * HW;
  const int nrt = (Co + MMA_ROWS - 1) / MMA_ROWS;
  const int grp = blockIdx.x / nrt;
  const int o0 = (blockIdx.x - grp * nrt) * MMA_ROWS;
  const int j0 = grp * per_block;
  const int nj = min(per_block, (N + MMA_COLS - 1) / MMA_COLS - j0);
  const int nt = (Ci + 63) / 64;
  const int T = nj * nt;

  // this thread's x chunks of a stage: column chunk cc (8 columns) of rows
  // cr + RSTEP j, which it copies and turns into xn; with element loads
  // (vec 1) it copies column tid % MMA_COLS of rows tid / MMA_COLS +
  // ESTEP k instead, so a warp reads 32 adjacent columns
  constexpr int CPR = MMA_COLS / 8;
  constexpr int RSTEP = MMA_THREADS / CPR;
  constexpr int ESTEP = MMA_THREADS / MMA_COLS;
  const int cc = tid % CPR, cr = tid / CPR;
  const int ecol = tid % MMA_COLS, erow = tid / MMA_COLS;

  auto issue = [&](int t) {
    const int slot = t % MMA_NS;
    uint8_t* st = ring + slot * MMA_STAGE;
    const int n0 = (j0 + t / nt) * MMA_COLS, k0 = (t % nt) * 64;
    copy_rows<MMA_ROWS, 8, MMA_THREADS>(st, w, Ci, o0, Co, k0, Ci, wide);
    if (tid < 64) {
      const bool ok = has_norm && k0 + tid < Ci;
      vecs[slot * 128 + tid] = ok ? scale[k0 + tid] : 1.f;
      vecs[slot * 128 + 64 + tid] = ok ? shift[k0 + tid] : 0.f;
    }
    uint8_t* xs = st + MMA_A;
    if (vec == 1) {
      const int n = n0 + ecol;
      copy_elements(xs, x, n < N ? col_offset(n, Ci, HW) : 0, n < N, ecol,
                    erow, ESTEP, k0, Ci, HW);
      return;
    }
    const Chunk ck = chunk_at(n0 + 8 * cc, N, Ci, HW);
#pragma unroll
    for (int j = 0; j < 64 / RSTEP; ++j) {
      const int r = cr + RSTEP * j, c = k0 + r;
      copy_chunk(xs + sw_off(r, cc), x, ck, (long long)c * HW, c < Ci, vec);
    }
  };
  // x chunks -> xn in place; chunks copied by element loads were stored
  // by other threads, which a barrier since then has made visible
  auto transform = [&](int t) {
    const int slot = t % MMA_NS;
    uint8_t* xs = ring + slot * MMA_STAGE + MMA_A;
    const float* sv = vecs + slot * 128;
    const int n0 = (j0 + t / nt) * MMA_COLS, k0 = (t % nt) * 64;
#pragma unroll
    for (int j = 0; j < 64 / RSTEP; ++j) {
      const int r = cr + RSTEP * j;
      if (k0 + r < Ci)
        xn8(xs + sw_off(r, cc), sv[r], sv[64 + r], has_norm, relu,
            n0 + 8 * cc, N);
    }
  };

#pragma unroll
  for (int t = 0; t < MMA_NS - 1; ++t) {
    if (t < T) issue(t);
    cp_async_commit();
  }
  __syncthreads();
  const int wg = tid >> 7, lane = tid & 31, warp = tid >> 5;
  const bool live = o0 + 64 * wg < Co;     // a warpgroup past Co idles
  float acc[MMA_NB][32];
  // Per stage t: its chunks land (this thread's own copies) and become
  // operands; after the barrier the warpgroups start the products, and
  // stage t + 2 is copied into the slot of stage t - 1, whose products
  // every warpgroup has waited for before the barrier. After a tile's
  // last stage its products are waited for and its epilogue runs.
  for (int t = 0; t < T; ++t) {
    const int slot = t % MMA_NS, kt = t % nt;
    cp_async_wait<MMA_NS - 2>();
    transform(t);
    fence_async_smem();
    wgmma_wait<0>();
    __syncthreads();
    if (live) {
      const uint8_t* a = ring + slot * MMA_STAGE + wg * TILE_BYTES;
      const uint8_t* b = ring + slot * MMA_STAGE + MMA_A;
#pragma unroll
      for (int n = 0; n < MMA_NB; ++n) fence_regs(acc[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < MMA_NB; ++n)
          wgmma_ss_t<0, 1>(acc[n], desc(a, k_major_step(kk)),
                           desc(b, mn_major_step(kk, n)), kt > 0 || kk > 0);
      wgmma_commit();
    }
    if (t + MMA_NS - 1 < T) issue(t + MMA_NS - 1);
    cp_async_commit();
    if (kt != nt - 1 || !live) continue;

    // the stats of the float32 z: each thread holds rows r and r + 8 of
    // 16 columns of a 64-column block, a quad a row; then z in bf16,
    // staged in this warpgroup's W rows of the slot (its products are
    // done, and the slot is not copied into before the next barrier) and
    // stored in whole rows
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < MMA_NB; ++n) fence_regs(acc[n]);
    const int n0 = (j0 + t / nt) * MMA_COLS;
    uint8_t* stage = ring + slot * MMA_STAGE + wg * TILE_BYTES;
#pragma unroll
    for (int n = 0; n < MMA_NB; ++n) {
      const int nb0 = n0 + 64 * n;
      float s[2] = {0.f, 0.f}, ss[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float v0 = acc[n][i], v1 = acc[n][i + 1];
        s[h] += v0 + v1;
        ss[h] += v0 * v0 + v1 * v1;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a = quad_sum(s[h]), b = quad_sum(ss[h]);
        const int o = o0 + 16 * warp + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && o < Co && nb0 < N) {
          part[(long long)o * P + nb0 / 64] = a;
          part[(long long)(Co + o) * P + nb0 / 64] = b;
        }
      }
      wg_sync(wg);
      stage_tile(stage, acc[n], wg);
      wg_sync(wg);
      store_tile(z, stage, nb0, N, o0 + 64 * wg, Co, HW, zvec, tid & 127);
    }
  }
  cp_async_wait<0>();
}

// The product with per-tile stats on the route the rule picks, then
// their fixed-order sum
int launch(int tc, int dtype, const void* x, const void* scale,
           const void* shift, const void* w, void* z, void* s, void* ss,
           void* part, int B, int Ci, int Co, int HW, int P, int has_norm,
           int relu, cudaStream_t st) {
  const float* scp = static_cast<const float*>(scale);
  const float* shp = static_cast<const float*>(shift);
  float* partp = static_cast<float*>(part);
  if (tc) {
    const int smem = fwd_mma_smem();
    cudaError_t err = cudaFuncSetAttribute(
        fused_conv_fwd_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fused_conv_fwd_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
          100);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, device = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_conv_fwd_mma, MMA_THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (B * HW + MMA_COLS - 1) / MMA_COLS;
    const int rows = (Co + MMA_ROWS - 1) / MMA_ROWS;
    const int per_block = tiles_per_block(device, tiles, rows, per_sm);
    const long long blocks =
        (long long)((tiles + per_block - 1) / per_block) * rows;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const void* xp[1] = {x};
    const void* zp[1] = {z};
    fused_conv_fwd_mma<<<(unsigned)blocks, MMA_THREADS, smem, st>>>(
        static_cast<const bf16*>(x), scp, shp, static_cast<const bf16*>(w),
        static_cast<bf16*>(z), partp, B, Ci, Co, HW, P, has_norm, relu,
        copy_width(HW, xp, 1), copy_width(HW, zp, 1), rows_wide(w, Ci),
        per_block);
  } else {
    const dim3 grid(P, (Co + TM - 1) / TM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const float* wp = static_cast<const float*>(w);
    if (dtype == 0)
      fused_conv_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), scp, shp, wp, static_cast<float*>(z),
          partp, B, Ci, Co, HW, P, has_norm, relu);
    else
      fused_conv_fwd_kernel<bf16><<<grid, THREADS, 0, st>>>(
          static_cast<const bf16*>(x), scp, shp, wp, static_cast<bf16*>(z),
          partp, B, Ci, Co, HW, P, has_norm, relu);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<Co, THREADS, 0, st>>>(partp, static_cast<float*>(s),
                                          static_cast<float*>(ss), Co, P);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when pt_fused_conv_fwd runs its products on the tensor cores for an x
// of type dtype and a W of type wdtype (0 float32, 1 bf16): both bf16,
// whose products are exact in float32; 0 for the SIMT kernel (a float32
// x, or a bf16 x with a float32 W: float32 products). The one rule of the
// entry point, asked by the wrapper to pass W in the type the route takes
// and to count the launches of each route.
extern "C" int pt_fused_conv_fwd_tensor_cores(int dtype, int wdtype) {
  return dtype == 1 && wdtype == 1;
}

// C entry point, bound with ctypes. dtype: 0 float32, 1 bf16 (x and z);
// wdtype: W's, 1 (bf16) only with a bf16 x (the tensor-core route), else
// 0. x [B, Ci, HW], W [Co, Ci], scale / shift [Ci] float32 (null without
// a norm), all contiguous; z [B, Co, HW]; s, ss [Co] float32; part:
// float32 scratch of 2 * Co * P, P = ceil(B * HW / 64) (the number of
// 64-column tiles). Two launches: the tiled product with per-tile stats,
// then their fixed-order sum. Returns the first failing cudaError_t.
extern "C" int pt_fused_conv_fwd(int device, int dtype, int wdtype,
                                 const void* x, const void* scale,
                                 const void* shift, const void* w, void* z,
                                 void* s, void* ss, void* part, int B, int Ci,
                                 int Co, int HW, int P, int has_norm,
                                 int relu, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long N = (long long)B * HW;
  if (B < 0 || Ci < 0 || Co < 0 || HW < 0 || N > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || (wdtype != 0 && wdtype != 1) ||
      (wdtype == 1 && dtype != 1) || P != (int)((N + TN - 1) / TN) ||
      (has_norm && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  if (Co == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0 || Ci == 0) {   // z = 0 (no products) and its stats
    const size_t zb = (size_t)N * Co * (dtype == 1 ? 2 : 4);
    err = cudaMemsetAsync(z, 0, zb, st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(s, 0, sizeof(float) * Co, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(ss, 0, sizeof(float) * Co, st);
  }
  return launch(pt_fused_conv_fwd_tensor_cores(dtype, wdtype), dtype, x,
                scale, shift, w, z, s, ss, part, B, Ci, Co, HW, P, has_norm,
                relu, st);
}
