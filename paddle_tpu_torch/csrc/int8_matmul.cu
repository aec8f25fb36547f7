// Scaled int8-weight matmul for Hopper (sm_90a):
//   out[i, j] = scale[j] * sum_k x[i, k] * float(q[k, j])
// with x [m, d] float32, q [d, n] int8 row-major (the JAX layout, so a JAX
// state_dict loads as it is), scale [n] float32 and out [m, n] float32.
// The wrapper (ops/quant.py `int8_matmul`) casts a bf16 x to float32
// first, and casts the result back and adds the bias afterwards.
//
// Replaces: paddle_tpu/ops/quant.py `_int8_matmul_call` (the Pallas
// blocked kernel behind `int8_matmul`). Same math: the int8 tile is
// upcast (exactly, to float32 or bf16), the product accumulates in
// float32 and the per-column scale multiplies the sum. Differences by design: any m, n
// and d (every edge is masked), where the TPU kernel needed m and n to
// be tiled by its block ladder.
//
// What bounds it on an H100, and what the design does about it:
//  * A decode or verify step (m = slots x tokens = 8 or 32) reads the
//    whole weight for a few rows: device-memory bandwidth bounds it (the
//    vocabulary projection moves 18.9 MB of int8 for m = 8). The skinny
//    path gives every block only 32 output columns (one a lane), so
//    n = 37000 spreads over 1157 blocks; the block's 8 warps split the
//    reduction over d and add their partial sums in shared memory at the
//    end. Where that leaves too few blocks (n = 512 gives 16 column
//    strips), d is also split across blocks (`splits`, chosen by the
//    wrapper for at least two blocks an SM): each block reduces one
//    256-wide k-range into a float32 partial, and a second pass adds the
//    partials in a fixed order and applies the scale, so the result does
//    not depend on scheduling. The x rows are staged in shared
//    memory once per 256-wide chunk of d and read as float4 (4 k at a
//    time, a broadcast); each lane reads the weight bytes of its column
//    one by one, so a warp reads 32 consecutive bytes of a row. Byte
//    loads are also what makes n = 37000 safe: row k starts at byte
//    k * 37000, which is 8- but not 16-byte aligned, so no vector load
//    along n is ever issued.
//  * A prefill (m = the prompt bucket, up to 1024) is operation bound.
//    The tiled path runs it on the tensor cores with x in three bf16
//    pieces: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)
//    sum to x exactly (|x| >= 2^-110), an int8 weight is exact in bf16,
//    and each piece times it is exact in float32, so the only error is
//    the float32 order of the sum, within the float32 limit (1e-5 of
//    the largest entry) where one bf16 piece is not. Three bf16 passes
//    at 989 TFLOP/s cost less than two TF32 ones at 495. A block of two
//    warpgroups computes 128 rows x 128 columns: 32-deep slices of x
//    (float32, 16-byte cp.async where its rows allow, else 4) and of the
//    int8 weight land in a four-stage ring; the weight slice is upcast
//    once to bf16 in a 128-byte-swizzled tile read MN-major by wgmma (q
//    is [d, n] row-major); each thread splits its A fragments of x into
//    the three pieces in registers, and m64n64k16 wgmmas add lo, mid and
//    hi into float32 accumulators; the scale multiplies them in the
//    epilogue, stored two columns a lane (8 bytes, whole 32-byte
//    sectors). A weight row starts at byte k * n: with n = 37000 on 8
//    bytes, not 16, so the weight's copies are 16 bytes a thread only
//    when n % 16 == 0 (and q is on 16 bytes), else 8, 4 or single bytes
//    (`weight_vec`). A grid of few tiles (n = 512 at a prompt bucket: 32
//    tiles) splits d across blocks as the skinny path does (`splits`,
//    chosen by the wrapper), the partials added in k order by the second
//    pass. Shorter k-ranges in the tensor-core accumulators, summed in
//    float32 there, also cut the error of a long d (on an H100 at d =
//    2048: 1.2e-6 of the largest entry against 5.7e-6 unsplit).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// ---- skinny path: m <= 32 ----
constexpr int SK_COLS = 32;            // output columns per block
constexpr int SK_KC = WARPS * 32;      // k per staged chunk (32 per warp)

// Block (column strip blockIdx.x, k-range blockIdx.y of k_per_split):
// with `partial` null it writes scale * sum to out; otherwise the
// unscaled sum of its k-range to partial[blockIdx.y][m][n].
template <int BM>
__global__ void __launch_bounds__(THREADS)
int8_matmul_skinny(const float* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   float* __restrict__ out, float* __restrict__ partial,
                   int m, int d, int n, int k_per_split) {
  // the x chunk [BM][SK_KC]; after the loop, the warps' partial sums
  // [WARPS][BM][32] (the same number of floats)
  __shared__ __align__(16) float xs[BM * SK_KC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x * SK_COLS + lane;
  const bool col_ok = c < n;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(d, k_begin + k_per_split);
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += SK_KC) {
    const int kc = min(SK_KC, k_end - k0);
    for (int idx = tid; idx < BM * SK_KC; idx += THREADS) {
      const int i = idx / SK_KC, kk = idx % SK_KC;
      xs[idx] = (i < m && kk < kc) ? x[(long long)i * d + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const int kk = warp * 32 + j;
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = kk + u < kc
              ? static_cast<float>(q[(long long)(k0 + kk + u) * n + c])
              : 0.f;
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[i * SK_KC + kk]);
          acc[i] = fmaf(xv.x, w[0], acc[i]);
          acc[i] = fmaf(xv.y, w[1], acc[i]);
          acc[i] = fmaf(xv.z, w[2], acc[i]);
          acc[i] = fmaf(xv.w, w[3], acc[i]);
        }
      }
    }
    __syncthreads();
  }

  float* red = xs;
#pragma unroll
  for (int i = 0; i < BM; ++i) red[(warp * BM + i) * 32 + lane] = acc[i];
  __syncthreads();
  for (int o = tid; o < BM * 32; o += THREADS) {
    const int i = o >> 5, l = o & 31;
    const int col = blockIdx.x * SK_COLS + l;
    if (i < m && col < n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * BM + i) * 32 + l];
      if (partial != nullptr)
        partial[((long long)blockIdx.y * m + i) * n + col] = s;
      else
        out[(long long)i * n + col] = s * scale[col];
    }
  }
}

// The second pass of a split skinny product: out = scale * the sum of the
// k-range partials, added in k order.
__global__ void __launch_bounds__(THREADS)
int8_matmul_reduce(const float* __restrict__ partial,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int m, int n, int splits) {
  const long long mn = (long long)m * n;
  const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (o >= mn) return;
  float s = 0.f;
  for (int t = 0; t < splits; ++t) s += partial[t * mn + o];
  out[o] = s * scale[o % n];
}

// ---- tiled path: m > 32, on the tensor cores ----
constexpr int TM = 128, TN = 128, TK = 32;  // rows, columns, k a stage
constexpr int TSTAGES = 4;                  // the cp.async ring
constexpr int TTHREADS = 256;               // two warpgroups, 64 rows each
constexpr int XLD = TK + 8;                 // floats a row of an x stage
constexpr int X_BYTES = TM * XLD * 4;
constexpr int W_BYTES = TK * TN;            // the int8 weight tile
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
constexpr int SUB_BYTES = TK * 128;         // a 64-column bf16 sub-tile
constexpr int B_BYTES = 2 * SUB_BYTES;      // the upcast weight tile
constexpr int T_SMEM = 1024 + B_BYTES + TSTAGES * STAGE_BYTES;

// two int8 values (bytes 2 half and 2 half + 1 of w) as bf16x2 (exact)
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t w, int half) {
  const int8_t lo = static_cast<int8_t>(w >> (16 * half));
  const int8_t hi = static_cast<int8_t>(w >> (16 * half + 8));
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}

// v (two neighbouring float32 values of x) as three bf16x2 pieces with
// v = hi + mid + lo exactly (for |v| >= 2^-110; each remainder is exact in
// float32 and the last has at most 8 significant bits)
__device__ __forceinline__ void pieces(float2 v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(v.x - hf.x, v.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r.x - mf.x, r.y - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Block (row tile blockIdx.x, column tile blockIdx.y): out[128 x 128] =
// scale * x . q, two warpgroups of 64 rows each. Per 32-deep k stage: the
// x slice (float32) and the int8 weight slice land by cp.async in a ring
// of TSTAGES; the weight slice is upcast once to bf16 in a swizzled tile
// read MN-major; each thread splits its A fragments of x into three bf16
// pieces in registers; 2 k-steps x 3 pieces x 2 column halves of
// m64n64k16 wgmma add lo, mid, then hi into the float32 accumulators.
// xvec: x's rows start on 16 bytes (16-byte copies, else 4); wvec: the
// weight copy's bytes a thread (16, 8 or 4; 1 = byte loads). blockIdx.z
// is the k-range [z k_per_split, (z + 1) k_per_split): with `partial` null
// the block writes scale * sum to out, else the unscaled sum of its range
// to partial[z][m][n] (int8_matmul_reduce adds them in k order).
__global__ void __launch_bounds__(TTHREADS, 2)
int8_matmul_wgmma(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  float* __restrict__ partial, int m, int d, int n,
                  int k_per_split, int xvec, int wvec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bt = base;                  // [2 sub-tiles][TK rows][128 bytes]
  uint8_t* ring = base + B_BYTES;      // TSTAGES x (x slice, int8 slice)
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(d, kbeg + k_per_split);
  const int nk = kend > kbeg ? (kend - kbeg + TK - 1) / TK : 0;

  auto fetch = [&](int kt, int s) {
    const int k0 = kbeg + kt * TK;
    float* xs = reinterpret_cast<float*>(ring + s * STAGE_BYTES);
    int8_t* ws = reinterpret_cast<int8_t*>(ring + s * STAGE_BYTES + X_BYTES);
    if (xvec) {
      for (int i = tid; i < TM * (TK / 4); i += TTHREADS) {
        const int r = i / (TK / 4), c = 4 * (i % (TK / 4));
        const bool ok = m0 + r < m && k0 + c < kend;
        hopper::cp_async16(xs + r * XLD + c,
                           ok ? x + (long long)(m0 + r) * d + k0 + c : x,
                           ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < TM * TK; i += TTHREADS) {
        const int r = i / TK, c = i % TK;
        const bool ok = m0 + r < m && k0 + c < kend;
        hopper::cp_async4(xs + r * XLD + c,
                          ok ? x + (long long)(m0 + r) * d + k0 + c : x,
                          ok ? 4 : 0);
      }
    }
    if (wvec >= 4) {
      const int per = TN / wvec;       // copies a row
      for (int i = tid; i < TK * per; i += TTHREADS) {
        const int r = i / per, c = wvec * (i % per);
        const bool ok = k0 + r < kend && n0 + c < n;
        const int8_t* src = ok ? q + (long long)(k0 + r) * n + n0 + c : q;
        int8_t* dst = ws + r * TN + c;
        if (wvec == 16)
          hopper::cp_async16(dst, src, ok ? 16 : 0);
        else if (wvec == 8)
          hopper::cp_async8(dst, src, ok ? 8 : 0);
        else
          hopper::cp_async4(dst, src, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < TK * TN; i += TTHREADS) {
        const int r = i / TN, c = i % TN;
        ws[i] = (k0 + r < kend && n0 + c < n)
            ? q[(long long)(k0 + r) * n + n0 + c] : static_cast<int8_t>(0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) fetch(s, s);
    hopper::cp_async_commit();
  }
  float acc[2][32];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<TSTAGES - 2>();   // stage kt has landed
    __syncthreads();              // ... for every thread; kt - 1 is done
    if (kt + TSTAGES - 1 < nk)
      fetch(kt + TSTAGES - 1, (kt + TSTAGES - 1) % TSTAGES);
    hopper::cp_async_commit();
    const uint8_t* st = ring + (kt % TSTAGES) * STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(st);
    const int8_t* ws = reinterpret_cast<const int8_t*>(st + X_BYTES);

    // the weight slice as bf16: row r (k), 16-byte chunk c (8 columns) of
    // sub-tile nb at chunk c ^ (r % 8) of its row (hopper_mma.cuh)
    for (int i = tid; i < TK * 16; i += TTHREADS) {
      const int r = i >> 4, cc = i & 15, nb = cc >> 3, c = cc & 7;
      const uint2 w = *reinterpret_cast<const uint2*>(ws + r * TN + 8 * cc);
      uint4 o;
      o.x = bf16x2_of(w.x, 0);
      o.y = bf16x2_of(w.x, 1);
      o.z = bf16x2_of(w.y, 0);
      o.w = bf16x2_of(w.y, 1);
      *reinterpret_cast<uint4*>(bt + nb * SUB_BYTES + r * 128 +
                                ((c ^ (r & 7)) << 4)) = o;
    }
    hopper::fence_async_smem();
    __syncthreads();

    // A: this thread's fragments of x (the accumulator layout of each
    // 16-deep k-step), in three bf16 pieces
    uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const float2 v = *reinterpret_cast<const float2*>(
            xs + hopper::frag_row(i) * XLD + hopper::frag_col(i));
        pieces(v, ah[kk][j], am[kk][j], al[kk][j]);
      }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) hopper::fence_regs(acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        hopper::wgmma_rs(acc[nb], al[kk],
                         hopper::desc(bt, nb * SUB_BYTES + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        hopper::wgmma_rs(acc[nb], am[kk],
                         hopper::desc(bt, nb * SUB_BYTES + kk * 2048), 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
        hopper::wgmma_rs(acc[nb], ah[kk],
                         hopper::desc(bt, nb * SUB_BYTES + kk * 2048), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();      // the A registers and the tile are free
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) hopper::fence_regs(acc[nb]);
  }
  hopper::cp_async_wait<0>();

  // scale * sum (or the partial sum), two neighbouring columns a store (8
  // bytes when n is even: four lanes of a row fill a 32-byte sector)
  const bool pair = (n & 1) == 0;
  float* dst = partial ? partial + (long long)blockIdx.z * m * n : out;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = m0 + hopper::frag_row(i);
      const int col = n0 + 64 * nb + hopper::frag_col(i);
      if (row >= m || col >= n) continue;
      float* op = dst + (long long)row * n + col;
      const float y0 = partial ? acc[nb][i] : acc[nb][i] * scale[col];
      if (col + 1 < n) {
        const float y1 =
            partial ? acc[nb][i + 1] : acc[nb][i + 1] * scale[col + 1];
        if (pair) {
          *reinterpret_cast<float2*>(op) = make_float2(y0, y1);
        } else {
          op[0] = y0;
          op[1] = y1;
        }
      } else {
        op[0] = y0;
      }
    }
}

// the weight copy's bytes a thread: 16 while n is a multiple of 16 and q
// starts on 16 bytes (then every row does), else 8 (n = 37000: row k
// starts at byte 37000 k, on 8 bytes but not on 16), else 4, else 1
inline int weight_vec(const void* q, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  const int sizes[3] = {16, 8, 4};
  for (int i = 0; i < 3; ++i)
    if (n % sizes[i] == 0 && a % sizes[i] == 0) return sizes[i];
  return 1;
}

}  // namespace

// C entry point, bound with ctypes. x [m, d] float32, q [d, n] int8 and
// scale [n] float32, all contiguous; out [m, n] float32. `splits`: how
// many blocks share the d of an output tile, each over a whole number of
// k-chunks (256 wide on the skinny path, m <= 32; 32 on the tiled path);
// with splits > 1, `work` is float32 scratch of splits * m * n (else
// unused) and a second pass adds the partials in k order. Returns the
// launch's cudaError_t.
extern "C" int pt_int8_matmul(int device, const void* x, const void* q,
                              const void* scale, void* out, void* work,
                              int m, int d, int n, int splits,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || d < 0 || n < 0 || splits < 1 ||
      (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = m <= 32 ? SK_KC : TK;   // k a split is made of
  const int chunks = (d + chunk - 1) / chunk;
  if (splits > chunks && chunks > 0) splits = chunks;
  const int k_per_split =
      chunks > 0 ? ((chunks + splits - 1) / splits) * chunk : chunk;
  if (chunks > 0) splits = (chunks * chunk + k_per_split - 1) / k_per_split;
  float* wp = splits > 1 ? static_cast<float*>(work) : nullptr;
  if (m <= 32) {
    dim3 grid((n + SK_COLS - 1) / SK_COLS, splits);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (m <= 8)
      int8_matmul_skinny<8><<<grid, THREADS, 0, s>>>(xp, qp, sp, op, wp, m,
                                                     d, n, k_per_split);
    else if (m <= 16)
      int8_matmul_skinny<16><<<grid, THREADS, 0, s>>>(xp, qp, sp, op, wp, m,
                                                      d, n, k_per_split);
    else
      int8_matmul_skinny<32><<<grid, THREADS, 0, s>>>(xp, qp, sp, op, wp, m,
                                                      d, n, k_per_split);
  } else {
    dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(int8_matmul_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int xvec = d % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    int8_matmul_wgmma<<<grid, TTHREADS, T_SMEM, s>>>(
        xp, qp, sp, op, wp, m, d, n, k_per_split, xvec, weight_vec(q, n));
  }
  if (wp != nullptr) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long mn = (long long)m * n;
    int8_matmul_reduce<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS,
                         0, s>>>(wp, sp, op, m, n, splits);
  }
  return (int)cudaGetLastError();
}
