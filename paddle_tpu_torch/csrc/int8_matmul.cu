// Scaled int8-weight matmul for Hopper (sm_90a):
//   out[i, j] = scale[j] * sum_k x[i, k] * float(q[k, j])
// with x [m, d] float32, q [d, n] int8 row-major (the JAX layout, so a JAX
// state_dict loads as it is), scale [n] float32 and out [m, n] float32.
// The wrapper (ops/quant.py `int8_matmul`) casts a bf16 x to float32
// first, and casts the result back and adds the bias afterwards.
//
// Replaces: paddle_tpu/ops/quant.py `_int8_matmul_call` (the Pallas
// blocked kernel behind `int8_matmul`). Same math: the int8 tile is
// upcast to float32, the product accumulates in float32 and the
// per-column scale multiplies the sum. Differences by design: any m, n
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
//  * A prefill (m = the prompt bucket, up to 1024) is float32-operation
//    bound (67 TFLOP/s on the CUDA cores: no TF32 and no tensor cores,
//    since the serving path computes in float32). The tiled path is the
//    classic register-blocked SGEMM: a 64 x 64 output tile per block,
//    16-deep slices of x and of the upcast weight staged in shared
//    memory, a 4 x 4 register tile per thread (two float4 shared loads
//    feed 16 FMAs).
// Making either path faster (mma / wgmma on bf16 activations, loads
// pipelined with cp.async) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- tiled path: m > 32 ----
constexpr int TB_M = 64, TB_N = 64, TB_K = 16;

__global__ void __launch_bounds__(THREADS)
int8_matmul_tiled(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int m, int d, int n) {
  __shared__ __align__(16) float as[TB_K][TB_M + 4];   // x slice, k-major
  __shared__ __align__(16) float bs[TB_K][TB_N];       // upcast weight
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += TB_K) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = tid + u * THREADS;           // 0 .. 1023
      const int r = idx >> 4, kk = idx & 15;       // x: 64 rows x 16 k
      const int row = m0 + r, k = k0 + kk;
      as[kk][r] = (row < m && k < d) ? x[(long long)row * d + k] : 0.f;
      const int kr = idx >> 6, cc = idx & 63;      // q: 16 k x 64 columns
      const int kq = k0 + kr, col = n0 + cc;
      bs[kr][cc] = (kq < d && col < n)
          ? static_cast<float>(q[(long long)kq * n + col])
          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) out[(long long)row * n + col] = acc[i][j] * scale[col];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. x [m, d] float32, q [d, n] int8 and
// scale [n] float32, all contiguous; out [m, n] float32. `splits`: how
// many blocks share the d of a column strip on the skinny path (m <= 32),
// each over a whole number of 256-wide k-chunks; with splits > 1, `work`
// is float32 scratch of splits * m * n (else unused). Returns the launch's
// cudaError_t.
extern "C" int pt_int8_matmul(int device, const void* x, const void* q,
                              const void* scale, void* out, void* work,
                              int m, int d, int n, int splits,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || d < 0 || n < 0 || splits < 1 ||
      (splits > 1 && (work == nullptr || m > 32)))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 32) {
    const int chunks = (d + SK_KC - 1) / SK_KC;
    if (splits > chunks && chunks > 0) splits = chunks;
    const int k_per_split =
        chunks > 0 ? ((chunks + splits - 1) / splits) * SK_KC : SK_KC;
    if (chunks > 0) splits = (chunks * SK_KC + k_per_split - 1) / k_per_split;
    float* wp = splits > 1 ? static_cast<float*>(work) : nullptr;
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
    if (wp != nullptr) {
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const long long mn = (long long)m * n;
      int8_matmul_reduce<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS,
                           0, s>>>(wp, sp, op, m, n, splits);
    }
  } else {
    dim3 grid((n + TB_N - 1) / TB_N, (m + TB_M - 1) / TB_M);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    int8_matmul_tiled<<<grid, THREADS, 0, s>>>(xp, qp, sp, op, m, d, n);
  }
  return (int)cudaGetLastError();
}
