// Fused 1x1-conv + BatchNorm forward for Hopper (sm_90a):
//   z[b, o, p] = sum_c W[o, c] * xn[b, c, p],
//   xn = act(f32(x) * scale[c] + shift[c]) rounded to x's type (or act(x)),
//   s[o] = sum_{b,p} z_f32[b, o, p],  ss[o] = sum_{b,p} z_f32[b, o, p]^2,
// with x [B, Ci, HW] float32 or bf16, z [B, Co, HW] in x's type, W
// [Co, Ci] float32, scale / shift [Ci] float32 (unused without a norm).
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
// HW operations against reading x and writing z once. In bf16 the tensor
// cores would make it bytes-bound; this first kernel runs float32 FMAs on
// the CUDA cores (an fp32 input must: the port's contract has no TF32),
// so it is operation-bound on them. Its shape is the classic register-
// tiled product: a block owns 64 output channels x 64 columns of the
// flattened (image, position) axis, stages 16-deep slices of W and of the
// activation in shared memory, and each thread keeps a 4 x 4 tile of sums.
// The activation is computed while staging, from x, so it never exists in
// device memory; the stats are reduced across a half-warp with shuffles
// in the epilogue, so z is never read back. Tensor-core (mma / wgmma)
// products and cp.async pipelining are later work.

#include "fused_conv.cuh"

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

template <typename T>
int launch(const void* x, const void* scale, const void* shift, const void* w,
           void* z, void* s, void* ss, void* part, int B, int Ci, int Co,
           int HW, int P, int has_norm, int relu, cudaStream_t st) {
  const dim3 grid(P, (Co + TM - 1) / TM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  fused_conv_fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(w),
      static_cast<T*>(z), static_cast<float*>(part), B, Ci, Co, HW, P,
      has_norm, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<Co, THREADS, 0, st>>>(static_cast<const float*>(part),
                                          static_cast<float*>(s),
                                          static_cast<float*>(ss), Co, P);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 float32, 1 bf16 (x and z).
// x [B, Ci, HW], W [Co, Ci] float32, scale / shift [Ci] float32 (null
// without a norm), all contiguous; z [B, Co, HW]; s, ss [Co] float32;
// part: float32 scratch of 2 * Co * P, P = ceil(B * HW / 64) (the number
// of column tiles). Two launches: the tiled product with per-tile stats,
// then their fixed-order sum. Returns the first failing cudaError_t.
extern "C" int pt_fused_conv_fwd(int device, int dtype, const void* x,
                                 const void* scale, const void* shift,
                                 const void* w, void* z, void* s, void* ss,
                                 void* part, int B, int Ci, int Co, int HW,
                                 int P, int has_norm, int relu,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long N = (long long)B * HW;
  if (B < 0 || Ci < 0 || Co < 0 || HW < 0 || N > 0x7fffffffLL ||
      P != (int)((N + TN - 1) / TN) || (has_norm && (!scale || !shift)))
    return (int)cudaErrorInvalidValue;
  if (Co == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    err = cudaMemsetAsync(s, 0, sizeof(float) * Co, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(ss, 0, sizeof(float) * Co, st);
  }
  if (dtype == 0)
    return launch<float>(x, scale, shift, w, z, s, ss, part, B, Ci, Co, HW,
                         P, has_norm, relu, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, shift, w, z, s, ss, part, B, Ci,
                                 Co, HW, P, has_norm, relu, st);
  return (int)cudaErrorInvalidValue;
}
