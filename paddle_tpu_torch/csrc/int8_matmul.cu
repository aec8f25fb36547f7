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
//    route (m <= 32, `int8_matmul_skinny_mma`) streams the weight into a
//    four-stage cp.async ring, 64 k-rows x 128 columns a stage, in copies
//    of 16 bytes a thread (8, 4 or single bytes where a row does not start
//    on 16: `weight_vec`), the x slice of the same k-rows beside it. The
//    products run on the tensor cores: `mma.sync` m16n8k16 in bf16, the
//    weight as the A operand (16 output columns by 16 k) and x as B (8
//    rows of m by 16 k), so a decode step's 8 rows fill the narrow side
//    and m = 32 takes four such tiles. x goes in as three bf16 pieces, as
//    on the tiled route, and an int8 weight is exact in bf16 (its float32
//    value, built from the byte by a magic-number add, has its low 16 bits
//    clear): every product is exact, only the float32 order of the sum
//    differs from the plain version. Each warp owns one 16-deep k-step of
//    a stage and all 128 columns of the block; a lane reads 16 bytes of
//    four weight rows from a tile swizzled against bank conflicts, and its
//    mma rows are permuted so that its accumulators hold 16 consecutive
//    columns of two rows of m. The warps' partials are added in warp
//    order in shared memory. Where n gives few column strips (n = 512),
//    d is split across a thread-block cluster of up to 8 blocks
//    (`skinny_plan`, about two blocks an SM), and the ranks' partials are
//    added in rank order through distributed shared memory: one launch,
//    no work buffer, the same bits on every run. A grid that still holds
//    fewer blocks than SMs (d = 2048, n = 512) takes 8 warps a block and
//    128-row stages: with one warp a scheduler, a warp's steps run one
//    after another, so half the steps each halve the block's time.
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
//    tiles) splits d across blocks (`splits`, chosen by the wrapper), the
//    partials added in k order by a second pass (`int8_matmul_reduce`).
//    Shorter k-ranges in the tensor-core accumulators, summed in
//    float32 there, also cut the error of a long d (on an H100 at d =
//    2048: 1.2e-6 of the largest entry against 5.7e-6 unsplit).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // threads a block of the reduce pass

// The second pass of a split tiled product: out = scale * the sum of the
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


// ---- skinny route: m <= 32, on the tensor cores (mma.sync) ----
namespace skinny {

constexpr int COLS = 128;               // output columns a block
constexpr int STEP = 16;                // k-rows of a stage a warp takes
constexpr int KC4 = 4 * STEP;           // k-rows a stage of four warps
constexpr int STAGES = 4;               // the cp.async ring
constexpr int RED_LD = 146;             // floats a row of a warp's partial
constexpr int MAX_CLUSTER = 8;          // k-splits a column strip, portable
constexpr int TARGET_PER_SM = 2;        // blocks an SM the plan aims for

// A block of W warps with MT 8-row tiles of m: its stages (W 16-deep
// steps) and shared memory, the ring (weight tile then x slice, per
// stage), reused after the loop for the warps' partials.
template <int MT, int W>
struct Layout {
  static constexpr int THREADS = 32 * W;
  static constexpr int KC = STEP * W;    // k-rows a stage
  static constexpr int XLD = KC + 8;     // floats a row of an x stage
  static constexpr int W_BYTES = KC * COLS;
  static constexpr int MR = 8 * MT;
  static constexpr int X_BYTES = MR * XLD * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = W * MR * RED_LD * 4;
  static constexpr int BYTES = RING > RED ? RING : RED;
};

// (8-row tiles of m, blocks a cluster = k-splits, k a split, warps a
// block) for an m x d by d x n product on `sms` SMs: 128-column strips; d
// split in whole 64-row stages across up to MAX_CLUSTER ranks until about
// TARGET_PER_SM blocks an SM run. A grid still short of a block an SM
// whose splits hold whole 128-row stages (d = 2048, n = 512) runs 8 warps
// a block: each warp then takes half the steps of a split. A legal `tuned`
// (the tuning table's split_k: 1..MAX_CLUSTER, at most one split a stage)
// replaces the rule's split; 0, or an illegal value, keeps the rule.
inline void plan(int sms, int m, int d, int n, int* mt, int* c, int* kps,
                 int* warps, int tuned) {
  *mt = m <= 8 ? 1 : m <= 16 ? 2 : 4;
  const int strips = max(1, (n + COLS - 1) / COLS);
  const int chunks = d > 0 ? (d + KC4 - 1) / KC4 : 1;
  const int want = (TARGET_PER_SM * sms + strips - 1) / strips;
  const int split = tuned >= 1 && tuned <= MAX_CLUSTER && tuned <= chunks
                        ? tuned
                        : max(1, min(min(MAX_CLUSTER, chunks), want));
  const int per = (chunks + split - 1) / split;
  *c = (chunks + per - 1) / per;
  *kps = per * KC4;
  *warps = strips * *c < sms && *kps % (2 * KC4) == 0 ? 8 : 4;
}

// column c of a row of a warp's partial: a 2-float gap every 32 columns,
// so the fragment stores (rows 2t, columns 16g + 2j) hit 32 banks
__device__ __forceinline__ int red_col(int c) { return c + 2 * (c >> 5); }

// bytes b of words wa (weight row k) and wb (row k + 1), each stored
// biased by 0x80 (v + 128), as the bf16 pair (v_k, v_{k+1}), exactly:
// 2^23 + v + 128 is a float32 whose low byte is the biased byte, minus
// 2^23 + 128 it is v, and a float32 integer below 256 in magnitude has
// its low 16 bits clear, so its high half is its bf16
__device__ __forceinline__ uint32_t bf16_pair(uint32_t wa, uint32_t wb,
                                              int b) {
  const float fa =
      __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7440u | b)) -
      8388736.f;
  const float fb =
      __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7440u | b)) -
      8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632u);
}

// d (16 x 8) += a (16 x 16) . b (16 x 8), bf16 operands, float32 sum.
// With g = lane / 4, t = lane % 4 (PTX ISA, "matrix fragments for
// mma.m16n8k16" with .bf16): a0 (row g, k 2t..2t+1), a1 (g + 8, 2t..),
// a2 (g, 2t+8..), a3 (g + 8, 2t+8..); b0 (k 2t..2t+1, col g), b1 (k
// 2t+8..); d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8, the same)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Block (rank blockIdx.x of the cluster = k-range [rank k_per_split,
// (rank + 1) k_per_split), column strip blockIdx.y of 128): out[:, strip]
// = scale * x . q over the cluster's ranks. The product is taken
// transposed, out^T = q^T . x^T: the mma's 16 rows are output columns,
// its 8 columns rows of m. Lane (g, t) of warp w reads, in each stage,
// weight rows 16w + {2t, 2t + 1, 2t + 8, 2t + 9} at columns 16g .. 16g +
// 15 (16 bytes each); mma j (0..7) maps its row g to column 16g + 2j and
// row g + 8 to 16g + 2j + 1, so after the eight the lane holds columns
// 16g .. 16g + 15 of rows 2t and 2t + 1 of each 8-row tile of m. A
// stage's weight tile is 16 W rows of 128 bytes, the 16-byte chunk c of
// row r at chunk c ^ (r % 8): the lanes of a load phase hit 8 distinct
// chunks.
template <int MT, int W>
__global__ void __launch_bounds__(32 * W)
int8_matmul_skinny_mma(const float* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int m, int d, int n,
                       int k_per_split, int xvec, int wvec) {
  using L = Layout<MT, W>;
  constexpr int THREADS = L::THREADS, WARPS = W, KC = L::KC;
  constexpr int XLD = L::XLD, W_BYTES = L::W_BYTES, MR = L::MR;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * COLS;
  const int kbeg = rank * k_per_split;
  const int kend = min(d, kbeg + k_per_split);
  const int nk = kend > kbeg ? (kend - kbeg + KC - 1) / KC : 0;

  auto fetch = [&](int kt, int s) {
    const int k0 = kbeg + kt * KC;
    uint8_t* ws = smem + s * L::STAGE;
    float* xs = reinterpret_cast<float*>(ws + W_BYTES);
    if (wvec >= 4) {
      const int lgw = __ffs(wvec) - 1;    // copies a row: COLS >> lgw
      const int lgper = 7 - lgw;          // COLS = 2^7
      for (int i = tid; i < KC << lgper; i += THREADS) {
        const int r = i >> lgper, c = (i & ((1 << lgper) - 1)) << lgw;
        const bool ok = k0 + r < kend && n0 + c < n;
        const int8_t* src = ok ? q + (long long)(k0 + r) * n + n0 + c : q;
        uint8_t* dst = ws + r * COLS + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
        if (wvec == 16)
          hopper::cp_async16(dst, src, ok ? 16 : 0);
        else if (wvec == 8)
          hopper::cp_async8(dst, src, ok ? 8 : 0);
        else
          hopper::cp_async4(dst, src, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < KC * COLS; i += THREADS) {
        const int r = i / COLS, c = i % COLS;
        ws[r * COLS + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))] =
            (k0 + r < kend && n0 + c < n)
                ? static_cast<uint8_t>(q[(long long)(k0 + r) * n + n0 + c])
                : 0;
      }
    }
    // x rows 0 .. MR - 1 (zero past m) over the same k-rows (zero past
    // the split's end)
    if (xvec) {
      for (int i = tid; i < MR * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), c = 4 * (i % (KC / 4));
        const bool ok = r < m && k0 + c < kend;
        hopper::cp_async16(xs + r * XLD + c,
                           ok ? x + (long long)r * d + k0 + c : x,
                           ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < MR * KC; i += THREADS) {
        const int r = i / KC, c = i % KC;
        const bool ok = r < m && k0 + c < kend;
        hopper::cp_async4(xs + r * XLD + c,
                          ok ? x + (long long)r * d + k0 + c : x,
                          ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) fetch(s, s);
    hopper::cp_async_commit();
  }
  float acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int r0 = 16 * warp + 2 * t;       // this lane's first weight row
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();                      // ... for every thread
    if (kt + STAGES - 1 < nk)
      fetch(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const uint8_t* ws = smem + (kt % STAGES) * L::STAGE;
    const float* xs = reinterpret_cast<const float*>(ws + W_BYTES);

    // B: this warp's 16-deep step of x, each 8-row tile in three pieces
    uint32_t bh[MT][2], bm[MT][2], bl[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            xs + (8 * i + g) * XLD + 16 * warp + 2 * t + 8 * h);
        pieces(v, bh[i][h], bm[i][h], bl[i][h]);
      }
    // A: 16 bytes of weight rows r0, r0 + 1, r0 + 8, r0 + 9, biased by
    // 0x80 for `bf16_pair` (r0 % 8 = 2t: the swizzle keys are 2t, 2t + 1)
    uint32_t w[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + (u & 1) + 8 * (u >> 1);
      const uint4 v = *reinterpret_cast<const uint4*>(
          ws + r * COLS + ((g ^ (r & 7)) << 4));
      w[u][0] = v.x ^ 0x80808080u;
      w[u][1] = v.y ^ 0x80808080u;
      w[u][2] = v.z ^ 0x80808080u;
      w[u][3] = v.w ^ 0x80808080u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int wi = j >> 1, b = 2 * (j & 1);
      uint32_t a[4];
      a[0] = bf16_pair(w[0][wi], w[1][wi], b);        // column 16g + 2j
      a[1] = bf16_pair(w[0][wi], w[1][wi], b + 1);    // column 16g + 2j + 1
      a[2] = bf16_pair(w[2][wi], w[3][wi], b);
      a[3] = bf16_pair(w[2][wi], w[3][wi], b + 1);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma(acc[i][j], a, bl[i]);
        mma(acc[i][j], a, bm[i]);
        mma(acc[i][j], a, bh[i]);
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();                        // the ring is free

  // the warps' partials [WARPS][MR][RED_LD]; then their sum, in warp
  // order, in place of warp 0's
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * MR * RED_LD;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = 8 * i + 2 * t, col = red_col(16 * g + 2 * j);
      *reinterpret_cast<float2*>(mine + row * RED_LD + col) =
          make_float2(acc[i][j][0], acc[i][j][2]);
      *reinterpret_cast<float2*>(mine + (row + 1) * RED_LD + col) =
          make_float2(acc[i][j][1], acc[i][j][3]);
    }
  __syncthreads();
  const int rows = min(m, MR);
  for (int o = tid; o < rows * COLS; o += THREADS) {
    const int r = o / COLS, c = o % COLS;
    const int p = r * RED_LD + red_col(c);
    float s = red[p];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) s += red[v * MR * RED_LD + p];
    if (C > 1)
      red[p] = s;
    else if (n0 + c < n)
      out[(long long)r * n + n0 + c] = s * scale[n0 + c];
  }
  if (C == 1) return;
  // rank `rank` finishes a slice of the strip, adding the ranks' partials
  // in rank order through distributed shared memory
  cl.sync();
  const int total = rows * COLS, per = (total + C - 1) / C;
  const int o1 = min(total, (rank + 1) * per);
  for (int o = rank * per + tid; o < o1; o += THREADS) {
    const int r = o / COLS, c = o % COLS;
    if (n0 + c >= n) continue;
    const int p = r * RED_LD + red_col(c);
    float v[MAX_CLUSTER];                 // every rank's first, then the sum
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < C) v[k] = cl.map_shared_rank(red, k)[p];
    float s = v[0];
#pragma unroll
    for (int k = 1; k < MAX_CLUSTER; ++k)
      if (k < C) s += v[k];
    out[(long long)r * n + n0 + c] = s * scale[n0 + c];
  }
  cl.sync();                              // no rank leaves while read
}

template <int MT, int W>
int launch(const float* x, const int8_t* q, const float* scale, float* out,
           int m, int d, int n, int C, int kps, int xvec, int wvec,
           cudaStream_t s) {
  using L = Layout<MT, W>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_skinny_mma<MT, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int strips = (n + COLS - 1) / COLS;
  if (strips > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, strips);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_matmul_skinny_mma<MT, W>, x, q, scale,
                           out, m, d, n, kps, xvec, wvec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int W>
int launch_by_rows(int mt, const float* x, const int8_t* q,
                   const float* scale, float* out, int m, int d, int n,
                   int C, int kps, int xvec, int wvec, cudaStream_t s) {
  return mt == 1 ? launch<1, W>(x, q, scale, out, m, d, n, C, kps, xvec,
                                wvec, s)
       : mt == 2 ? launch<2, W>(x, q, scale, out, m, d, n, C, kps, xvec,
                                wvec, s)
                 : launch<4, W>(x, q, scale, out, m, d, n, C, kps, xvec,
                                wvec, s);
}

}  // namespace skinny

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n < 1)
    n = 132;
  return n;
}

}  // namespace

// The skinny route's plan for an m x d by d x n product (m <= 32) on
// `device`: out[0] the 8-row tiles of m (1, 2 or 4), out[1] the blocks a
// cluster (k-splits, merged in the kernel), out[2] the k-rows a split,
// out[3] the warps a block (4 or 8). `ops.quant.skinny_plan` writes the
// same rule out for the CPU.
extern "C" int pt_int8_matmul_skinny_plan(int device, int m, int d, int n,
                                          int split_k, int* out) {
  skinny::plan(sm_count(device), m, d, n, out, out + 1, out + 2, out + 3,
               split_k);
  return 0;
}

// C entry point, bound with ctypes. x [m, d] float32, q [d, n] int8 and
// scale [n] float32, all contiguous; out [m, n] float32. m <= 32 runs the
// skinny route, one launch planned by `pt_int8_matmul_skinny_plan`
// (`splits` must be 1 and `work` is unused). m > 32 runs the tiled route:
// `splits` blocks share the d of an output tile, each over a whole number
// of 32-deep k-chunks; with splits > 1, `work` is float32 scratch of
// splits * m * n and a second pass adds the partials in k order. Returns
// the launch's cudaError_t.
extern "C" int pt_int8_matmul(int device, const void* x, const void* q,
                              const void* scale, void* out, void* work,
                              int m, int d, int n, int splits, int split_k,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 0 || d < 0 || n < 0 || splits < 1 ||
      (splits > 1 && (work == nullptr || m <= 32)))
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int xvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (m <= 32) {
    int mt, C, kps, warps;
    skinny::plan(sm_count(device), m, d, n, &mt, &C, &kps, &warps, split_k);
    const int wv = weight_vec(q, n);
    return warps == 8
        ? skinny::launch_by_rows<8>(mt, xp, qp, sp, op, m, d, n, C, kps,
                                    xvec, wv, s)
        : skinny::launch_by_rows<4>(mt, xp, qp, sp, op, m, d, n, C, kps,
                                    xvec, wv, s);
  }
  const int chunks = (d + TK - 1) / TK;
  if (splits > chunks && chunks > 0) splits = chunks;
  const int k_per_split =
      chunks > 0 ? ((chunks + splits - 1) / splits) * TK : TK;
  if (chunks > 0) splits = (chunks * TK + k_per_split - 1) / k_per_split;
  float* wp = splits > 1 ? static_cast<float*>(work) : nullptr;
  dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, splits);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(int8_matmul_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T_SMEM);
  if (err != cudaSuccess) return (int)err;
  int8_matmul_wgmma<<<grid, TTHREADS, T_SMEM, s>>>(
      xp, qp, sp, op, wp, m, d, n, k_per_split, xvec, weight_vec(q, n));
  if (wp != nullptr) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long mn = (long long)m * n;
    int8_matmul_reduce<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS,
                         0, s>>>(wp, sp, op, m, n, splits);
  }
  return (int)cudaGetLastError();
}
