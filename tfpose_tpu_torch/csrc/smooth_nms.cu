// Fused Gaussian smooth + 3x3 NMS on an upsampled heat map.
//
// Replaces tfpose_tpu/ops/pallas/smooth_nms.py:smooth_nms_pallas (body
// _kernel): a separable K-tap blur with zero SAME padding (K/2 on each
// side), the vertical pass first, each pass summed in tap order
//   acc = k0 * x0;  acc = acc + k_t * x_t  (t = 1 .. K-1)
// with every product and sum rounded (__fmul_rn / __fadd_rn, never a fused
// multiply-add), as the JAX kernel and the plain PyTorch version compute
// it; then out = s where s >= its 3x3 neighbourhood max (-inf outside the
// map), else 0. No threshold.
//
// Layout: input and output stay (H, W, C), channel innermost, as the
// decode path holds them. Every global access walks a contiguous run of
// (x, c) values of one row, so consecutive threads touch consecutive
// addresses; no wrapper transpose.
//
// Design: one block of 512 threads per 14 x 24 output tile and chunk of CB
// channels (all C = 19 of the decode path; more channels are split into
// chunks whose shared memory stays within kSmemBudget).
//  1. Vertical pass, straight from device memory: a thread owns one (x, c)
//     column of the tile's 24 + K + 1 columns (those the horizontal pass
//     reads), slides a register window of 16 + K - 1 values down it
//     (peak_select.cuh's tap run, rows outside the map read as 0) and keeps
//     the 16 sums of the tile's rows and its NMS ring: V[r][x][c] in
//     shared memory.
//  2. Horizontal pass: a thread owns one ring row, one channel and 13
//     consecutive columns of the 26, reading V with a stride of CB floats;
//     the 32 threads of a warp are 16 rows of two (channel, run) pairs, and
//     the row stride is 2 mod 32 floats, so a warp's loads hit 32 banks.
//     Smoothed values outside the map are -inf: S[r][x][c].
//  3. NMS: a thread owns one (x, c) column of the tile and walks its 14
//     rows with the rolling maxima of three columns, storing each result to
//     device memory as it goes.
// The taps are a __grid_constant__ parameter (constant-bank operands) and K
// a template parameter (25, the decode default, unrolled; any other K in
// 1..64 runs the same kernel with run-time loops).
//
// Work at the main path's shape (184 x 216 x 19, upsample 4): 14 x 9 = 126
// blocks, one per SM. Per 14 x 24 outputs the block sums 16 x 50 columns
// vertically (2.38x the outputs) and 16 x 26 horizontally (1.24x), and
// reads 40 x 50 input pixels (5.95x, from L2: the map is 3 MB).
//
// Bound on an H100 at that shape: 6 MB moved (3 MB in, 3 MB out) is
// 1.8 us at 3.35 TB/s; 2 x 49 blur operations and 9 for the NMS per value,
// 81 M operations, are 1.2 us at 67 TFLOP/s fp32. Bytes bound it.

#include "peak_select.cuh"

namespace {

constexpr int kTH = 14, kTW = 24;          // output tile
constexpr int kRows = kTH + 2;             // smoothed rows: tile and NMS ring
constexpr int kSCols = kTW + 2;            // smoothed columns: tile and NMS ring
constexpr int kRH = 13;                    // horizontal sums per thread run
constexpr int kThreads = 512;
constexpr int kMaxTaps = 64;
constexpr int kSmemBudget = 100 * 1024;    // bytes of V and S a chunk may use

static_assert(kSCols % kRH == 0, "whole horizontal runs");
static_assert(kRows == 16, "a warp is 16 rows of two (channel, run) pairs");
static_assert(kRH % 2 == 1, "odd runs keep a warp's two pairs on other banks");

struct Taps {
  float k[kMaxTaps];
};

// Row length of a shared array of n floats, padded to 2 mod 32: 16 rows
// then cover the even banks, and the next (channel, run) pair, an odd
// number of floats on, the odd ones.
__host__ __device__ inline int row_stride(int n) { return n + ((34 - n % 32) % 32); }

struct Geometry {  // shared-memory layout of a chunk of cb channels, K taps
  int vcols, lv, ls, floats;
  __host__ __device__ Geometry(int klen, int cb) {
    vcols = kSCols + klen - 1;  // columns of vertical sums the horizontal pass reads
    lv = row_stride(vcols * cb);
    ls = row_stride(kSCols * cb);
    floats = kRows * (lv + ls);
  }
};

template <int KLEN>
__global__ void __launch_bounds__(kThreads)
smooth_nms_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const __grid_constant__ Taps taps, int H, int W, int C, int cb,
                  int klen_rt) {
  extern __shared__ __align__(16) float sm[];
  const int klen = KLEN > 0 ? KLEN : klen_rt;
  const int p = klen / 2;
  const Geometry g(klen, cb);
  float* vb = sm;                  // kRows x lv: V[r][xv * cb + c]
  float* sb = sm + kRows * g.lv;   // kRows x ls: S[r][xs * cb + c]
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = blockIdx.z * cb, ncb = min(cb, C - c0);
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(W) * C;

  // 1. V[r][xv][c] <-> plane row y0 - 1 + r, column x0 - 1 - p + xv:
  //    sum_t k_t * x[y0 - 1 - p + r + t][...], rows outside the map 0
  for (int j = tid; j < g.vcols * cb; j += kThreads) {
    const int xv = j / cb, c = j % cb;
    const int xx = x0 - 1 - p + xv;
    float v[kRows];
    if (xx >= 0 && xx < W && c < ncb) {
      const float* col = x + static_cast<size_t>(xx) * C + c0 + c;
      const int ytop = y0 - 1 - p;
      peaks::tap_run_of<KLEN, kRows, false>(
          [=](int i) {
            const int yy = ytop + i;
            return yy >= 0 && yy < H ? __ldg(col + yy * row) : 0.0f;
          },
          taps.k, klen, kRows, v);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = 0.0f;  // a zero column blurs to 0
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) vb[r * g.lv + j] = v[r];
  }
  __syncthreads();

  // 2. S[r][xs][c] <-> plane (y0 - 1 + r, x0 - 1 + xs), -inf outside:
  //    sum_t k_t * V[r][xs + t][c]
  constexpr int kRuns = kSCols / kRH;
  for (int item = tid; item < kRows * cb * kRuns; item += kThreads) {
    const int r = item % kRows, pair = item / kRows;
    const int c = pair % cb, xs0 = pair / cb * kRH;
    const int yy = y0 - 1 + r, xx = x0 - 1 + xs0;
    float s[kRH];
    if (yy >= 0 && yy < H && xx < W && xx + kRH > 0) {
      peaks::tap_run<KLEN, kRH, false>(vb + r * g.lv + xs0 * cb + c, cb, taps.k, klen, kRH, s);
#pragma unroll
      for (int j = 0; j < kRH; ++j) {
        if (xx + j < 0 || xx + j >= W) s[j] = peaks::neg_inf();
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRH; ++j) s[j] = peaks::neg_inf();
    }
#pragma unroll
    for (int j = 0; j < kRH; ++j) sb[r * g.ls + (xs0 + j) * cb + c] = s[j];
  }
  __syncthreads();

  // 3. out = s >= its 3x3 max ? s : 0, a thread per (x, c) column of the tile
  for (int j = tid; j < kTW * cb; j += kThreads) {
    const int xo = j / cb, c = j % cb;
    const int xx = x0 + xo;
    if (xx >= W || c >= ncb) continue;
    const float* s = sb + xo * cb + c;  // S[r][xo + dx][c] = s[r * ls + dx * cb]
    auto hmax = [&](int r) {
      const float* q = s + r * g.ls;
      return fmaxf(q[0], fmaxf(q[cb], q[2 * cb]));
    };
    float m0 = hmax(0), m1 = hmax(1);
    float* dst = out + (static_cast<size_t>(y0) * W + xx) * C + c0 + c;
    for (int r = 0; r < kTH && y0 + r < H; ++r) {
      const float m2 = hmax(r + 2);
      const float v = s[(r + 1) * g.ls + cb];
      dst[r * row] = v >= fmaxf(m0, fmaxf(m1, m2)) ? v : 0.0f;
      m0 = m1;
      m1 = m2;
    }
  }
}

template <int KLEN>
int launch(const float* x, float* out, const Taps& taps, int H, int W, int C, int klen,
           cudaStream_t st) {
  // channels per block: all C where they fit the budget, else balanced chunks
  int cb = C;
  while (cb > 1 && sizeof(float) * Geometry(klen, cb).floats > kSmemBudget) --cb;
  const int chunks = (C + cb - 1) / cb;
  cb = (C + chunks - 1) / chunks;
  const size_t smem = sizeof(float) * Geometry(klen, cb).floats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smooth_nms_kernel<KLEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, chunks);
  smooth_nms_kernel<KLEN><<<grid, kThreads, smem, st>>>(x, out, taps, H, W, C, cb, klen);
  return 0;
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: (H, W, C) fp32 on the device; taps: (klen,) fp32 on the host,
// 1 <= klen <= 64 (the wrapper checks). Returns cudaGetLastError() after
// the launch.
extern "C" int smooth_nms_launch(const float* x, float* out, const float* taps_host, int H,
                                 int W, int C, int klen, void* stream) {
  if (klen < 1 || klen > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps = {};
  for (int t = 0; t < klen; ++t) taps.k[t] = taps_host[t];
  if (H > 0 && W > 0 && C > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err = klen == 25 ? launch<25>(x, out, taps, H, W, C, klen, st)
                               : launch<0>(x, out, taps, H, W, C, klen, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
