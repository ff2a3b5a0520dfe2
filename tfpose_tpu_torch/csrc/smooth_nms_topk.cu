// Fused Gaussian smooth + 3x3 NMS + threshold + exact top-K on an
// already-upsampled heat map.
//
// Replaces tfpose_tpu/ops/pallas/smooth_nms.py:smooth_nms_topk_pallas
// (body _topk_kernel, top-K _topk_rounds), the decode route for upsample
// ratios that are not an integer replication of the stride-8 grid and for
// planes too large for the raw-grid route (smooth_nms_topk_raw.cu).
//
// Input: C planes (C, H, W) fp32. A separable K-tap blur with zero SAME
// padding, the vertical pass first, each pass summed in tap order
//   acc = k0 * x0;  acc = acc + k_t * x_t  (t = 1 .. K-1)
// with every product and sum rounded (__fmul_rn / __fadd_rn, never a fused
// multiply-add), as the JAX kernel and the plain PyTorch version compute
// it. A pixel is a peak when its smoothed value s >= its 3x3 neighbours
// (-inf outside the plane) and s > thresh. Output: the top-K peaks per
// plane by (score descending, flat index y * W + x ascending); empty slots
// hold score 0 and index -1.
//
// Design: two kernels launched back to back on one stream (the select and
// the NMS append are shared with the raw-grid kernel, peak_select.cuh).
//  1. blur_peaks_kernel, one block of 256 threads per (30 x 102 output tile,
//     plane). The tile plus a (K/2 + 1)-pixel halo (56 x 128 at K = 25)
//     goes to shared memory. Vertical pass: a thread owns one column and
//     16 consecutive rows of the 32 that the tile and its NMS ring need; it
//     reads its 16 + K - 1 values into registers once and keeps 16
//     independent sums. Horizontal pass: a thread owns one ring row and 13
//     consecutive columns of the 104, the same way, reading the vertical
//     sums (row stride odd, so a warp's 32 rows hit 32 banks). The taps are
//     a kernel parameter, so each weight is an operand from the constant
//     bank, and K is a template parameter (25, the decode default, fully
//     unrolled; any other K runs the same kernel with run-time loops).
//     Then 3x3 NMS and threshold, and each peak is appended to its plane's
//     list in device memory as one 64-bit key, one atomicAdd per warp. The
//     smoothed plane never reaches device memory.
//  2. select_kernel, one block per plane (peak_select.cuh).
// The wrapper sizes each plane's list for the worst case, H * W keys (every
// pixel of a plateau is a peak): 8 * C * H * W bytes, 33 MB at 360x640 and
// C = 18.
//
// Bound on an H100 at the windowed path's shapes (360 x 640 x 18, a
// 1280x720 frame in 432x368 windows at upsample 4): 4.15 M values, 16.6 MB
// read, 5.0 us at 3.35 TB/s; 98 flops of blur and 9 compares per value,
// 0.44 G ops, 6.6 us at 67 TFLOP/s fp32. Operations bound it. Without a
// fused multiply-add the blur issues 49 fp32 instructions per value and
// pass; the tile's halo and ring add 21 % of blur work (32 x 128 vertical
// and 32 x 104 horizontal sums per 30 x 102 outputs), and 4.3 % of the
// last column of tiles lies past 640.

#include "peak_select.cuh"

namespace {

using peaks::u64;

constexpr int kTH = 30, kTW = 102;  // output tile
constexpr int kThreads = 256;
constexpr int kRV = 16;             // vertical sums per thread run
constexpr int kRH = 13;             // horizontal sums per thread run
constexpr int kRN = 15;             // NMS rows per thread
constexpr int kMaxTaps = 64;
constexpr int kSRows = kTH + 2, kSCols = kTW + 2, kSStride = kSCols + 1;

static_assert(kSRows % kRV == 0 && kSCols % kRH == 0, "whole runs");
static_assert(kSRows == 32, "one horizontal run per lane and row");

struct Taps {
  float k[kMaxTaps];
};

struct Geometry {  // shared-memory layout for a K-tap blur
  int halo, in_w, in_h, v_stride, floats;
  __host__ __device__ explicit Geometry(int klen) {
    halo = klen / 2 + 1;
    in_w = kTW + 2 * halo;
    in_h = kTH + 2 * halo;
    v_stride = in_w | 1;  // odd: a warp reading 32 rows of one column hits 32 banks
    const int first = in_h * in_w > kSRows * kSStride ? in_h * in_w : kSRows * kSStride;
    floats = first + kSRows * v_stride;  // input tile (later the smoothed tile), then V
  }
};

template <int KLEN>
__global__ void __launch_bounds__(kThreads)
blur_peaks_kernel(const float* __restrict__ x, const __grid_constant__ Taps taps,
                  u64* __restrict__ lists, int* __restrict__ counts, int H, int W,
                  int klen_rt, float thresh) {
  extern __shared__ __align__(16) float sm[];
  const int klen = KLEN > 0 ? KLEN : klen_rt;
  const Geometry g(klen);
  float* xin = sm;                  // in_h x in_w: rows y0 - halo.., cols x0 - halo..
  float* sb = sm;                   // kSRows x kSStride smoothed, over xin once V is done
  float* vb = sm + (g.floats - kSRows * g.v_stride);  // kSRows x in_w vertical sums
  const int c = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xc = x + c * plane;

  // the input tile, a warp per row, zero outside the plane
  for (int rr = tid / 32; rr < g.in_h; rr += kThreads / 32) {
    const int yy = y0 - g.halo + rr;
    const bool row_in = yy >= 0 && yy < H;
    const float* src = xc + static_cast<size_t>(row_in ? yy : 0) * W;
    for (int q = tid % 32; q < g.in_w; q += 32) {
      const int xx = x0 - g.halo + q;
      xin[rr * g.in_w + q] = row_in && xx >= 0 && xx < W ? __ldg(src + xx) : 0.0f;
    }
  }
  __syncthreads();

  // vertical sums V[r][q], r <-> plane row y0 - 1 + r, q <-> column x0 - halo + q:
  // V[r][q] = sum_t k_t * xin[r + t][q]
  for (int item = tid; item < (kSRows / kRV) * g.in_w; item += kThreads) {
    const int q = item % g.in_w, r0 = item / g.in_w * kRV;
    const int xx = x0 - g.halo + q;
    const bool rows_in = y0 - 1 + r0 < H && y0 - 1 + r0 + kRV > 0;
    float out[kRV];
    if (xx >= 0 && xx < W && rows_in) {
      peaks::tap_run<KLEN, kRV, false>(xin + r0 * g.in_w + q, g.in_w, taps.k, klen, kRV, out);
    } else {
#pragma unroll
      for (int j = 0; j < kRV; ++j) out[j] = 0.0f;  // a zero column blurs to 0
    }
#pragma unroll
    for (int j = 0; j < kRV; ++j) vb[(r0 + j) * g.v_stride + q] = out[j];
  }
  __syncthreads();

  // smoothed S[r][q] <-> plane (y0 - 1 + r, x0 - 1 + q), -inf outside:
  // S[r][q] = sum_t k_t * V[r][q + t]
  for (int item = tid; item < kSRows * (kSCols / kRH); item += kThreads) {
    const int r = item % kSRows, q0 = item / kSRows * kRH;
    const int yy = y0 - 1 + r, xx = x0 - 1 + q0;
    float out[kRH];
    if (yy >= 0 && yy < H && xx < W && xx + kRH > 0) {
      peaks::tap_run<KLEN, kRH, false>(vb + r * g.v_stride + q0, 1, taps.k, klen, kRH, out);
#pragma unroll
      for (int j = 0; j < kRH; ++j) {
        if (xx + j < 0 || xx + j >= W) out[j] = peaks::neg_inf();
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRH; ++j) out[j] = peaks::neg_inf();
    }
#pragma unroll
    for (int j = 0; j < kRH; ++j) sb[r * kSStride + q0 + j] = out[j];
  }
  __syncthreads();

  peaks::nms_append<kTH, kTW, kRN, kThreads>(sb, kSStride, y0, x0, H, W, thresh,
                                             lists + c * plane, counts + c);
}

template <int KLEN>
int launch_peaks(const float* x, const Taps& taps, u64* lists, int* counts, int C, int H,
                 int W, int klen, float thresh, cudaStream_t st) {
  const size_t smem = sizeof(float) * Geometry(klen).floats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_peaks_kernel<KLEN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, C);
  blur_peaks_kernel<KLEN><<<grid, kThreads, smem, st>>>(x, taps, lists, counts, H, W, klen, thresh);
  return 0;
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (C, H, W) fp32; taps: (klen,) fp32 on the host, 1 <= klen <= 64;
// lists: C * H * W keys of scratch; counts: (C,) int32, zeroed by the
// caller; scores/idx: (C, k_top), with 1 <= k_top <= min(cap, 1024) and
// 0 <= cap <= 4096 (the wrapper checks). Returns cudaGetLastError() after
// the two launches.
extern "C" int smooth_nms_topk_launch(const float* x, const float* taps_host,
                                      u64* lists, int* counts, float* scores,
                                      int* idx, int C, int H, int W, int klen,
                                      int k_top, float thresh, int cap,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (klen < 1 || klen > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  Taps taps = {};
  for (int t = 0; t < klen; ++t) taps.k[t] = taps_host[t];
  if (C > 0 && H > 0 && W > 0) {
    const int err = klen == 25
        ? launch_peaks<25>(x, taps, lists, counts, C, H, W, klen, thresh, st)
        : launch_peaks<0>(x, taps, lists, counts, C, H, W, klen, thresh, st);
    if (err != 0) return err;
  }
  peaks::launch_select(lists, counts, scores, idx, C, static_cast<size_t>(H) * W, k_top,
                       cap, st);
  return static_cast<int>(cudaGetLastError());
}
