// Fused Gaussian smooth + 3x3 NMS + exact top-K on the raw stride-8 grid.
//
// Replaces tfpose_tpu/ops/pallas/smooth_nms.py:smooth_nms_topk_raw_pallas
// (body _topk_phase_kernel, weights _phase_weights, top-K _topk_rounds).
//
// Input: C raw heat planes (C, h8, w8) fp32 and an integer upsample factor
// (fy, fx). The blur of the area-upsampled plane is computed as fy*fx
// phase convolutions on the raw grid:
//   V[Y][col]  = sum_t wv[a][t] * raw[i + dvmin + t][col + dhmin],  Y = fy*i + a
//   S(Y, X)    = sum_t wh[b][t] * V[Y][j + t],                      X = fx*j + b
// each summed in tap order with no fused multiply-add, and taps t > 0 of
// weight 0 skipped, as the JAX kernel does. A value is a peak when S >= its
// 3x3 neighbours on the upsampled grid (-inf outside it) and S > thresh.
// Output: the top-K peaks per plane by (score descending, flat index
// ascending), flat index (fy*i + a) * up_w + fx*j + b; empty slots hold
// score 0 and index -1.
//
// Design: the two launches of smooth_nms_topk.cu, on the raw grid.
//  1. phase_peaks_kernel, one block of 256 threads per (62 x 64 tile of the
//     upsampled plane, plane): 3 x 4 tiles per 184 x 216 plane at 4x, so
//     216 blocks at B = 1 and 1,728 at B = 8. A block loads the raw rows
//     and columns its tile and one-pixel ring reach (23 x 24 at 4x), forms
//     the vertical phase sums V for the ring's 64 rows (a thread owns one
//     column and one phase a, and slides its weights down the raw column:
//     its rows Y = fy*i + a are a 1-D blur along i), then the smoothed
//     values S of the tile and ring once, into shared memory (a thread owns
//     one ring row and one phase b, and slides along V's row the same way:
//     4 phases x 64 rows, one run per thread). At 4x with 25 taps (7 phase
//     taps per axis, none of weight 0) both runs are unrolled with their
//     windows and weights in registers; other factors and lengths run the
//     same kernel with run-time loops. Then 3x3 NMS and threshold, and the
//     warp-ballot append of peak keys to the plane's list in device memory
//     (peak_select.cuh). The upsampled plane never reaches device memory.
//  2. select_kernel, one block per plane (peak_select.cuh).
// The wrapper sizes each plane's list for the worst case, up_h * up_w keys:
// 46 MB at B = 8 and 4x, so any input selects exactly.
//
// Bound on an H100 at the main path (B = 1: 18 planes of 46x54, 4x): it
// reads 0.18 MB and does about 19 MFLOP of blur and compares, both under a
// microsecond; the launches' latency and the select dominate.

#include "peak_select.cuh"

namespace {

using peaks::u64;

constexpr int kTY = 62, kTX = 64;  // upsampled output tile
constexpr int kThreads = 256;
constexpr int kRN = 16;            // NMS rows per thread
constexpr int kSRows = kTY + 2, kSStride = (kTX + 2) | 1;

struct Geometry {  // shared-memory layout, in floats
  int nvc_max, nri_max, v_stride, raw_off, v_off, s_off, floats;
  __host__ __device__ Geometry(int fy, int fx, int nv, int nh) {
    nvc_max = (kTX + 1) / fx + 1 + nh;  // V columns a tile and its ring reach
    nri_max = (kTY + 1) / fy + 1 + nv;  // raw rows
    v_stride = nvc_max | 1;             // odd: 32 rows of one column hit 32 banks
    raw_off = fy * nv + fx * nh;        // after the two weight tables
    v_off = raw_off + nri_max * nvc_max;
    s_off = v_off + kSRows * v_stride;
    floats = s_off + kSRows * kSStride;
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// FY, FX, NV, NH > 0: that factor and those phase tap counts, unrolled;
// all 0: the values at run time. SKIP0: skip taps t > 0 of weight 0 (the
// launcher leaves it out only for tables that have none).
template <int FY, int FX, int NV, int NH, bool SKIP0>
__global__ void __launch_bounds__(kThreads)
phase_peaks_kernel(const float* __restrict__ heat, const float* __restrict__ wv_g,
                   const float* __restrict__ wh_g, u64* __restrict__ lists,
                   int* __restrict__ counts, int h8, int w8, int fy_rt, int fx_rt, int nv_rt,
                   int nh_rt, int dvmin, int dhmin, float thresh) {
  constexpr int kRI = FY > 0 ? (kSRows + FY - 1) / FY : kSRows;       // V outputs per run
  constexpr int kRJ = FX > 0 ? (kTX + 2 + FX - 1) / FX : kTX + 2;     // S outputs per run
  extern __shared__ __align__(16) float sm[];
  const int fy = FY > 0 ? FY : fy_rt, fx = FX > 0 ? FX : fx_rt;
  const int nv = NV > 0 ? NV : nv_rt, nh = NH > 0 ? NH : nh_rt;
  const Geometry g(fy, fx, nv, nh);
  float* wv = sm;             // fy x nv
  float* wh = wv + fy * nv;   // fx x nh
  float* raw = sm + g.raw_off;
  float* vb = sm + g.v_off;
  float* sb = sm + g.s_off;   // kSRows x kSStride: (Y0 - 1 + r, X0 - 1 + q)

  const int c = blockIdx.z, tid = threadIdx.x;
  const int up_h = fy * h8, up_w = fx * w8;
  const int Y0 = blockIdx.y * kTY, X0 = blockIdx.x * kTX;
  const int Ya = max(Y0 - 1, 0), Yb = min(Y0 + kTY, up_h - 1);
  const int Xa = max(X0 - 1, 0), Xb = min(X0 + kTX, up_w - 1);
  const int jlo = Xa / fx, nvc = Xb / fx + nh - jlo;  // V columns jlo ..
  const int ilo = Ya / fy + dvmin, nri = Yb / fy + dvmin + nv - ilo;  // raw rows ilo ..

  for (int e = tid; e < fy * nv; e += kThreads) wv[e] = wv_g[e];
  for (int e = tid; e < fx * nh; e += kThreads) wh[e] = wh_g[e];
  // -inf on the ring lines just outside the plane, the only cells outside
  // it that an inside value's 3x3 window reaches (the S pass below writes
  // every cell inside)
  const int r_out = up_h - (Y0 - 1), q_out = up_w - (X0 - 1);
  for (int e = tid; e < kSStride; e += kThreads) {
    if (Y0 == 0) sb[e] = peaks::neg_inf();
    if (r_out < kSRows) sb[r_out * kSStride + e] = peaks::neg_inf();
  }
  for (int e = tid; e < kSRows; e += kThreads) {
    if (X0 == 0) sb[e * kSStride] = peaks::neg_inf();
    if (q_out < kTX + 2) sb[e * kSStride + q_out] = peaks::neg_inf();
  }
  const float* xc = heat + static_cast<size_t>(c) * h8 * w8;
  for (int e = tid; e < nri * nvc; e += kThreads) {
    const int ir = ilo + e / nvc, jr = jlo + e % nvc + dhmin;
    raw[e] = (ir >= 0 && ir < h8 && jr >= 0 && jr < w8) ? __ldg(xc + ir * w8 + jr) : 0.0f;
  }
  __syncthreads();

  // V[Y][jlo + q] for Y in [Ya, Yb]: thread (phase a, column q) takes the
  // rows Y = fy*i + a, a blur along i of raw column q with taps wv[a]
  for (int item = tid; item < fy * nvc; item += kThreads) {
    const int a = item / nvc, q = item % nvc;
    const int i0 = floor_div(Ya - a + fy - 1, fy), n = floor_div(Yb - a, fy) - i0 + 1;
    if (n <= 0) continue;
    float out[kRI];
    peaks::tap_run<NV, kRI, SKIP0>(raw + (i0 + dvmin - ilo) * nvc + q, nvc, wv + a * nv, nv,
                                   n, out);
#pragma unroll
    for (int m = 0; m < kRI; ++m) {
      if (m < n) vb[(fy * (i0 + m) + a - Ya) * g.v_stride + q] = out[m];
    }
  }
  __syncthreads();

  // S(Y, X) for the tile and ring inside the plane: thread (phase b, ring
  // row r) takes the columns X = fx*j + b, a blur along j of V's row
  for (int item = tid; item < fx * kSRows; item += kThreads) {
    const int b = item / kSRows, r = item % kSRows, Y = Y0 - 1 + r;
    if (Y < 0 || Y >= up_h) continue;
    const int j0 = floor_div(Xa - b + fx - 1, fx), n = floor_div(Xb - b, fx) - j0 + 1;
    if (n <= 0) continue;
    float out[kRJ];
    peaks::tap_run<NH, kRJ, SKIP0>(vb + (Y - Ya) * g.v_stride + j0 - jlo, 1, wh + b * nh, nh,
                                   n, out);
#pragma unroll
    for (int m = 0; m < kRJ; ++m) {
      if (m < n) sb[r * kSStride + fx * (j0 + m) + b - (X0 - 1)] = out[m];
    }
  }
  __syncthreads();

  peaks::nms_append<kTY, kTX, kRN, kThreads>(sb, kSStride, Y0, X0, up_h, up_w, thresh,
                                             lists + static_cast<size_t>(c) * up_h * up_w,
                                             counts + c);
}

template <int FY, int FX, int NV, int NH, bool SKIP0>
int launch_peaks(const float* heat, const float* wv, const float* wh, u64* lists,
                 int* counts, int C, int h8, int w8, int fy, int fx, int nv, int nh,
                 int dvmin, int dhmin, float thresh, cudaStream_t st) {
  const size_t smem = sizeof(float) * Geometry(fy, fx, nv, nh).floats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phase_peaks_kernel<FY, FX, NV, NH, SKIP0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((fx * w8 + kTX - 1) / kTX, (fy * h8 + kTY - 1) / kTY, C);
  phase_peaks_kernel<FY, FX, NV, NH, SKIP0><<<grid, kThreads, smem, st>>>(
      heat, wv, wh, lists, counts, h8, w8, fy, fx, nv, nh, dvmin, dhmin, thresh);
  return 0;
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// heat: (C, h8, w8) fp32; wv: (fy, nv); wh: (fx, nh); zero_taps: whether
// a tap t > 0 of either table weighs 0; lists: C * fy*h8 * fx*w8 keys of
// scratch; counts: (C,) int32, zeroed by the caller; scores/idx: (C,
// k_top), with 1 <= k_top <= 1024 and 1 <= cap <= 4096 (the wrapper
// checks). Returns cudaGetLastError() after the two launches.
extern "C" int smooth_nms_topk_raw_launch(
    const float* heat, const float* wv, const float* wh, u64* lists, int* counts,
    float* scores, int* idx, int C, int h8, int w8, int fy, int fx, int nv, int nh,
    int dvmin, int dhmin, int zero_taps, int k_top, float thresh, int cap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C > 0 && h8 > 0 && w8 > 0) {
    const int err = fy == 4 && fx == 4 && nv == 7 && nh == 7 && !zero_taps
        ? launch_peaks<4, 4, 7, 7, false>(heat, wv, wh, lists, counts, C, h8, w8, fy, fx, nv, nh,
                                   dvmin, dhmin, thresh, st)
        : launch_peaks<0, 0, 0, 0, true>(heat, wv, wh, lists, counts, C, h8, w8, fy, fx, nv, nh,
                                   dvmin, dhmin, thresh, st);
    if (err != 0) return err;
  }
  peaks::launch_select(lists, counts, scores, idx, C, static_cast<size_t>(fy) * h8 * fx * w8,
                       k_top, cap, st);
  return static_cast<int>(cudaGetLastError());
}
