// PAF candidate scoring on the raw stride-8 planes: geometry, the 10-sample
// line integral and both criteria of every limb candidate in one launch.
//
// Replaces tfpose_tpu/ops/pallas/paf_score.py:paf_sample_scores_pallas
// (body _kernel) together with the XLA ops around it in
// tfpose_tpu/ops/paf.py:score_candidates_pallas_batch (the candidate
// geometry, the lane-packed per-sample arrays and the criteria). For
// image b, limb pair p = (part pa, part pb) and candidate q = a * K + bb
// (peak a of part pa, peak bb of part pb):
//   d = b - a, norm = |d|, safe = norm > 1e-12, v = d / norm (0 if unsafe)
//   sample s at round_half_up(a + d * s / S) on the upsampled grid, read
//   on the raw planes at (y // fy, x // fx):  u_s = Px * vx + Py * vy
//   mean = (sum_s u_s) * (1/S),  cnt = #{s : u_s > thresh}
//   score = mean + min(0.5 * up_h / max(norm, 1e-12) - 1, 0)
//   ok = cnt > cnt_min && score > 0 && safe && valid_a && valid_b
// Every operation is rounded on its own in the order the plain PyTorch
// version (ops/kernels/paf_score.py) takes (__fmul_rn / __fadd_rn /
// __fdiv_rn / __frcp_rn / __fsqrt_rn; no fused multiply-add, which once
// flipped cnt at the threshold). The row skip of the JAX kernel stays:
// with prefix_valid, candidates in rows of 128 at or beyond
// nrows = any(valid_b) ? ceil(#valid_a * K / 128) : 0 take mean = cnt = 0.
//
// Design: one thread per candidate, one block of 256 candidates of one
// (image, pair); the block counts the pair's valid peaks with
// __syncthreads_count. The pair table and the S sample steps (computed on
// the host as the plain version computes them) are a __grid_constant__
// parameter. The PAF is read in place, any strides, through the read-only
// cache: a live candidate gathers 2 x S values; a dead one reads nothing.
// The TPU kernel's lane-packed per-sample arrays (24.9 MB at B=8, K=32)
// and its one-hot MXU row select have no counterpart.
//
// Bound on an H100 at the batch path's shape (B=8, 46 x 54 raw planes,
// K=32): the peaks (41 KB), 5 B of result per candidate (0.78 MB) and
// each PAF cell a live candidate samples, once (at most 2 x S x 4 B per
// live candidate; dead ones and unsampled cells cost nothing), over
// 3.35 TB/s; about 16 operations per candidate and 131 per live one are
// below it. Bytes bound it; at these sizes launch latency and one
// thread's S dependent gathers set the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;     // candidates per row of the row skip
constexpr int kMaxPairs = 32;
constexpr int kMaxSteps = 64;

struct Tables {
  int part_a[kMaxPairs], part_b[kMaxPairs];  // the pair's two parts
  int ch_x[kMaxPairs], ch_y[kMaxPairs];      // its PAF channels
  float steps[kMaxSteps];                    // s / S, rounded to fp32
};

__device__ __forceinline__ int sample_cell(float a, float d, float step, int n_up, int f) {
  const float v = __fadd_rn(__fadd_rn(a, __fmul_rn(d, step)), 0.5f);
  const int i = static_cast<int>(floorf(v));
  return min(max(i, 0), n_up - 1) / f;
}

__global__ void __launch_bounds__(kThreads)
score_candidates_kernel(const int* __restrict__ px, const int* __restrict__ py,
                        const unsigned char* __restrict__ pvalid,
                        const float* __restrict__ paf, float* __restrict__ score,
                        unsigned char* __restrict__ ok, const __grid_constant__ Tables tab,
                        int parts, int K, long long sb, long long sy, long long sx,
                        long long sc, int up_h, int up_w, int fy, int fx, int S,
                        float thresh, float cnt_min, float inv_s, int prefix_valid) {
  const float half_h = 0.5f * static_cast<float>(up_h);  // exact
  const int b = blockIdx.z, p = blockIdx.y, tid = threadIdx.x;
  const int kk = K * K, q = blockIdx.x * kThreads + tid;
  const size_t ra = (static_cast<size_t>(b) * parts + tab.part_a[p]) * K;
  const size_t rb = (static_cast<size_t>(b) * parts + tab.part_b[p]) * K;

  int nrows = (kk + kLanes - 1) / kLanes;
  if (prefix_valid) {
    int na = 0, nb = 0;
    for (int base = 0; base < K; base += kThreads) {
      const int i = base + tid;
      na += __syncthreads_count(i < K && pvalid[ra + i]);
      nb += __syncthreads_count(i < K && pvalid[rb + i]);
    }
    nrows = nb > 0 ? (na * K + kLanes - 1) / kLanes : 0;
  }
  if (q >= kk) return;

  const int a = q / K, bb = q % K;
  const float ax = static_cast<float>(px[ra + a]), ay = static_cast<float>(py[ra + a]);
  const float dx = __fsub_rn(static_cast<float>(px[rb + bb]), ax);
  const float dy = __fsub_rn(static_cast<float>(py[rb + bb]), ay);
  const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const bool safe = norm > 1e-12f;
  const float clamped = fmaxf(norm, 1e-12f);
  const float inv = safe ? __frcp_rn(clamped) : 0.0f;
  const float vx = __fmul_rn(dx, inv), vy = __fmul_rn(dy, inv);

  float mean = 0.0f, cnt = 0.0f;
  if (q / kLanes < nrows) {
    const float* img = paf + b * sb;
    const float* chx = img + tab.ch_x[p] * sc;
    const float* chy = img + tab.ch_y[p] * sc;
    float sum = 0.0f;
#pragma unroll 10
    for (int s = 0; s < S; ++s) {
      const float st = tab.steps[s];
      const long long cell = sample_cell(ay, dy, st, up_h, fy) * sy +
                             sample_cell(ax, dx, st, up_w, fx) * sx;
      const float u = __fadd_rn(__fmul_rn(__ldg(chx + cell), vx),
                                __fmul_rn(__ldg(chy + cell), vy));
      sum = __fadd_rn(sum, u);
      cnt += u > thresh ? 1.0f : 0.0f;
    }
    mean = __fmul_rn(sum, inv_s);
  }
  const float penalty = fminf(__fsub_rn(__fdiv_rn(half_h, clamped), 1.0f), 0.0f);
  const float crit = __fadd_rn(mean, penalty);
  const size_t o = (static_cast<size_t>(b) * gridDim.y + p) * kk + q;
  score[o] = crit;
  ok[o] = cnt > cnt_min && crit > 0.0f && safe && pvalid[ra + a] && pvalid[rb + bb];
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, y: (B, parts, K) int32 and valid: (B, parts, K) bool (one byte) peaks;
// paf: raw PAF planes on the device, element (b, y, x, ch) at
// b * sb + y * sy + x * sx + ch * sc; score: (B, P, K, K) fp32 and
// ok: (B, P, K, K) bool results. pairs_host: (P, 4) int32 on the host,
// each pair's (part a, part b, x channel, y channel), P <= 32; steps_host:
// (S,) fp32 on the host, S <= 64; inv_s: 1/S as the plain version rounds
// it. The upsampled grid is (up_h, up_w) = (fy * h8, fx * w8). Returns
// cudaGetLastError() after the launch.
extern "C" int score_candidates_raw_launch(
    const int* x, const int* y, const unsigned char* valid, const float* paf, float* score,
    unsigned char* ok, const int* pairs_host, const float* steps_host, int B, int parts, int P,
    int K, long long sb, long long sy, long long sx, long long sc, int up_h, int up_w, int fy,
    int fx, int S, float thresh, float cnt_min, float inv_s, int prefix_valid, void* stream) {
  if (P < 0 || P > kMaxPairs || S < 1 || S > kMaxSteps || K < 0 || fy < 1 || fx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables tab = {};
  for (int i = 0; i < P; ++i) {
    tab.part_a[i] = pairs_host[4 * i];
    tab.part_b[i] = pairs_host[4 * i + 1];
    tab.ch_x[i] = pairs_host[4 * i + 2];
    tab.ch_y[i] = pairs_host[4 * i + 3];
  }
  for (int s = 0; s < S; ++s) tab.steps[s] = steps_host[s];
  if (B > 0 && P > 0 && K > 0) {
    const dim3 grid((K * K + kThreads - 1) / kThreads, P, B);
    score_candidates_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, valid, paf, score, ok, tab, parts, K, sb, sy, sx, sc, up_h, up_w, fy, fx, S,
        thresh, cnt_min, inv_s, prefix_valid);
  }
  return static_cast<int>(cudaGetLastError());
}
