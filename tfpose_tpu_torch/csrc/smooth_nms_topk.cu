// Fused Gaussian smooth + 3x3 NMS + threshold + exact top-K on an
// already-upsampled heat map.
//
// Replaces tfpose_tpu/ops/pallas/smooth_nms.py:smooth_nms_topk_pallas
// (body _topk_kernel, top-K _topk_rounds), the decode route for upsample
// ratios that are not an integer replication of the stride-8 grid and for
// planes too large for the raw-grid kernel (smooth_nms_topk_raw.cu).
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
// Design: two kernels launched back to back on one stream.
//  1. peaks_kernel, one block per (32 x 32 tile, plane): the tile plus a
//     (K/2 + 1)-pixel halo goes to shared memory, the vertical pass covers
//     the tile and a one-pixel NMS ring, the horizontal pass gives that
//     ring's smoothed values, and each peak is appended to its plane's
//     candidate list in device memory as one 64-bit key (order-preserving
//     score bits, then the inverted flat index, so a larger key is a better
//     peak and keys are distinct), with one atomicAdd per warp. The
//     smoothed plane itself never reaches device memory.
//  2. select_kernel, one block per plane: a list of at most `cap` keys
//     (real scenes hold dozens to hundreds) is bitonic-sorted in shared
//     memory; a longer one (a plateau, noise) is cut exactly to its K
//     largest keys by an 8-bit radix select over the list in device
//     memory, and those K are sorted. Append order differs from run to
//     run; the result does not, because the keys are totally ordered.
// The wrapper sizes each plane's list for the worst case, H * W keys (every
// pixel of a plateau is a peak): 8 * C * H * W bytes, 33 MB at 360x640 and
// C = 18, 75 MB at 540x960.
//
// Bound on an H100 at the slice's shapes (360 x 640 x 18, a 1280x720 frame
// in 432x368 windows at upsample 4): 4.15 M values, 16.6 MB read, 5.0 us
// at 3.35 TB/s; 98 flops of blur and 9 compares per value, 0.44 G ops,
// 6.6 us at 67 TFLOP/s fp32. Operations bound it; the tile halo adds about
// half again of blur work, and the selection is latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kListCap = 4096;  // keys a plane's list may hold to be sorted in shared memory
typedef unsigned long long u64;

static_assert(kTile * kTile % kThreads == 0, "uniform trip count for the warp ballot");

// Larger key = higher score, then lower index. Never 0 for a real peak.
__device__ __forceinline__ u64 make_key(float s, int idx) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | (0xFFFFFFFFu - static_cast<unsigned>(idx));
}

__device__ __forceinline__ float key_score(u64 k) {
  unsigned u = static_cast<unsigned>(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 k) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(k & 0xFFFFFFFFull));
}

__global__ void __launch_bounds__(kThreads)
peaks_kernel(const float* __restrict__ x, const float* __restrict__ taps_g,
             u64* __restrict__ lists, int* __restrict__ counts, int H, int W,
             int klen, float thresh) {
  extern __shared__ __align__(16) float sm[];
  const int pad = klen / 2, halo = pad + 1;
  const int c = blockIdx.z, y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int in_h = kTile + 2 * halo, in_w = kTile + 2 * halo;
  const int s_h = kTile + 2, s_w = kTile + 2;
  float* taps = sm;              // klen
  float* xin = taps + klen;      // in_h x in_w, plane rows y0-halo.., cols x0-halo..
  float* vb = xin + in_h * in_w; // s_h x in_w, vertical sums for rows y0-1..
  float* sb = vb + s_h * in_w;   // s_h x s_w, smoothed rows y0-1.., cols x0-1..
  const int tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xc = x + c * plane;

  for (int e = tid; e < klen; e += blockDim.x) taps[e] = taps_g[e];
  for (int e = tid; e < in_h * in_w; e += blockDim.x) {
    const int yy = y0 - halo + e / in_w, xx = x0 - halo + e % in_w;
    xin[e] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? __ldg(xc + static_cast<size_t>(yy) * W + xx) : 0.0f;
  }
  __syncthreads();

  for (int e = tid; e < s_h * in_w; e += blockDim.x) {
    const int r = e / in_w, q = e % in_w;
    const float* col = xin + r * in_w + q;
    float acc = __fmul_rn(taps[0], col[0]);
    for (int k = 1; k < klen; ++k) acc = __fadd_rn(acc, __fmul_rn(taps[k], col[k * in_w]));
    vb[e] = acc;
  }
  __syncthreads();

  for (int e = tid; e < s_h * s_w; e += blockDim.x) {
    const int r = e / s_w, q = e % s_w;
    const int yy = y0 - 1 + r, xx = x0 - 1 + q;
    float acc = -__int_as_float(0x7f800000);  // -inf outside the plane
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* row = vb + r * in_w + q;
      acc = __fmul_rn(taps[0], row[0]);
      for (int k = 1; k < klen; ++k) acc = __fadd_rn(acc, __fmul_rn(taps[k], row[k]));
    }
    sb[e] = acc;
  }
  __syncthreads();

  u64* list = lists + c * plane;
  const int lane = tid & 31;
  for (int e = tid; e < kTile * kTile; e += blockDim.x) {
    const int r = e / kTile, q = e % kTile;
    const int yy = y0 + r, xx = x0 + q;
    const float s = sb[(r + 1) * s_w + q + 1];
    bool peak = yy < H && xx < W && s > thresh;
    for (int dy = 0; dy < 3 && peak; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        if (sb[(r + dy) * s_w + q + dx] > s) peak = false;
    const unsigned ballot = __ballot_sync(0xffffffffu, peak);
    if (ballot == 0u) continue;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counts + c, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (peak) {
      list[base + __popc(ballot & ((1u << lane) - 1u))] = make_key(s, yy * W + xx);
    }
  }
}

__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const u64* __restrict__ lists, const int* __restrict__ counts,
              float* __restrict__ scores, int* __restrict__ idx_out, size_t plane,
              int k_top, int cap) {
  __shared__ u64 keys[kListCap];
  __shared__ int hist[256];
  __shared__ int n_sel;
  __shared__ u64 s_prefix;
  __shared__ int s_rank;

  const int c = blockIdx.x, tid = threadIdx.x;
  const int n = counts[c];
  const u64* list = lists + c * plane;
  int m;  // keys to sort
  if (n <= cap) {
    for (int e = tid; e < n; e += blockDim.x) keys[e] = list[e];
    m = n;
  } else {
    // radix select of the k_top-th largest key, 8 bits at a time from the top
    u64 prefix = 0ull, mask = 0ull;
    int rank = k_top;  // 1 = largest, among keys matching prefix under mask
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int e = tid; e < 256; e += blockDim.x) hist[e] = 0;
      __syncthreads();
      for (int e = tid; e < n; e += blockDim.x) {
        const u64 k = list[e];
        if ((k & mask) == prefix) atomicAdd(hist + ((k >> shift) & 255ull), 1);
      }
      __syncthreads();
      if (tid == 0) {
        int above = 0, b = 255;
        for (; b > 0; --b) {
          if (above + hist[b] >= rank) break;
          above += hist[b];
        }
        s_prefix = prefix | (static_cast<u64>(b) << shift);
        s_rank = rank - above;
      }
      __syncthreads();
      prefix = s_prefix;
      rank = s_rank;
      mask |= 255ull << shift;
      __syncthreads();
    }
    // prefix is now the k_top-th largest key; keys are distinct, so exactly
    // k_top keys are >= it
    if (tid == 0) n_sel = 0;
    __syncthreads();
    for (int e = tid; e < n; e += blockDim.x) {
      const u64 k = list[e];
      if (k >= prefix) keys[atomicAdd(&n_sel, 1)] = k;
    }
    __syncthreads();
    m = n_sel;
  }

  // bitonic sort of keys[0, p) in descending order, padded with 0 keys
  int p = 1;
  while (p < m) p <<= 1;
  for (int e = m + tid; e < p; e += blockDim.x) keys[e] = 0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const u64 a = keys[i], b = keys[j];
          if ((i & size) == 0 ? a < b : a > b) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  float* out_s = scores + static_cast<size_t>(c) * k_top;
  int* out_i = idx_out + static_cast<size_t>(c) * k_top;
  for (int r = tid; r < k_top; r += blockDim.x) {
    out_s[r] = r < m ? key_score(keys[r]) : 0.0f;
    out_i[r] = r < m ? key_index(keys[r]) : -1;
  }
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (C, H, W) fp32; taps: (klen,) fp32; lists: C * H * W keys of scratch;
// counts: (C,) int32, zeroed by the caller; scores/idx: (C, k_top), with
// 1 <= k_top <= min(cap, 1024) and 0 <= cap <= kListCap (the wrapper checks).
// Returns cudaGetLastError() after the two launches.
extern "C" int smooth_nms_topk_launch(const float* x, const float* taps,
                                      u64* lists, int* counts, float* scores,
                                      int* idx, int C, int H, int W, int klen,
                                      int k_top, float thresh, int cap,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int halo = klen / 2 + 1;
  const int in_w = kTile + 2 * halo;
  const size_t smem =
      sizeof(float) * (klen + in_w * in_w + (kTile + 2) * in_w + (kTile + 2) * (kTile + 2));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (C > 0) {
    if (H > 0 && W > 0) {
      const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, C);
      peaks_kernel<<<grid, kThreads, smem, st>>>(x, taps, lists, counts, H, W,
                                                 klen, thresh);
    }
    select_kernel<<<C, kSelectThreads, 0, st>>>(
        lists, counts, scores, idx, static_cast<size_t>(H) * W, k_top, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
