// Shared pieces of the two top-K kernels (smooth_nms_topk.cu and
// smooth_nms_topk_raw.cu): peak keys, the tap run of a separable blur
// (also smooth_nms.cu's), the 3x3 NMS with its warp-ballot append, and the
// per-plane select.
//
// Both kernels run in two launches on one stream. A peaks pass, one block
// per output tile and plane, blurs the tile and its one-pixel ring into
// shared memory and appends every peak (smoothed value >= its 3x3
// neighbours, -inf outside the plane, and > thresh) to its plane's list in
// device memory as a 64-bit key. select_kernel, one block per plane, then
// cuts the list to its top K: a list of at most `cap` keys (real scenes
// hold dozens to hundreds) is bitonic-sorted in shared memory; a longer
// one (a plateau, noise) is cut exactly to its K largest keys by an 8-bit
// radix select over the list in device memory, and those K are sorted.
// Keys are distinct and totally ordered (score bits, then the inverted
// flat index), so the nondeterministic append order never shows.
//
// A header of shared code, included by each kernel's own source; every
// source still builds alone into its own library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace peaks {

typedef unsigned long long u64;

constexpr int kSelectThreads = 1024;
constexpr int kListCap = 4096;  // keys a plane's list may hold to be sorted in shared memory

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

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// n_out outputs of a 1-D blur run over the values src(0), src(1), ...:
//   out[j] = k[0]*src(j) + k[1]*src(j+1) + ... in tap order,
// every product and sum rounded (__fmul_rn / __fadd_rn, never a fused
// multiply-add), as the JAX kernels and the plain PyTorch versions sum.
// With SKIP0 a tap t > 0 of weight 0 is skipped, as the raw-grid kernel's
// phase weights are. NT > 0: NT taps known at compile time, the run's
// window (R + NT - 1 values) read once into registers, R independent sums
// for the scheduler to interleave, weights as compile-time-indexed
// operands. NT == 0: nt taps at run time, a plain loop that reads each
// value once per tap. src is any accessor: a strided array in shared
// memory (tap_run) or device memory with the caller's zero padding.
template <int NT, int R, bool SKIP0, typename Src>
__device__ __forceinline__ void tap_run_of(Src src, const float* __restrict__ k, int nt,
                                           int n_out, float (&out)[R]) {
  if constexpr (NT > 0) {
    float w[R + NT - 1];
#pragma unroll
    for (int i = 0; i < R + NT - 1; ++i) w[i] = i < n_out + NT - 1 ? src(i) : 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float acc = __fmul_rn(k[0], w[j]);
#pragma unroll
      for (int t = 1; t < NT; ++t) {
        const float sum = __fadd_rn(acc, __fmul_rn(k[t], w[j + t]));
        acc = SKIP0 && k[t] == 0.0f ? acc : sum;
      }
      out[j] = acc;
    }
  } else {
    for (int j = 0; j < n_out && j < R; ++j) {
      float acc = __fmul_rn(k[0], src(j));
      for (int t = 1; t < nt; ++t) {
        if (SKIP0 && k[t] == 0.0f) continue;
        acc = __fadd_rn(acc, __fmul_rn(k[t], src(j + t)));
      }
      out[j] = acc;
    }
  }
}

// tap_run_of over src[0], src[stride], src[2 * stride], ...
template <int NT, int R, bool SKIP0>
__device__ __forceinline__ void tap_run(const float* __restrict__ src, int stride,
                                        const float* __restrict__ k, int nt,
                                        int n_out, float (&out)[R]) {
  tap_run_of<NT, R, SKIP0>([src, stride](int i) { return src[i * stride]; }, k, nt, n_out,
                           out);
}

// 3x3 NMS, threshold and append over a TH x TW output tile whose smoothed
// values and one-pixel ring sit in shared memory: S[r * s_stride + q] is
// the value at plane row y0 - 1 + r, column x0 - 1 + q. Ring cells outside
// the plane next to it must hold -inf; cells farther out are read only for
// outputs outside the plane, which are never peaks. A thread owns one
// column and RN consecutive rows, keeping the row maxima of three columns
// as it walks down (3 loads per output). Every thread takes the same trip
// count, so each warp ballots together and appends its peaks with one
// atomicAdd.
template <int TH, int TW, int RN, int THREADS>
__device__ __forceinline__ void nms_append(const float* S, int s_stride, int y0,
                                           int x0, int H, int W, float thresh,
                                           u64* __restrict__ list,
                                           int* __restrict__ count) {
  constexpr int kRuns = (TH + RN - 1) / RN;
  constexpr int kItems = kRuns * TW;
  const int lane = threadIdx.x & 31;
  auto hmax = [&](int r, int q) {
    const float* p = S + r * s_stride + q;
    return fmaxf(p[0], fmaxf(p[1], p[2]));
  };
  for (int base = 0; base < kItems; base += THREADS) {
    const int item = base + static_cast<int>(threadIdx.x);
    const bool live = item < kItems;
    const int q = live ? item % TW : 0, r0 = live ? item / TW * RN : 0;
    float m0 = live ? hmax(r0, q) : 0.0f;
    float m1 = live && r0 < TH ? hmax(r0 + 1, q) : 0.0f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int r = r0 + j;
      const bool ok = live && r < TH;
      const float m2 = ok ? hmax(r + 2, q) : 0.0f;
      const float s = ok ? S[(r + 1) * s_stride + q + 1] : 0.0f;
      const int yy = y0 + r, xx = x0 + q;
      const bool peak = ok && yy < H && xx < W && s > thresh &&
                        s >= fmaxf(m0, fmaxf(m1, m2));
      const unsigned ballot = __ballot_sync(0xffffffffu, peak);
      if (ballot != 0u) {
        const int leader = __ffs(ballot) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(count, __popc(ballot));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (peak) list[at + __popc(ballot & ((1u << lane) - 1u))] = make_key(s, yy * W + xx);
      }
      m0 = m1;
      m1 = m2;
    }
  }
}

// One block per plane: the top k_top keys of the plane's list, sorted.
// A list no longer than max(cap, k_top) is sorted whole in shared memory;
// a longer one is cut to its k_top largest keys by a radix select first.
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
  if (n <= cap || n <= k_top) {
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

// The select launch that follows a peaks pass on the same stream.
inline void launch_select(const u64* lists, const int* counts, float* scores, int* idx,
                          int C, size_t plane, int k_top, int cap, cudaStream_t st) {
  if (C > 0) select_kernel<<<C, kSelectThreads, 0, st>>>(lists, counts, scores, idx, plane,
                                                         k_top, cap);
}

}  // namespace peaks
