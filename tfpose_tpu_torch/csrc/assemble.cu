// Limb-to-human assembly (K5): peaks and greedy connections of an image to
// padded humans, in one launch.
//
// Replaces no Pallas kernel: tfpose_tpu/ops/assemble.py:assemble_dense is
// jnp code. Its PyTorch port (ops/assemble.py:assemble_dense_plain) runs
// about 1,300 small eager ops and 10 host syncs a call at B=16, each moving
// a few KB, so the host's launch overhead, not the card, set its time. This
// kernel does the same steps for one image per block, every per-node array
// in shared memory:
//   1. min-label propagation over the accepted connections of the tree
//      pairs, all but the two redundant pairs r0 and r0 + 1 (nodes are
//      parts x K slots): Jacobi rounds (labels of
//      both ends lowered to the min of the pair's labels as they stood at
//      the round's start), each followed by a path compression; at most
//      label_iters rounds, fewer where a round changes nothing (a fixed
//      point), then one more compression;
//   2. per-root state: used nodes, part presence as a bit mask, creation
//      order (lowest edge index), and the ear owners of the two redundant
//      pairs (highest node index); presence and owners count only the
//      nodes of pairs before r0, the rows the reference's sequential loop
//      holds when it reaches the redundant pairs (a tree pair after them,
//      such as BODY_25's foot limbs, only hangs new parts on a row);
//   3. the redundant pairs' connections walked slot by slot in the
//      reference's sequential order: fuse two rows with disjoint parts
//      (relabel to the lower root, merge the root state), or attach the ear
//      to the earlier-created row, or extend the shoulder's row with it;
//   4. per-root sums of the scores in fp64, rounded to fp32 once, counts,
//      both thresholds, compaction of the kept roots in node order to
//      max_h, the best-scoring member per (human, part) with ties to the
//      lowest slot, the ears from the slot owners;
//   5. the outputs, coordinates multiplied by (sx, sy) where >= 0 when
//      normalise is set.
// Each step rounds as the plain version's ops do (__fadd_rn, __fdiv_rn,
// __fmul_rn, __double2float_rn). Sums in fp64 of fp32 values in a few
// binades are exact, so the order of the shared-memory atomics does not
// show, as it does not in the plain version's scatter_add on the card.
//
// Bound: the dependent chain of the redundant-pair walk (up to 2K steps of
// three __syncthreads each; 3-5 steps on real scenes), then the label
// rounds. Not bytes: the inputs are ~15 KB an image at K=32 (~250 KB at
// B=16), read once. Shared memory grows with K and max_h (49 B a node,
// 17 B a connection, 36 B a human): 19.4 KB at (K, max_h) = (16, 16),
// 38.8 KB at (32, 32), 152.9 KB at (128, 64), above 48 KB through the
// dynamic-size opt-in.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kMaxParts = 32;  // part presence is a 32-bit mask
constexpr int kMaxPairs = 32;
constexpr int kMaxK = 128;
constexpr int kMaxThreads = 1024;

struct Topology {
  int part_a[kMaxPairs], part_b[kMaxPairs];
};

__host__ __device__ constexpr size_t align8(size_t x) { return (x + 7) & ~static_cast<size_t>(7); }

// Byte offsets of the arrays in dynamic shared memory: n nodes, ne
// connections, max_h humans.
struct Layout {
  size_t sum, labels, tmp, pres, creation, own0, own1, bon_c, count, score, bon_s, ea, eb, es,
      em, root_of_h, ear_has, ear_val, eflag, used, total;

  __host__ __device__ Layout(int n, int ne, int max_h) {
    size_t off = 0;
    auto take = [&off](size_t bytes) {
      const size_t at = off;
      off = align8(off + bytes);
      return at;
    };
    sum = take(8u * n);
    labels = take(4u * n);
    tmp = take(4u * n);
    pres = take(4u * n);
    creation = take(4u * n);
    own0 = take(4u * n);
    own1 = take(4u * n);
    bon_c = take(4u * n);
    count = take(4u * n);
    score = take(4u * n);
    bon_s = take(4u * n);
    ea = take(4u * ne);
    eb = take(4u * ne);
    es = take(4u * ne);
    em = take(4u * ne);
    root_of_h = take(4u * max_h);
    ear_has = take(4u * 2 * max_h);
    ear_val = take(4u * 2 * 3 * max_h);
    eflag = take(ne);
    used = take(n);
    total = off;
  }
};

template <typename T>
__device__ __forceinline__ T* at(char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

constexpr unsigned char kValid = 1, kTree = 2, kBefore = 4;
// used[i]: the node is in a tree connection; and in one before r0
constexpr unsigned char kUsed = 1, kUsedBefore = 2;

__global__ void __launch_bounds__(kMaxThreads)
assemble_kernel(const int* __restrict__ px, const int* __restrict__ py,
                const float* __restrict__ pscore, const unsigned char* __restrict__ pvalid,
                const int* __restrict__ ca, const int* __restrict__ cb,
                const float* __restrict__ cscore, const unsigned char* __restrict__ cvalid,
                float* __restrict__ coords, float* __restrict__ part_scores,
                unsigned char* __restrict__ part_valid, float* __restrict__ human_scores,
                unsigned char* __restrict__ human_valid, unsigned char* __restrict__ saturated,
                const __grid_constant__ Topology topo, int parts, int P, int r0, int K,
                int max_h, int label_iters, int thresh_cnt, float thresh_score, int normalise,
                float sx, float sy) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_rb;
  __shared__ int s_warp[32];
  const int n = parts * K, ne = P * K, T = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x, big_order = ne + 1;
  const Layout L(n, ne, max_h);
  double* sum = at<double>(smem, L.sum);
  int* labels = at<int>(smem, L.labels);
  int* tmp = at<int>(smem, L.tmp);
  unsigned* pres = at<unsigned>(smem, L.pres);
  int* creation = at<int>(smem, L.creation);
  int* own[2] = {at<int>(smem, L.own0), at<int>(smem, L.own1)};
  int* bon_c = at<int>(smem, L.bon_c);
  int* count = at<int>(smem, L.count);
  float* score = at<float>(smem, L.score);
  float* bon_s = at<float>(smem, L.bon_s);
  int* ea = at<int>(smem, L.ea);
  int* eb = at<int>(smem, L.eb);
  float* es = at<float>(smem, L.es);
  int* em = at<int>(smem, L.em);
  int* root_of_h = at<int>(smem, L.root_of_h);
  int* ear_has = at<int>(smem, L.ear_has);
  float* ear_val = at<float>(smem, L.ear_val);
  unsigned char* eflag = at<unsigned char>(smem, L.eflag);
  unsigned char* used = at<unsigned char>(smem, L.used);
  const size_t node0 = static_cast<size_t>(b) * n, edge0 = static_cast<size_t>(b) * ne;
  const int ear_part[2] = {topo.part_b[r0], topo.part_b[r0 + 1]};

  // ---- 0. load; per-root state at its initial values
  for (int i = tid; i < n; i += T) {
    labels[i] = i;
    used[i] = 0;
    pres[i] = 0u;
    creation[i] = big_order;
    own[0][i] = own[1][i] = -1;
    bon_c[i] = count[i] = 0;
    sum[i] = 0.0;
    bon_s[i] = 0.0f;
    score[i] = pscore[node0 + i];
  }
  for (int e = tid; e < ne; e += T) {
    const int p = e / K;
    // invalid slots hold -1 (clamped to 0 as the plain version does);
    // valid ones lie in 0..K-1
    ea[e] = topo.part_a[p] * K + min(max(ca[edge0 + e], 0), K - 1);
    eb[e] = topo.part_b[p] * K + min(max(cb[edge0 + e], 0), K - 1);
    es[e] = cscore[edge0 + e];
    const bool v = cvalid[edge0 + e] != 0;
    const bool tree = p != r0 && p != r0 + 1;
    eflag[e] = (v ? kValid : 0) | (v && tree ? kTree : 0) | (v && p < r0 ? kBefore : 0);
  }
  for (int h = tid; h < max_h; h += T) {
    root_of_h[h] = -1;
    ear_has[h] = ear_has[max_h + h] = 0;
  }
  for (int j = tid; j < 6 * max_h; j += T) ear_val[j] = 0.0f;
  for (int p = tid; p < parts; p += T) {
    bool all = true;
    for (int s = 0; s < K; ++s) all = all && pvalid[node0 + p * K + s] != 0;
    saturated[static_cast<size_t>(b) * parts + p] = all;
  }
  if (tid == 0) s_rb = -1;
  __syncthreads();

  // ---- 1. connected components of the spanning-tree connections
  for (int it = 0; it < label_iters; ++it) {
    for (int e = tid; e < ne; e += T)
      if (eflag[e] & kTree) em[e] = min(labels[ea[e]], labels[eb[e]]);
    __syncthreads();
    int changed = 0;
    for (int e = tid; e < ne; e += T) {
      if (!(eflag[e] & kTree)) continue;
      const int m = em[e];
      changed |= atomicMin(&labels[ea[e]], m) > m;
      changed |= atomicMin(&labels[eb[e]], m) > m;
    }
    __syncthreads();
    for (int i = tid; i < n; i += T) tmp[i] = labels[labels[i]];
    __syncthreads();
    for (int i = tid; i < n; i += T) {
      changed |= tmp[i] != labels[i];
      labels[i] = tmp[i];
    }
    // labels only fall, so a round that lowered none is a fixed point
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = tid; i < n; i += T) tmp[i] = labels[labels[i]];
  __syncthreads();
  for (int i = tid; i < n; i += T) labels[i] = tmp[i];
  for (int e = tid; e < ne; e += T)
    if (eflag[e] & kTree) used[ea[e]] = used[eb[e]] = kUsed;
  __syncthreads();
  for (int e = tid; e < ne; e += T)
    if (eflag[e] & kBefore) used[ea[e]] = used[eb[e]] = kUsed | kUsedBefore;
  __syncthreads();

  // ---- 2. per-root state (values live at root node positions)
  for (int i = tid; i < n; i += T) {
    if (!(used[i] & kUsedBefore)) continue;
    const int p = i / K, r = labels[i];
    atomicOr(&pres[r], 1u << p);
    for (int q = 0; q < 2; ++q)
      if (p == ear_part[q]) atomicMax(&own[q][r], i);
  }
  for (int e = tid; e < ne; e += T)
    if (eflag[e] & kTree) atomicMin(&creation[labels[ea[e]]], e);
  __syncthreads();

  // ---- 3. the redundant pairs, connection by connection. Every thread
  // takes the same decision from shared state; thread 0 updates the
  // per-root state, all threads relabel a fused row.
  for (int q = 0; q < 2; ++q) {
    const int pair = r0 + q;
    const unsigned ear_bit = 1u << ear_part[q];
    int* o_this = own[q];
    int* o_other = own[1 - q];
    for (int t = 0; t < K; ++t) {
      const int e = pair * K + t;
      if (!(eflag[e] & kValid)) break;  // greedy fills slots 0..m-1
      const int a = ea[e], bn = eb[e];
      for (int r = tid; r < n; r += T)
        if (o_this[r] == bn) atomicMax(&s_rb, r);
      __syncthreads();
      const int rb_raw = s_rb;
      const bool has_b = rb_raw >= 0, in_a = (used[a] & kUsedBefore) != 0;
      const int ra = labels[a], rb = has_b ? rb_raw : 0;
      const unsigned pres_a = pres[ra], pres_b = has_b ? pres[rb] : 0u;
      const bool differ = in_a && has_b && ra != rb;
      const bool fuse = differ && !(pres_a & pres_b);
      const bool attach = differ && (pres_a & pres_b);
      const bool extend = in_a && !has_b;
      const int rmin = min(ra, rb), rmax = max(ra, rb);
      __syncthreads();
      if (tid == 0) {
        s_rb = -1;
        if (attach || extend) {
          const int tgt = attach ? (creation[ra] <= creation[rb] ? ra : rb) : ra;
          bon_s[tgt] = __fadd_rn(bon_s[tgt], __fadd_rn(score[bn], es[e]));
          bon_c[tgt] += 1;
          o_this[tgt] = bn;
          pres[tgt] |= ear_bit;
        }
        if (fuse) {
          pres[rmin] = pres_a | pres_b;
          pres[rmax] = 0u;
          o_this[rmin] = max(o_this[rmin], o_this[rmax]);
          o_this[rmax] = -1;
          o_other[rmin] = max(o_other[rmin], o_other[rmax]);
          o_other[rmax] = -1;
          creation[rmin] = min(creation[rmin], creation[rmax]);
          creation[rmax] = big_order;
          bon_s[rmin] = __fadd_rn(bon_s[rmin], es[e]);
        }
      }
      if (fuse)
        for (int i = tid; i < n; i += T)
          if (labels[i] == rmax) labels[i] = rmin;
      __syncthreads();
    }
  }

  // ---- 4. per-root aggregates (labels are now the roots)
  for (int e = tid; e < ne; e += T)
    if (eflag[e] & kTree) atomicAdd(&sum[labels[ea[e]]], static_cast<double>(es[e]));
  for (int i = tid; i < n; i += T) {
    const int u = used[i] & kUsed;
    const float v = __fadd_rn(u ? score[i] : 0.0f, bon_s[i]);
    if (v != 0.0f) atomicAdd(&sum[labels[i]], static_cast<double>(v));
    const int c = u + bon_c[i];
    if (c) atomicAdd(&count[labels[i]], c);
  }
  __syncthreads();

  // kept roots, ranked in node order: each thread a contiguous chunk
  const int chunk = (n + T - 1) / T;
  const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  int local = 0;
  for (int i = lo; i < hi; ++i) {
    const int c = count[i];
    const float mean = __fdiv_rn(__double2float_rn(sum[i]), static_cast<float>(max(c, 1)));
    const bool keep = used[i] && labels[i] == i && c >= thresh_cnt && mean >= thresh_score;
    tmp[i] = keep;
    bon_s[i] = mean;
    local += keep;
  }
  const int lane = tid & 31, warp = tid >> 5, n_warps = T >> 5;
  int incl = local;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int total = s_warp[n_warps - 1];
  int rank = (warp > 0 ? s_warp[warp - 1] : 0) + incl - local;
  const size_t h0 = static_cast<size_t>(b) * max_h;
  for (int i = lo; i < hi; ++i) {
    int h = max_h;
    if (tmp[i]) {
      if (rank < max_h) {
        h = rank;
        root_of_h[h] = i;
        human_scores[h0 + h] = __fadd_rn(0.0f, bon_s[i]);
        human_valid[h0 + h] = 1;
      }
      ++rank;
    }
    tmp[i] = h;  // the human of root i, max_h where none
  }
  for (int h = tid; h < max_h; h += T) {
    if (h < total) continue;
    human_scores[h0 + h] = 0.0f;
    human_valid[h0 + h] = 0;
  }
  __syncthreads();

  // ---- 5. ears from the slot owners; then every (human, part)
  for (int r = tid; r < n; r += T) {
    for (int q = 0; q < 2; ++q) {
      const int o = own[q][r];
      if (o < 0) continue;
      const int h = tmp[labels[r]];
      if (h >= max_h) continue;
      const int j = q * max_h + h;
      atomicOr(&ear_has[j], 1);
      atomicAdd(&ear_val[3 * j], static_cast<float>(px[node0 + o]));
      atomicAdd(&ear_val[3 * j + 1], static_cast<float>(py[node0 + o]));
      atomicAdd(&ear_val[3 * j + 2], score[o]);
    }
  }
  __syncthreads();
  for (int item = tid; item < max_h * parts; item += T) {
    const int h = item / parts, p = item % parts;
    bool valid = false;
    float cx = 0.0f, cy = 0.0f, sc = 0.0f;
    if (root_of_h[h] >= 0) {
      const int q = p == ear_part[0] ? 0 : p == ear_part[1] ? 1 : -1;
      if (q >= 0) {
        const int j = q * max_h + h;
        valid = ear_has[j] != 0;
        cx = ear_val[3 * j];
        cy = ear_val[3 * j + 1];
        sc = ear_val[3 * j + 2];
      } else {
        int win = -1;
        float best = 0.0f;
        for (int s = 0; s < K; ++s) {
          const int i = p * K + s;
          if (used[i] && tmp[labels[i]] == h && (win < 0 || score[i] > best)) {
            best = score[i];
            win = s;
          }
        }
        if (win >= 0) {
          valid = true;
          cx = static_cast<float>(px[node0 + p * K + win]);
          cy = static_cast<float>(py[node0 + p * K + win]);
          sc = best;
        }
      }
    }
    float ox = valid ? cx : -1.0f, oy = valid ? cy : -1.0f;
    if (normalise) {
      ox = ox >= 0.0f ? __fmul_rn(ox, sx) : ox;
      oy = oy >= 0.0f ? __fmul_rn(oy, sy) : oy;
    }
    const size_t o = h0 * parts + item;
    coords[2 * o] = ox;
    coords[2 * o + 1] = oy;
    part_scores[o] = valid ? sc : 0.0f;
    part_valid[o] = valid;
  }
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Peaks x, y: (B, parts, K) int32, score fp32, valid bool; connections
// a_slot, b_slot: (B, P, K) int32, score fp32, valid bool (valid slots a
// prefix of each pair's K); outputs coords (B, max_h, parts, 2) fp32,
// part_scores (B, max_h, parts) fp32, part_valid bool, human_scores
// (B, max_h) fp32, human_valid bool, saturated (B, parts) bool; all
// contiguous on the device. pairs_host: (P, 2) int32 on the host, each
// pair's parts; r0 and r0 + 1 are the redundant ear pairs, the others span
// the tree (grown in order, core/topology.py:Skeleton). Returns
// cudaGetLastError() after the launch.
extern "C" int assemble_launch(const int* x, const int* y, const float* score,
                               const unsigned char* valid, const int* a_slot, const int* b_slot,
                               const float* c_score, const unsigned char* c_valid, float* coords,
                               float* part_scores, unsigned char* part_valid, float* human_scores,
                               unsigned char* human_valid, unsigned char* saturated,
                               const int* pairs_host, int B, int parts, int P, int r0, int K,
                               int max_h,
                               int label_iters, int thresh_cnt, float thresh_score, int normalise,
                               float sx, float sy, void* stream) {
  if (B < 0 || parts < 1 || parts > kMaxParts || P < 3 || P > kMaxPairs || r0 < 1 ||
      r0 + 1 >= P || K < 1 || K > kMaxK || max_h < 0 || label_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Topology topo = {};
  for (int i = 0; i < P; ++i) {
    topo.part_a[i] = pairs_host[2 * i];
    topo.part_b[i] = pairs_host[2 * i + 1];
    if (topo.part_a[i] < 0 || topo.part_a[i] >= parts || topo.part_b[i] < 0 ||
        topo.part_b[i] >= parts)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int n = parts * K, ne = P * K;
  const int threads = std::min(kMaxThreads, (std::max(n, ne) + 31) / 32 * 32);
  const size_t bytes = Layout(n, ne, max_h).total;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assemble_kernel<<<B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, score, valid, a_slot, b_slot, c_score, c_valid, coords, part_scores, part_valid,
      human_scores, human_valid, saturated, topo, parts, P, r0, K, max_h, label_iters,
      thresh_cnt, thresh_score, normalise, sx, sy);
  return static_cast<int>(cudaGetLastError());
}
