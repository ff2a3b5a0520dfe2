// Native parity decoder — C++ twin of tfpose_tpu_torch/oracle/numpy_decoder.py,
// the port's own copy of tfpose_tpu/oracle/cpp/pafdecode.cpp (the same
// source, so that the port's parity sweep needs nothing of the JAX package).
//
// Reimplements the reference native decoder's semantics
// (tf_pose/pafprocess/pafprocess.cpp: peak scan -> PAF line-integral
// candidate scoring -> greedy non-conflicting selection -> subset
// merging -> thresholds) from the published OpenPose PAF algorithm
// (arXiv:1611.08050) and the constants recorded in SURVEY.md §2.1.
// NOT a copy of the reference sources (mount was empty; see SURVEY §0).
//
// Exposed with a plain C ABI for ctypes (no SWIG/pybind dependency).
// tfpose_tpu_torch/oracle/cpp/__init__.py builds it at first use:
//   g++ -O2 -shared -fPIC -o <tfpose_tpu_torch/_build/...>.so pafdecode.cpp

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kNumParts = 18;
constexpr int kNumPairs = 19;
constexpr int kHeatCh = 19;
constexpr int kPafCh = 38;

const int kPairs[kNumPairs][2] = {
    {1, 2},  {1, 5},   {2, 3},  {3, 4},  {5, 6},  {6, 7},  {1, 8},
    {8, 9},  {9, 10},  {1, 11}, {11, 12}, {12, 13}, {1, 0}, {0, 14},
    {14, 16}, {0, 15}, {15, 17}, {2, 16}, {5, 17}};

const int kPafXY[kNumPairs][2] = {
    {12, 13}, {20, 21}, {14, 15}, {16, 17}, {22, 23}, {24, 25}, {0, 1},
    {2, 3},   {4, 5},   {8, 9},   {10, 11}, {6, 7},   {28, 29}, {30, 31},
    {34, 35}, {32, 33}, {36, 37}, {18, 19}, {26, 27}};

struct Peak {
  int x, y, id;
  float score;
};

struct Conn {
  float score;
  int cid1, cid2;
  float ps1, ps2;
};

inline int roundpaf(float v) { return static_cast<int>(v + 0.5f); }

}  // namespace

extern "C" {

// peaks/heat: (h, w, 19) row-major; paf: (h, w, 38).
// out_parts: (max_humans, 18, 4) [cid, x, y, score], -1 where missing.
// out_scores: (max_humans,). Returns number of humans (clamped).
int process_paf(const float* peaks_map, const float* /*heat_map*/,
                const float* paf_map, int h, int w, float* out_parts,
                float* out_scores, int max_humans, float thresh_heat,
                float thresh_vector_score, int thresh_vector_cnt1,
                int thresh_part_cnt, float thresh_human_score,
                int step_paf) {
  // 1. peak scan, (part, y, x) order, global ids
  std::vector<std::vector<Peak>> peaks(kNumParts);
  std::vector<Peak> by_id;
  int next_id = 0;
  for (int p = 0; p < kNumParts; ++p) {
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        float v = peaks_map[(y * w + x) * kHeatCh + p];
        if (v > thresh_heat) {
          Peak pk{x, y, next_id++, v};
          peaks[p].push_back(pk);
          by_id.push_back(pk);
        }
      }
    }
  }

  // 2-3. candidates + greedy per pair
  std::vector<std::vector<Conn>> conns(kNumPairs);
  for (int pid = 0; pid < kNumPairs; ++pid) {
    const int p1 = kPairs[pid][0], p2 = kPairs[pid][1];
    const int chx = kPafXY[pid][0], chy = kPafXY[pid][1];
    struct Cand {
      float score;
      const Peak *a, *b;
    };
    std::vector<Cand> cands;
    for (const Peak& a : peaks[p1]) {
      for (const Peak& b : peaks[p2]) {
        float dx = static_cast<float>(b.x - a.x);
        float dy = static_cast<float>(b.y - a.y);
        float norm = std::sqrt(dx * dx + dy * dy);
        if (norm < 1e-12f) continue;
        float vx = dx / norm, vy = dy / norm;
        float sx = dx / step_paf, sy = dy / step_paf;
        float sum = 0.f;
        int cnt = 0;
        for (int i = 0; i < step_paf; ++i) {
          int lx = roundpaf(a.x + i * sx);
          int ly = roundpaf(a.y + i * sy);
          float s = vx * paf_map[(ly * w + lx) * kPafCh + chx] +
                    vy * paf_map[(ly * w + lx) * kPafCh + chy];
          sum += s;
          if (s > thresh_vector_score) ++cnt;
        }
        float crit2 =
            sum / step_paf + std::min(0.f, 0.5f * h / norm - 1.0f);
        if (cnt > thresh_vector_cnt1 && crit2 > 0.f)
          cands.push_back({crit2, &a, &b});
      }
    }
    std::stable_sort(cands.begin(), cands.end(),
                     [](const Cand& l, const Cand& r) {
                       return l.score > r.score;
                     });
    std::vector<char> used_a(peaks[p1].size(), 0),
        used_b(peaks[p2].size(), 0);
    for (const Cand& c : cands) {
      size_t ia = c.a - peaks[p1].data(), ib = c.b - peaks[p2].data();
      if (used_a[ia] || used_b[ib]) continue;
      used_a[ia] = used_b[ib] = 1;
      conns[pid].push_back(
          {c.score, c.a->id, c.b->id, c.a->score, c.b->score});
    }
  }

  // 4. subset merging (rows: 18 cids + score sum + count)
  struct Row {
    float v[20];
  };
  std::vector<Row> subset;
  for (int pid = 0; pid < kNumPairs; ++pid) {
    const int p1 = kPairs[pid][0], p2 = kPairs[pid][1];
    for (const Conn& c : conns[pid]) {
      int f1 = -1, f2 = -1, found = 0;
      for (size_t si = 0; si < subset.size(); ++si) {
        if (subset[si].v[p1] == c.cid1 || subset[si].v[p2] == c.cid2) {
          if (found == 0) f1 = static_cast<int>(si);
          if (found == 1) f2 = static_cast<int>(si);
          if (++found == 2) break;
        }
      }
      if (found == 1) {
        Row& r = subset[f1];
        if (r.v[p2] != c.cid2) {
          r.v[p2] = static_cast<float>(c.cid2);
          r.v[19] += 1;
          r.v[18] += c.ps2 + c.score;
        }
      } else if (found == 2) {
        Row &r1 = subset[f1], &r2 = subset[f2];
        bool overlap = false;
        for (int i = 0; i < kNumParts; ++i)
          if (r1.v[i] >= 0 && r2.v[i] >= 0) {
            overlap = true;
            break;
          }
        if (!overlap) {
          for (int i = 0; i < kNumParts; ++i) r1.v[i] += r2.v[i] + 1;
          r1.v[18] += r2.v[18] + c.score;
          r1.v[19] += r2.v[19];
          subset.erase(subset.begin() + f2);
        } else {
          r1.v[p2] = static_cast<float>(c.cid2);
          r1.v[19] += 1;
          r1.v[18] += c.ps2 + c.score;
        }
      } else if (found == 0 && pid < 17) {
        Row r;
        std::fill(r.v, r.v + 20, -1.f);
        r.v[p1] = static_cast<float>(c.cid1);
        r.v[p2] = static_cast<float>(c.cid2);
        r.v[19] = 2;
        r.v[18] = c.ps1 + c.ps2 + c.score;
        subset.push_back(r);
      }
    }
  }

  // 5. filter + emit
  int n = 0;
  for (const Row& r : subset) {
    if (r.v[19] < thresh_part_cnt) continue;
    if (r.v[18] / r.v[19] < thresh_human_score) continue;
    if (n >= max_humans) break;
    float* out = out_parts + n * kNumParts * 4;
    for (int p = 0; p < kNumParts; ++p) {
      int cid = static_cast<int>(r.v[p]);
      if (cid < 0) {
        out[p * 4 + 0] = out[p * 4 + 1] = out[p * 4 + 2] = out[p * 4 + 3] =
            -1.f;
      } else {
        const Peak& pk = by_id[cid];
        out[p * 4 + 0] = static_cast<float>(cid);
        out[p * 4 + 1] = static_cast<float>(pk.x);
        out[p * 4 + 2] = static_cast<float>(pk.y);
        out[p * 4 + 3] = pk.score;
      }
    }
    out_scores[n] = r.v[18] / r.v[19];
    ++n;
  }
  return n;
}

}  // extern "C"
