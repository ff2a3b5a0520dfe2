"""NumPy decoder of the reference native decoder's semantics
(``tf_pose/pafprocess/pafprocess.cpp``): the port's copy of
``tfpose_tpu/oracle/numpy_decoder.py``, which the JAX package's tests
hold equal to its C++ twin (``tests/test_cpp_oracle.py``). It backs
``compat/pafprocess.py`` and ``PoseEstimator.estimate_paf``.

Constants (``DecodeParams`` defaults): THRESH_HEAT=0.05,
THRESH_VECTOR_SCORE=0.05, THRESH_VECTOR_CNT1=8, THRESH_PART_CNT=4,
THRESH_HUMAN_SCORE=0.4, NUM_PART=18, STEP_PAF=10.

Algorithm (reference ``process_paf(peaks, heatmap, pafmap)``):
  1. scan each of the 18 peak planes row-major for values > THRESH_HEAT,
     assigning global peak ids in (part, y, x) order;
  2. for each of the 19 limb pairs, score every (peak_a, peak_b) candidate
     by sampling STEP_PAF points along the segment and dotting the PAF
     vector with the normalized direction; keep candidates with more than
     THRESH_VECTOR_CNT1 samples above THRESH_VECTOR_SCORE and positive
     length-penalised mean score;
  3. sort candidates by score descending, greedily keep non-conflicting
     connections;
  4. merge connections into subset rows (18 part cids + score + count),
     fusing disjoint rows that share an endpoint;
  5. drop rows with count < THRESH_PART_CNT or score/count <
     THRESH_HUMAN_SCORE.

Deliberately simple, sequential NumPy; the fast path is ``ops/decode.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import (
    NUM_PAIRS,
    NUM_PARTS,
    pairs_array,
    paf_channels_array,
)

_PAIRS = pairs_array()
_PAF_CH = paf_channels_array()


@dataclasses.dataclass
class Peak:
    x: int
    y: int
    score: float
    id: int


@dataclasses.dataclass
class Connection:
    score: float       # length-penalised mean PAF score (criterion2)
    cid1: int          # global peak id of endpoint at pair part 1
    cid2: int
    peak_score1: float
    peak_score2: float


def _roundpaf(v: float) -> int:
    """Reference rounding: (int)(v + 0.5) for non-negative v."""
    return int(v + 0.5)


def find_peaks(peaks_map: np.ndarray, thresh_heat: float) -> List[List[Peak]]:
    """Scan peak planes in (part, y, x) order assigning global ids."""
    h, w, _ = peaks_map.shape
    out: List[List[Peak]] = []
    next_id = 0
    for part in range(NUM_PARTS):
        plane = peaks_map[:, :, part]
        part_peaks: List[Peak] = []
        ys, xs = np.nonzero(plane > thresh_heat)
        # np.nonzero is row-major (y outer, x inner) == reference scan order
        for y, x in zip(ys.tolist(), xs.tolist()):
            part_peaks.append(Peak(x=x, y=y, score=float(plane[y, x]),
                                   id=next_id))
            next_id += 1
        out.append(part_peaks)
    return out


def _score_pair(peak_a: Peak, peak_b: Peak, paf_map: np.ndarray,
                ch_x: int, ch_y: int, params: DecodeParams):
    """Line-integral score between two peaks; returns (ok, criterion2)."""
    h = paf_map.shape[0]
    dx = float(peak_b.x - peak_a.x)
    dy = float(peak_b.y - peak_a.y)
    norm = float(np.sqrt(dx * dx + dy * dy))
    if norm < 1e-12:
        return False, 0.0
    vx, vy = dx / norm, dy / norm
    step_x = dx / params.step_paf
    step_y = dy / params.step_paf
    scores_sum = 0.0
    count = 0
    for i in range(params.step_paf):
        lx = _roundpaf(peak_a.x + i * step_x)
        ly = _roundpaf(peak_a.y + i * step_y)
        s = vx * float(paf_map[ly, lx, ch_x]) + vy * float(paf_map[ly, lx, ch_y])
        scores_sum += s
        if s > params.thresh_vector_score:
            count += 1
    criterion2 = scores_sum / params.step_paf + min(
        0.0, 0.5 * h / norm - 1.0)
    ok = (count > params.thresh_vector_cnt1) and (criterion2 > 0.0)
    return ok, criterion2


def _score_all(peaks_a: Sequence[Peak], peaks_b: Sequence[Peak],
               paf_map: np.ndarray, ch_x: int, ch_y: int,
               params: DecodeParams):
    """Vectorised twin of :func:`_score_pair` over all (a, b) pairs —
    bitwise identical: float64 throughout, the sample sum accumulates
    in the same sequential order (a Python loop over the 10 samples
    with vectorised adds), and roundpaf = floor(v + 0.5) matches the
    scalar int(v + 0.5) for the non-negative coords involved."""
    h = paf_map.shape[0]
    ax = np.array([p.x for p in peaks_a], np.float64)
    ay = np.array([p.y for p in peaks_a], np.float64)
    bx = np.array([p.x for p in peaks_b], np.float64)
    by = np.array([p.y for p in peaks_b], np.float64)
    dx = bx[None, :] - ax[:, None]
    dy = by[None, :] - ay[:, None]
    norm = np.sqrt(dx * dx + dy * dy)
    valid = norm >= 1e-12
    safe = np.where(valid, norm, 1.0)
    vx, vy = dx / safe, dy / safe
    step_x = dx / params.step_paf
    step_y = dy / params.step_paf
    pafx = paf_map[:, :, ch_x].astype(np.float64)
    pafy = paf_map[:, :, ch_y].astype(np.float64)
    scores_sum = np.zeros_like(dx)
    count = np.zeros(dx.shape, np.int64)
    for i in range(params.step_paf):
        lx = np.floor(ax[:, None] + i * step_x + 0.5).astype(np.intp)
        ly = np.floor(ay[:, None] + i * step_y + 0.5).astype(np.intp)
        s = vx * pafx[ly, lx] + vy * pafy[ly, lx]
        scores_sum = scores_sum + s   # sequential, like the scalar loop
        count += s > params.thresh_vector_score
    criterion2 = scores_sum / params.step_paf + np.minimum(
        0.0, 0.5 * h / safe - 1.0)
    ok = (valid & (count > params.thresh_vector_cnt1)
          & (criterion2 > 0.0))
    return ok, criterion2


def connect_pair(peaks_a: Sequence[Peak], peaks_b: Sequence[Peak],
                 paf_map: np.ndarray, ch_x: int, ch_y: int,
                 params: DecodeParams) -> List[Connection]:
    """Candidate generation + greedy non-conflicting selection for one pair."""
    candidates = []
    if peaks_a and peaks_b:
        ok, crit = _score_all(peaks_a, peaks_b, paf_map, ch_x, ch_y,
                              params)
        for ia, pa in enumerate(peaks_a):      # a-major scan order
            for ib, pb in enumerate(peaks_b):
                if ok[ia, ib]:
                    candidates.append((float(crit[ia, ib]), pa, pb))
    # sort by score descending; stable so insertion (scan) order breaks ties
    candidates.sort(key=lambda c: -c[0])
    connections: List[Connection] = []
    used_a, used_b = set(), set()
    for score, pa, pb in candidates:
        if pa.id in used_a or pb.id in used_b:
            continue
        used_a.add(pa.id)
        used_b.add(pb.id)
        connections.append(Connection(score=score, cid1=pa.id, cid2=pb.id,
                                      peak_score1=pa.score,
                                      peak_score2=pb.score))
    return connections


def assemble(connections_by_pair: List[List[Connection]],
             params: DecodeParams) -> List[np.ndarray]:
    """Merge greedy connections into subset rows (reference semantics).

    Row layout: [0:18] part cids (-1 = missing), [18] score sum, [19] count.
    """
    subset: List[np.ndarray] = []
    for pair_id in range(NUM_PAIRS):
        p1, p2 = int(_PAIRS[pair_id, 0]), int(_PAIRS[pair_id, 1])
        for conn in connections_by_pair[pair_id]:
            found_idx = []
            for si, row in enumerate(subset):
                if row[p1] == conn.cid1 or row[p2] == conn.cid2:
                    found_idx.append(si)
                    if len(found_idx) == 2:
                        break
            if len(found_idx) == 1:
                row = subset[found_idx[0]]
                if row[p2] != conn.cid2:
                    row[p2] = conn.cid2
                    row[19] += 1
                    row[18] += conn.peak_score2 + conn.score
            elif len(found_idx) == 2:
                r1, r2 = subset[found_idx[0]], subset[found_idx[1]]
                membership = 0
                for i in range(NUM_PARTS):
                    if r1[i] >= 0 and r2[i] >= 0:
                        membership = 2
                        break
                if membership == 0:
                    # disjoint rows: fuse (empty slots are -1; -1 + -1 + 1 = -1)
                    for i in range(NUM_PARTS):
                        r1[i] += r2[i] + 1
                    r1[18] += r2[18] + conn.score
                    r1[19] += r2[19]
                    del subset[found_idx[1]]
                else:
                    r1[p2] = conn.cid2
                    r1[19] += 1
                    r1[18] += conn.peak_score2 + conn.score
            elif len(found_idx) == 0 and pair_id < 17:
                row = np.full(20, -1.0, dtype=np.float64)
                row[p1] = conn.cid1
                row[p2] = conn.cid2
                row[19] = 2
                row[18] = conn.peak_score1 + conn.peak_score2 + conn.score
                subset.append(row)
    # final filtering
    kept = []
    for row in subset:
        if row[19] < params.thresh_part_cnt:
            continue
        if row[18] / row[19] < params.thresh_human_score:
            continue
        kept.append(row)
    return kept


@dataclasses.dataclass
class OracleResult:
    """Decoded humans in array form: see fields."""

    # (n_humans, 18, 4): [cid, x, y, score]; cid = -1 where part missing
    parts: np.ndarray
    # (n_humans,): score sum / part count (reference get_score)
    scores: np.ndarray
    # raw subset rows for exact-parity tests
    subset: List[np.ndarray]


def process_paf(peaks_map: np.ndarray, heat_map: np.ndarray,
                paf_map: np.ndarray,
                params: DecodeParams = DecodeParams()) -> OracleResult:
    """Full oracle decode. Shapes: peaks/heat (H, W, 19), paf (H, W, 38).

    ``heat_map`` is accepted for signature parity with the reference but,
    as in the reference native decoder, scores are read from the peaks
    plane (which holds the Gaussian-smoothed maxima).
    """
    peaks_by_part = find_peaks(np.asarray(peaks_map), params.thresh_heat)
    peaks_by_id = {}
    for plist in peaks_by_part:
        for p in plist:
            peaks_by_id[p.id] = p
    connections_by_pair: List[List[Connection]] = []
    for pair_id in range(NUM_PAIRS):
        p1, p2 = int(_PAIRS[pair_id, 0]), int(_PAIRS[pair_id, 1])
        ch_x, ch_y = int(_PAF_CH[pair_id, 0]), int(_PAF_CH[pair_id, 1])
        connections_by_pair.append(
            connect_pair(peaks_by_part[p1], peaks_by_part[p2],
                         np.asarray(paf_map), ch_x, ch_y, params))
    subset = assemble(connections_by_pair, params)

    n = len(subset)
    parts = np.full((n, NUM_PARTS, 4), -1.0, dtype=np.float64)
    scores = np.zeros((n,), dtype=np.float64)
    for hi, row in enumerate(subset):
        for part in range(NUM_PARTS):
            cid = int(row[part])
            if cid < 0:
                continue
            pk = peaks_by_id[cid]
            parts[hi, part] = (cid, pk.x, pk.y, pk.score)
        scores[hi] = row[18] / row[19]
    return OracleResult(parts=parts, scores=scores, subset=subset)
