"""The reference decode: the maps' post-graph and the PAF decoder of
the reference repo's native code (``tf_pose/pafprocess/pafprocess.cpp``),
a frozen copy of the program's NumPy oracle (``oracle/numpy_post.py``,
``oracle/numpy_decoder.py``, which the JAX package's tests hold equal to
the C++ decoder) with nothing imported from the program.

:func:`post` is ``numpy_post.full_post`` in float64 PyTorch, so that it
runs on the card: the TF1 area upsample (two contractions with the same
weight matrices), the 25-tap Gaussian blur (the same 25 shifted adds per
axis, in the same order) and the 3x3 max-pool NMS. :func:`process_paf`
is the NumPy decoder itself. :func:`decode` caps each part's peaks at
the program's K (32, or 128 where a part saturates 32, as the program's
adaptive escalation does) and returns humans as
``[({part: (x, y, score)}, human_score), ...]`` at the decode size.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
from scipy import stats

NUM_PARTS = 18
NUM_PAIRS = 19
# (part a, part b) of each limb and its (x, y) channels in the 38 PAF
# channels (reference ``pafprocess.h`` COCOPAIRS, COCOPAIRS_NET)
_PAIRS = np.array([
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
    [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
    [0, 15], [15, 17], [2, 16], [5, 17]])
_PAF_CH = np.array([
    [12, 13], [20, 21], [14, 15], [16, 17], [22, 23], [24, 25], [0, 1],
    [2, 3], [4, 5], [8, 9], [10, 11], [6, 7], [28, 29], [30, 31],
    [34, 35], [32, 33], [36, 37], [18, 19], [26, 27]])
PAIRS = _PAIRS


@dataclasses.dataclass(frozen=True)
class Params:
    """The reference decoder's constants (``pafprocess.h``) and the
    program's peak caps."""

    thresh_heat: float = 0.05
    thresh_vector_score: float = 0.05
    thresh_vector_cnt1: int = 8
    thresh_part_cnt: int = 4
    thresh_human_score: float = 0.4
    step_paf: int = 10
    max_peaks: int = 32
    escalated_max_peaks: int = 128


PARAMS = Params()


def _area_weights(in_size: int, out_size: int) -> np.ndarray:
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo = i * scale
        hi = (i + 1) * scale
        j0 = int(np.floor(lo))
        j1 = int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap
        w[i] /= scale
    return w


def _gauss_1d(kernlen: int = 25, nsig: float = 3.0) -> np.ndarray:
    interval = (2.0 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0,
                    kernlen + 1)
    return np.diff(stats.norm.cdf(x))


def post(maps57: torch.Tensor, up_h: int, up_w: int, kernlen: int = 25,
         nsig: float = 3.0):
    """(h8, w8, 57) maps -> (peaks (up_h, up_w, 19), paf_up (up_h, up_w,
    38)) in float64 on the maps' device: area upsample, blur, NMS."""
    dev = maps57.device
    x = maps57.double()
    wh = torch.from_numpy(_area_weights(x.shape[0], up_h)).to(dev)
    ww = torch.from_numpy(_area_weights(x.shape[1], up_w)).to(dev)
    up = torch.einsum("vw,iwc->ivc", ww, torch.einsum("ih,hwc->iwc", wh, x))
    heat, paf = up[..., :19], up[..., 19:]
    h, w, c = heat.shape
    pad = kernlen // 2
    k1 = _gauss_1d(kernlen, nsig)
    k1n = k1 / np.sqrt(np.outer(k1, k1).sum())
    xp = torch.zeros((h + 2 * pad, w + 2 * pad, c), dtype=torch.float64,
                     device=dev)
    xp[pad:pad + h, pad:pad + w] = heat
    tmp = torch.zeros((h, w + 2 * pad, c), dtype=torch.float64, device=dev)
    for i in range(kernlen):
        tmp += float(k1n[i]) * xp[i:i + h]
    smoothed = torch.zeros((h, w, c), dtype=torch.float64, device=dev)
    for j in range(kernlen):
        smoothed += float(k1n[j]) * tmp[:, j:j + w]
    sp = torch.full((h + 2, w + 2, c), -float("inf"), dtype=torch.float64,
                    device=dev)
    sp[1:1 + h, 1:1 + w] = smoothed
    pooled = torch.full_like(smoothed, -float("inf"))
    for di in range(3):
        for dj in range(3):
            pooled = torch.maximum(pooled, sp[di:di + h, dj:dj + w])
    peaks = torch.where(smoothed >= pooled, smoothed,
                        torch.zeros_like(smoothed))
    return peaks, paf


def cap_peaks(peaks: np.ndarray, k: int) -> np.ndarray:
    """Keep the top k peaks per part plane by score, the lowest flat
    index first among equal scores (the program's ``max_peaks`` cap)."""
    out = np.zeros_like(peaks)
    for p in range(peaks.shape[2]):
        plane = peaks[:, :, p]
        ys, xs = np.nonzero(plane > 0)
        if len(ys) > k:
            order = np.argsort(-plane[ys, xs], kind="stable")[:k]
            ys, xs = ys[order], xs[order]
        out[ys, xs, p] = plane[ys, xs]
    return out


def capped_peaks(peaks: np.ndarray, params: Params = PARAMS) -> np.ndarray:
    """The peaks the program decodes: capped at ``max_peaks``, or at the
    escalated cap where a part has more above the threshold."""
    above = (peaks[:, :, :NUM_PARTS] > params.thresh_heat).sum((0, 1))
    k = (params.escalated_max_peaks if (above > params.max_peaks).any()
         else params.max_peaks)
    return cap_peaks(peaks, k)


def decode(maps57: torch.Tensor, up_h: int, up_w: int,
           params: Params = PARAMS, round_to: torch.dtype = None):
    """One image's (h8, w8, 57) maps -> humans ``[({part: (x, y,
    score)}, human_score), ...]`` at the up_h x up_w decode size.
    ``round_to`` (the control) rounds the maps and the post-graph's
    outputs to that type."""
    if round_to is not None:
        maps57 = maps57.to(round_to)
    peaks, paf = post(maps57, up_h, up_w)
    if round_to is not None:
        peaks, paf = (t.to(round_to).double() for t in (peaks, paf))
    peaks = capped_peaks(peaks.cpu().numpy(), params)
    res = process_paf(peaks, None, paf.cpu().numpy(), params)
    humans = []
    for hi in range(res.parts.shape[0]):
        parts = {}
        for p in range(NUM_PARTS):
            cid, x, y, s = res.parts[hi, p]
            if cid >= 0:
                parts[p] = (int(x), int(y), float(s))
        humans.append((parts, float(res.scores[hi])))
    return humans




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


def _score_all(peaks_a: Sequence[Peak], peaks_b: Sequence[Peak],
               paf_map: np.ndarray, ch_x: int, ch_y: int,
               params: Params):
    """The reference's line-integral score of every (a, b) pair: float64
    throughout, the 10 samples summed in order, each sample point
    rounded as the reference's roundpaf, floor(v + 0.5), and (ok,
    criterion2) per pair."""
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
                 params: Params) -> List[Connection]:
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
             params: Params) -> List[np.ndarray]:
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
                    # disjoint rows: fuse (empty slots: -1 + -1 + 1 = -1)
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
                params: Params = PARAMS) -> OracleResult:
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
