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

Each step follows a :class:`Skeleton` (``skeletons/<name>.json``, found
by the name an architecture file gives): the heat / PAF split, the
parts, the limbs in the decoder's order with their PAF channels, and
the redundant limbs. COCO-18 (``coco18``, the reference's tables) is
the default.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import FrozenSet, List, Sequence

import numpy as np
import torch

from posebench.lib import spec

DEFAULT_SKELETON = "coco18"


@dataclasses.dataclass(frozen=True, eq=False)
class Skeleton:
    """``parts`` part planes and a background make the ``heat_channels``;
    limb i joins parts ``pairs[i]`` and reads PAF channels
    ``paf_channels[i]`` (x, y; counted after the heat channels); a
    ``redundant`` limb joins two humans' parts but never starts one."""

    name: str
    parts: int
    heat_channels: int
    pairs: np.ndarray          # (limbs, 2) part a, part b
    paf_channels: np.ndarray   # (limbs, 2) x, y
    redundant: FrozenSet[int]

    @property
    def limbs(self) -> int:
        return len(self.pairs)


def skeleton(name: str = DEFAULT_SKELETON, root: str = spec.ROOT
             ) -> Skeleton:
    """The skeleton ``skeletons/<name>.json``, its tables checked."""
    return _skeleton(os.path.abspath(root), name)


@functools.lru_cache(maxsize=None)
def _skeleton(root: str, name: str) -> Skeleton:
    doc = spec.skeleton(name, root)
    pairs = np.array(doc["pairs"], np.int64).reshape(-1, 2)
    paf = np.array(doc["paf_channels"], np.int64).reshape(-1, 2)
    parts, limbs = int(doc["parts"]), len(pairs)
    redundant = frozenset(int(i) for i in doc["redundant"])
    if (len(paf) != limbs or not parts < int(doc["heat_channels"])
            or pairs.min(initial=0) < 0 or pairs.max(initial=0) >= parts
            or sorted(paf.ravel().tolist()) != list(range(2 * limbs))
            or not redundant <= set(range(limbs))):
        raise ValueError(f"skeleton {name}: its pairs, PAF channels, "
                         f"parts and redundant limbs do not agree")
    pairs.setflags(write=False)
    paf.setflags(write=False)
    return Skeleton(name, parts, int(doc["heat_channels"]), pairs, paf,
                    redundant)


def _or_default(sk: Skeleton = None) -> Skeleton:
    return skeleton() if sk is None else sk


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
    from scipy import stats

    interval = (2.0 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0,
                    kernlen + 1)
    return np.diff(stats.norm.cdf(x))


def post(maps: torch.Tensor, up_h: int, up_w: int, kernlen: int = 25,
         nsig: float = 3.0, skeleton: Skeleton = None):
    """(h8, w8, heat + PAF) maps -> (peaks (up_h, up_w, heat), paf_up
    (up_h, up_w, PAF)) in float64 on the maps' device: area upsample,
    blur, NMS."""
    sk = _or_default(skeleton)
    if maps.shape[-1] != sk.heat_channels + 2 * sk.limbs:
        raise ValueError(f"{maps.shape[-1]} map channels; skeleton "
                         f"{sk.name} has {sk.heat_channels} heat and "
                         f"{2 * sk.limbs} PAF channels")
    dev = maps.device
    x = maps.double()
    wh = torch.from_numpy(_area_weights(x.shape[0], up_h)).to(dev)
    ww = torch.from_numpy(_area_weights(x.shape[1], up_w)).to(dev)
    up = torch.einsum("vw,iwc->ivc", ww, torch.einsum("ih,hwc->iwc", wh, x))
    heat, paf = up[..., :sk.heat_channels], up[..., sk.heat_channels:]
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


def capped_peaks(peaks: np.ndarray, params: Params = PARAMS,
                 skeleton: Skeleton = None) -> np.ndarray:
    """The peaks the program decodes: capped at ``max_peaks``, or at the
    escalated cap where a part has more above the threshold."""
    parts = _or_default(skeleton).parts
    above = (peaks[:, :, :parts] > params.thresh_heat).sum((0, 1))
    k = (params.escalated_max_peaks if (above > params.max_peaks).any()
         else params.max_peaks)
    return cap_peaks(peaks, k)


def decode(maps: torch.Tensor, up_h: int, up_w: int,
           params: Params = PARAMS, round_to: torch.dtype = None,
           skeleton: Skeleton = None):
    """One image's (h8, w8, heat + PAF) maps -> humans ``[({part: (x, y,
    score)}, human_score), ...]`` at the up_h x up_w decode size.
    ``round_to`` (the control) rounds the maps and the post-graph's
    outputs to that type."""
    sk = _or_default(skeleton)
    if round_to is not None:
        maps = maps.to(round_to)
    peaks, paf = post(maps, up_h, up_w, skeleton=sk)
    if round_to is not None:
        peaks, paf = (t.to(round_to).double() for t in (peaks, paf))
    peaks = capped_peaks(peaks.cpu().numpy(), params, sk)
    res = process_paf(peaks, None, paf.cpu().numpy(), params, sk)
    humans = []
    for hi in range(res.parts.shape[0]):
        parts = {}
        for p in range(sk.parts):
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


def find_peaks(peaks_map: np.ndarray, thresh_heat: float,
               skeleton: Skeleton = None) -> List[List[Peak]]:
    """Scan peak planes in (part, y, x) order assigning global ids."""
    out: List[List[Peak]] = []
    next_id = 0
    for part in range(_or_default(skeleton).parts):
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
             params: Params, skeleton: Skeleton = None) -> List[np.ndarray]:
    """Merge greedy connections into subset rows (reference semantics).

    Row layout, P parts: [0:P] part cids (-1 = missing), [P] score sum,
    [P + 1] count.
    """
    sk = _or_default(skeleton)
    n, score, count = sk.parts, sk.parts, sk.parts + 1
    subset: List[np.ndarray] = []
    for pair_id in range(sk.limbs):
        p1, p2 = int(sk.pairs[pair_id, 0]), int(sk.pairs[pair_id, 1])
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
                    row[count] += 1
                    row[score] += conn.peak_score2 + conn.score
            elif len(found_idx) == 2:
                r1, r2 = subset[found_idx[0]], subset[found_idx[1]]
                membership = 0
                for i in range(n):
                    if r1[i] >= 0 and r2[i] >= 0:
                        membership = 2
                        break
                if membership == 0:
                    # disjoint rows: fuse (empty slots: -1 + -1 + 1 = -1)
                    for i in range(n):
                        r1[i] += r2[i] + 1
                    r1[score] += r2[score] + conn.score
                    r1[count] += r2[count]
                    del subset[found_idx[1]]
                else:
                    r1[p2] = conn.cid2
                    r1[count] += 1
                    r1[score] += conn.peak_score2 + conn.score
            elif len(found_idx) == 0 and pair_id not in sk.redundant:
                row = np.full(n + 2, -1.0, dtype=np.float64)
                row[p1] = conn.cid1
                row[p2] = conn.cid2
                row[count] = 2
                row[score] = (conn.peak_score1 + conn.peak_score2
                              + conn.score)
                subset.append(row)
    # final filtering
    kept = []
    for row in subset:
        if row[count] < params.thresh_part_cnt:
            continue
        if row[score] / row[count] < params.thresh_human_score:
            continue
        kept.append(row)
    return kept


@dataclasses.dataclass
class OracleResult:
    """Decoded humans in array form: see fields."""

    # (n_humans, parts, 4): [cid, x, y, score]; cid = -1 where missing
    parts: np.ndarray
    # (n_humans,): score sum / part count (reference get_score)
    scores: np.ndarray
    # raw subset rows for exact-parity tests
    subset: List[np.ndarray]


def process_paf(peaks_map: np.ndarray, heat_map: np.ndarray,
                paf_map: np.ndarray, params: Params = PARAMS,
                skeleton: Skeleton = None) -> OracleResult:
    """Full oracle decode. Shapes: peaks/heat (H, W, heat channels), paf
    (H, W, PAF channels).

    ``heat_map`` is accepted for signature parity with the reference but,
    as in the reference native decoder, scores are read from the peaks
    plane (which holds the Gaussian-smoothed maxima).
    """
    sk = _or_default(skeleton)
    peaks_by_part = find_peaks(np.asarray(peaks_map), params.thresh_heat,
                               sk)
    peaks_by_id = {}
    for plist in peaks_by_part:
        for p in plist:
            peaks_by_id[p.id] = p
    connections_by_pair: List[List[Connection]] = []
    for pair_id in range(sk.limbs):
        p1, p2 = int(sk.pairs[pair_id, 0]), int(sk.pairs[pair_id, 1])
        ch_x, ch_y = (int(c) for c in sk.paf_channels[pair_id])
        connections_by_pair.append(
            connect_pair(peaks_by_part[p1], peaks_by_part[p2],
                         np.asarray(paf_map), ch_x, ch_y, params))
    subset = assemble(connections_by_pair, params, sk)

    n = len(subset)
    parts = np.full((n, sk.parts, 4), -1.0, dtype=np.float64)
    scores = np.zeros((n,), dtype=np.float64)
    for hi, row in enumerate(subset):
        for part in range(sk.parts):
            cid = int(row[part])
            if cid < 0:
                continue
            pk = peaks_by_id[cid]
            parts[hi, part] = (cid, pk.x, pk.y, pk.score)
        scores[hi] = row[sk.parts] / row[sk.parts + 1]
    return OracleResult(parts=parts, scores=scores, subset=subset)
