"""PAF line-integral candidate scoring and greedy connection selection.

Port of ``tfpose_tpu/ops/paf.py`` (reference ``pafprocess.cpp`` steps
2-3): every (peak_a, peak_b) candidate of every limb pair is scored in
one batched computation, and greedy non-conflicting selection is an
iterated masked argmax over all pairs at once. Functions take any
leading batch dims (the JAX ``vmap`` becomes an explicit batch dim).

Sampling matches the reference exactly: sample i (0 <= i < STEP_PAF) at
round_half_up(a + i * (b - a) / STEP_PAF); score = dot(PAF, unit dir);
criterion1 = #(samples > THRESH_VECTOR_SCORE) > THRESH_VECTOR_CNT1;
criterion2 = mean + min(0, 0.5 * H / dist - 1) > 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import COCO18, Skeleton
from tfpose_tpu_torch.ops.kernels.paf_score import (
    Candidates,
    candidate_geometry,
    criteria,
)
from tfpose_tpu_torch.ops.nms import Peaks


class Connections(NamedTuple):
    """Greedy-selected connections; tensors are (..., num_pairs, K).

    Invariant: valid connections occupy slots 0..m-1 contiguously per
    pair (greedy fills slots in acceptance order and acceptance is
    monotone). ``ops.assemble`` relies on this."""

    a_slot: torch.Tensor  # int32 slot into peaks of part pairs[p][0]
    b_slot: torch.Tensor  # int32 slot into peaks of part pairs[p][1]
    score: torch.Tensor   # float32 connection score
    valid: torch.Tensor   # bool


def _score_from_samples(px, py, vx, vy, norm, safe, av, bv, h,
                        params: DecodeParams) -> Candidates:
    """px/py: (..., limbs, K, K, S) sampled PAF x/y channels."""
    s = vx[..., None] * px + vy[..., None] * py
    cnt = (s > params.thresh_vector_score).sum(-1)
    return criteria(s.mean(-1), cnt, norm, safe, av, bv, h, params)


def score_candidates_batch(peaks_b: Peaks, paf_up_b: torch.Tensor,
                           params: DecodeParams,
                           skeleton: Skeleton = COCO18) -> Candidates:
    """Gather scorer: peaks (B, parts, K), ``paf_up_b`` (B, H, W, PAF
    channels) upsampled PAF maps -> Candidates (B, limbs, K, K)."""
    b, h, w, c = paf_up_b.shape
    vx, vy, norm, safe, av, bv, iy, ix = candidate_geometry(
        peaks_b, h, w, params, skeleton)
    pc = torch.as_tensor(skeleton.paf_channels_array(), dtype=torch.long,
                         device=paf_up_b.device)
    table = paf_up_b.float().reshape(b, h * w, c)
    flat = (iy.long() * w + ix.long()).reshape(b, -1)         # (B, LKKS)
    shape = iy.shape

    def channel(ch):  # ch: (L,) channel per limb
        chans = ch.view(1, -1, 1, 1, 1).expand(shape).reshape(b, -1)
        return table.reshape(b, -1)[
            torch.arange(b, device=flat.device)[:, None],
            flat * c + chans].reshape(shape)

    return _score_from_samples(channel(pc[:, 0]), channel(pc[:, 1]),
                               vx, vy, norm, safe, av, bv, h, params)


def score_candidates(peaks: Peaks, paf_up: torch.Tensor,
                     params: DecodeParams,
                     skeleton: Skeleton = COCO18) -> Candidates:
    """Score all candidates of one image. ``paf_up``: (H, W, PAF
    channels)."""
    out = score_candidates_batch(Peaks(*(t[None] for t in peaks)),
                                 paf_up[None], params, skeleton)
    return Candidates(score=out.score[0], ok=out.ok[0])


def greedy_connections(cands: Candidates,
                       params: DecodeParams) -> Connections:
    """Greedy non-conflicting selection per pair: the t-th masked argmax
    (ties to the first maximum) is the t-th accepted candidate of the
    reference's score-descending scan. All pairs of all images advance
    together; the loop ends after the round in which no pair took a
    connection (later rounds would leave every slot empty)."""
    del params
    score, ok = cands.score, cands.ok
    *lead, k, _ = score.shape
    dev = score.device
    neg = torch.tensor(-float("inf"), device=dev)
    lane_k = torch.arange(k, dtype=torch.int32, device=dev)
    flat_ids = torch.arange(k * k, dtype=torch.int32, device=dev)
    used_a = torch.zeros(*lead, k, dtype=torch.bool, device=dev)
    used_b = torch.zeros_like(used_a)
    a_sl = torch.full((*lead, k), -1, dtype=torch.int32, device=dev)
    b_sl = torch.full_like(a_sl, -1)
    sc = torch.zeros((*lead, k), dtype=torch.float32, device=dev)
    val = torch.zeros_like(used_a)
    for t in range(k):
        free = ok & ~used_a[..., :, None] & ~used_b[..., None, :]
        flat = torch.where(free, score, neg).reshape(*lead, k * k)
        best = flat.amax(-1)
        take = best > neg
        if not bool(take.any()):
            break
        arg = torch.where(flat == best[..., None], flat_ids,
                          k * k).amin(-1)
        ai, bi = arg // k, arg % k
        used_a |= (lane_k == ai[..., None]) & take[..., None]
        used_b |= (lane_k == bi[..., None]) & take[..., None]
        a_sl[..., t] = torch.where(take, ai, -1)
        b_sl[..., t] = torch.where(take, bi, -1)
        sc[..., t] = torch.where(take, best, 0.0)
        val[..., t] = take
    return Connections(a_slot=a_sl, b_slot=b_sl, score=sc, valid=val)
