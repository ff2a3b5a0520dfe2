"""Limb-to-human assembly as fixed-shape label propagation.

Port of ``tfpose_tpu/ops/assemble.py:assemble_dense`` (reference
``pafprocess.cpp`` step 4), batched over a leading image dim. The
semantics, from the JAX module's docstring:

  * the spanning-tree pairs 0..16 reduce to connected components: nodes
    are (18 parts x K slots), edges the accepted connections; min-label
    propagation with path compression (a fixed 10 rounds, more than the
    tree's diameter needs) finds them;
  * the two redundant ear<->shoulder pairs (17, 18) follow the
    reference's SEQUENTIAL, SLOT-BASED loop: each connection either fuses
    two occupancy-disjoint rows (adding its score), or, when the rows
    overlap or the ear is in no row's slot, adds the ear to a target
    row (the earlier-created row, or the shoulder's row), displacing that
    row's current ear slot owner, count += 1, score += peak + conn;
  * per-component part counts and mean scores are thresholded
    (THRESH_PART_CNT, THRESH_HUMAN_SCORE), and the kept components are
    compacted in node order and padded to ``max_humans``; ears are
    displayed from the slot owners, other parts from the highest-scoring
    member (ties to the lowest slot).

The JAX version writes every scatter as a dense one-hot matmul because
scatters serialise under ``vmap`` on the TPU; here they are the scatter
and gather ops PyTorch has on both devices. A floating-point
``scatter_add`` on the card sums with atomics in an order that changes
from run to run, so the per-component score sums go through
:func:`segment_sum`, which is exact and so independent of that order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import NUM_PARTS, pairs_array
from tfpose_tpu_torch.ops.nms import Peaks
from tfpose_tpu_torch.ops.paf import Connections

_LABEL_ITERS = 10


class Assembled(NamedTuple):
    """Padded decode result (pre-normalisation, heatmap pixel coords);
    every tensor has the batch dims of the input first."""

    coords: torch.Tensor        # (max_humans, 18, 2) float32 (x, y), -1 pad
    part_scores: torch.Tensor   # (max_humans, 18) float32
    part_valid: torch.Tensor    # (max_humans, 18) bool
    human_scores: torch.Tensor  # (max_humans,) float32 (score sum / count)
    human_valid: torch.Tensor   # (max_humans,) bool
    # (18,) bool — every top-K slot of the part is above threshold: the
    # decode MAY have dropped real peaks of that part
    peak_saturated: torch.Tensor


def segment_sum(index: torch.Tensor, values: torch.Tensor,
                n: int) -> torch.Tensor:
    """(B, M) fp32 ``values`` summed into (B, n) segments by ``index``,
    accumulated in fp64 and rounded to fp32 once. An fp64 sum of fp32
    values is exact while they lie within about 2^28 of each other in
    magnitude (the part and connection scores summed here lie within a
    few binades), so the result does not depend on the order the card's
    atomic adds take: it is the same on every run and on the CPU."""
    out = torch.zeros(values.shape[0], n, dtype=torch.float64,
                      device=values.device)
    return out.scatter_add(1, index, values.double()).float()


def _at(vals: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """vals[b, index[b, ...]] for (B, N) vals."""
    return vals.gather(1, index.reshape(index.shape[0], -1)).reshape(
        index.shape)


def _pick(vals: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """vals[b, index[b]] for (B, N, ...) vals and (B,) index."""
    return vals[torch.arange(vals.shape[0], device=vals.device), index]


def assemble_dense(peaks: Peaks, conns: Connections,
                   params: DecodeParams) -> Assembled:
    """Peaks (B, 18, K) + connections (B, 19, K) -> Assembled (B, ...);
    unbatched (18, K) / (19, K) inputs give unbatched outputs."""
    if peaks.x.dim() == 2:
        out = assemble_dense(Peaks(*(t[None] for t in peaks)),
                             Connections(*(t[None] for t in conns)), params)
        return Assembled(*(t[0] for t in out))
    dev = peaks.x.device
    bsz, num_parts, k = peaks.x.shape
    assert num_parts == NUM_PARTS
    n = num_parts * k
    pairs = pairs_array()
    part_ids = torch.arange(num_parts, device=dev)
    max_h = params.max_humans
    iota_n = torch.arange(n, dtype=torch.long, device=dev).expand(bsz, n)

    node_part = torch.arange(num_parts, device=dev).repeat_interleave(k)
    node_x = peaks.x.reshape(bsz, n).float()
    node_y = peaks.y.reshape(bsz, n).float()
    node_score = peaks.score.reshape(bsz, n).float()

    pair_t = torch.as_tensor(pairs, dtype=torch.long, device=dev)
    a_node = (pair_t[:, 0].repeat_interleave(k) * k
              + conns.a_slot.reshape(bsz, -1).long().clamp(min=0))
    b_node = (pair_t[:, 1].repeat_interleave(k) * k
              + conns.b_slot.reshape(bsz, -1).long().clamp(min=0))
    e_score = conns.score.reshape(bsz, -1).float()
    e_valid = conns.valid.reshape(bsz, -1)
    n_e = e_valid.shape[1]
    e_pair = torch.arange(pairs.shape[0], device=dev).repeat_interleave(k)
    # pair-major flattening with greedy-rank slots inside: the edge index
    # IS the reference's connection processing order
    order_e = torch.arange(n_e, device=dev).expand(bsz, n_e)
    big_order = n_e + 1

    tree = e_valid & (e_pair < 17)
    big = torch.full_like(a_node, n)
    labels = iota_n.clone()
    for _ in range(_LABEL_ITERS):
        m = torch.where(tree, torch.minimum(_at(labels, a_node),
                                            _at(labels, b_node)), big)
        labels = labels.scatter_reduce(1, a_node, m, "amin")
        labels = labels.scatter_reduce(1, b_node, m, "amin")
        labels = _at(labels, labels)
    labels0 = _at(labels, labels)

    tree_i = tree.long()
    used = torch.zeros(bsz, n, dtype=torch.long, device=dev)
    used = used.scatter_reduce(1, a_node, tree_i, "amax")
    used = used.scatter_reduce(1, b_node, tree_i, "amax").bool()

    # ---- per-root state (values live at root node positions)
    pres = torch.zeros(bsz, n * num_parts, dtype=torch.long, device=dev)
    pres = pres.scatter_reduce(1, labels0 * num_parts + node_part,
                               used.long(), "amax")
    pres = pres.reshape(bsz, n, num_parts).bool()
    creation = torch.full((bsz, n), big_order, dtype=torch.long, device=dev)
    creation = creation.scatter_reduce(
        1, _at(labels0, a_node),
        torch.where(tree, order_e, torch.full_like(order_e, big_order)),
        "amin")

    def init_owner(p2):
        vals = torch.where(used & (node_part == p2), iota_n,
                           torch.full_like(iota_n, -1))
        return torch.full_like(iota_n, -1).scatter_reduce(
            1, labels0, vals, "amax")

    owner16 = init_owner(int(pairs[17, 1]))
    owner17 = init_owner(int(pairs[18, 1]))
    bon_s = torch.zeros(bsz, n, dtype=torch.float32, device=dev)
    bon_c = torch.zeros(bsz, n, dtype=torch.long, device=dev)

    def run_pair(pair_id, labels, pres, o_this, o_other, creation, bon_s,
                 bon_c):
        """The reference's sequential loop over one redundant pair's K
        greedy connections, for all images at once. A slot with no valid
        connection changes nothing, so the walk stops at the first slot
        that is invalid in every image (greedy fills slots 0..m-1)."""
        p2 = int(pairs[pair_id, 1])
        for t in range(k):
            e = pair_id * k + t
            ve = e_valid[:, e]
            if not bool(ve.any()):
                break
            a, b = a_node[:, e], b_node[:, e]
            es = e_score[:, e]
            ra = _pick(labels, a)
            in_a = _pick(used, a) & ve
            ps_b = _pick(node_score, b)
            match_b = o_this == b[:, None]
            has_b = match_b.any(1) & ve
            rb = torch.where(match_b, iota_n, -1).amax(1).clamp(min=0)
            pres_a = _pick(pres, ra)
            pres_b = _pick(pres, rb) & has_b[:, None]
            overlap = (pres_a & pres_b).any(1)
            differ = in_a & has_b & (ra != rb)
            fuse = differ & ~overlap
            attach = differ & overlap
            extend = in_a & ~has_b
            r1 = torch.where(_pick(creation, ra) <= _pick(creation, rb),
                             ra, rb)
            do_b = attach | extend
            tgt = torch.where(attach, r1, ra)
            oh_t = (iota_n == tgt[:, None]) & do_b[:, None]
            bon_s = bon_s + torch.where(oh_t, (ps_b + es)[:, None], 0.0)
            bon_c = bon_c + oh_t.long()
            o_this = torch.where(oh_t, b[:, None], o_this)
            pres = pres | (oh_t[..., None] & (part_ids == p2))
            # fuse: relabel to the min root; merge per-root state into it
            rmin, rmax = torch.minimum(ra, rb), torch.maximum(ra, rb)
            oh_min = (iota_n == rmin[:, None]) & fuse[:, None]
            oh_max = (iota_n == rmax[:, None]) & fuse[:, None]
            both = pres_a | pres_b
            pres = torch.where(oh_min[..., None], both[:, None, :], pres)
            pres = pres & ~oh_max[..., None]

            def merge(arr, red, dead):
                v = red(_pick(arr, rmin), _pick(arr, rmax))
                arr = torch.where(oh_min, v[:, None], arr)
                return torch.where(oh_max, torch.full_like(arr, dead), arr)

            o_this = merge(o_this, torch.maximum, -1)
            o_other = merge(o_other, torch.maximum, -1)
            creation = merge(creation, torch.minimum, big_order)
            bon_s = bon_s + torch.where(oh_min, es[:, None], 0.0)
            labels = torch.where(fuse[:, None] & (labels == rmax[:, None]),
                                 rmin[:, None], labels)
        return labels, pres, o_this, o_other, creation, bon_s, bon_c

    labels, pres, owner16, owner17, creation, bon_s, bon_c = run_pair(
        17, labels0, pres, owner16, owner17, creation, bon_s, bon_c)
    labels, pres, owner17, owner16, creation, bon_s, bon_c = run_pair(
        18, labels, pres, owner17, owner16, creation, bon_s, bon_c)
    root = labels

    # ---- per-root aggregates
    score_sum = segment_sum(
        torch.cat([_at(root, a_node), root], 1),
        torch.cat([torch.where(tree, e_score, 0.0),
                   torch.where(used, node_score, 0.0) + bon_s], 1), n)
    count = torch.zeros(bsz, n, dtype=torch.long, device=dev).scatter_add(
        1, root, used.long() + bon_c)

    is_root = used & (root == iota_n)
    mean = score_sum / count.clamp(min=1).float()
    keep = (is_root
            & (count >= params.thresh_part_cnt)
            & (mean >= params.thresh_human_score))
    rank = keep.long().cumsum(1) - 1
    human_of_root = torch.where(keep & (rank < max_h), rank,
                                torch.full_like(rank, max_h))

    # ---- winner per (human, part): max score among used members, ties
    # to the lowest slot; nodes of part p are slots [p*K, (p+1)*K)
    node_h = _at(human_of_root, root).reshape(bsz, num_parts, k)
    used_blk = used.reshape(bsz, num_parts, k)
    score_blk = node_score.reshape(bsz, num_parts, k)
    h_iota = torch.arange(max_h + 1, device=dev)
    member = used_blk[..., None] & (node_h[..., None] == h_iota)
    contrib = torch.where(member, score_blk[..., None], -float("inf"))
    best = contrib.amax(2, keepdim=True)                  # (B, P, 1, H+1)
    is_best = member & (contrib >= best)
    slot_ids = torch.arange(k, device=dev)[None, None, :, None]
    min_slot = torch.where(is_best, slot_ids, k).amin(2)  # (B, P, H+1)
    p_valid = (min_slot < k).transpose(1, 2)              # (B, H+1, P)
    win = min_slot.clamp(max=k - 1)
    x_blk = node_x.reshape(bsz, num_parts, k)
    y_blk = node_y.reshape(bsz, num_parts, k)
    coords_x = x_blk.gather(2, win).transpose(1, 2)
    coords_y = y_blk.gather(2, win).transpose(1, 2)
    p_scores = score_blk.gather(2, win).transpose(1, 2)

    # ---- ears from the slot owners, like the reference's rows
    node_hr = node_h.reshape(bsz, n)
    for owner, pid in ((owner16, 17), (owner17, 18)):
        p2 = int(pairs[pid, 1])
        valid_o = owner >= 0
        h_arr = torch.where(valid_o, node_hr, torch.full_like(node_hr, max_h))
        o_safe = owner.clamp(min=0)
        has = torch.zeros(bsz, max_h + 1, dtype=torch.long, device=dev)
        has = has.scatter_reduce(1, h_arr, valid_o.long(), "amax").bool()
        for arr, blk in ((coords_x, node_x), (coords_y, node_y),
                         (p_scores, node_score)):
            v = torch.zeros(bsz, max_h + 1, dtype=torch.float32, device=dev)
            v = v.scatter_add(1, h_arr, torch.where(
                valid_o, _at(blk, o_safe), 0.0))
            arr[:, :, p2] = torch.where(has, v, arr[:, :, p2])
        p_valid[:, :, p2] = has

    coords = torch.stack([
        torch.where(p_valid, coords_x, -1.0),
        torch.where(p_valid, coords_y, -1.0)], -1)[:, :max_h]
    part_scores = torch.where(p_valid, p_scores, 0.0)[:, :max_h]

    human_scores = torch.zeros(bsz, max_h + 1, dtype=torch.float32,
                               device=dev)
    human_scores = human_scores.scatter_add(
        1, human_of_root, torch.where(keep, mean, 0.0))[:, :max_h]
    human_valid = torch.zeros(bsz, max_h + 1, dtype=torch.long, device=dev)
    human_valid = human_valid.scatter_reduce(
        1, human_of_root, keep.long(), "amax")[:, :max_h].bool()
    return Assembled(coords=coords, part_scores=part_scores,
                     part_valid=p_valid[:, :max_h], human_scores=human_scores,
                     human_valid=human_valid,
                     peak_saturated=peaks.valid.all(-1))
