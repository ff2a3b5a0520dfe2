"""The port's mesh over NCCL across four cards of one host, one rank a
card (``parallel/mesh.py:launch``), against the unsharded runs on the
first card: the (2 x 2) train step, the evaluator on (4 x 1) and on
(2 x 2) with rows split, and the rows-sharded forward on (1 x 4).

Marked ``cuda``: it skips without a card or below four (decided inside
the fixture, ``torch_cases.card``).
On four cards: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_mesh.py -q -rs``.
"""

import numpy as np
import pytest
import torch

import torch_cases
from torch_cases import (
    evaluate_on,
    rank_cards,
    rendered_coco,
    same_humans,
    sharded_forward,
    state_diff,
    train_steps,
)

pytestmark = pytest.mark.cuda
N_CARDS = 4


@pytest.fixture(scope="module")
def ranks():
    """The unsharded runs on the first card and each rank's results."""
    torch_cases.card(N_CARDS)
    from tfpose_tpu_torch.cli.train import synthetic_batches
    from tfpose_tpu_torch.parallel.mesh import launch, make_mesh

    torch.backends.cudnn.allow_tf32 = False
    items, _ = rendered_coco(16, 432, 368, seed=11)
    imgs = [img for _, img, _ in items]
    batches = [next(synthetic_batches(16, (368, 368),
                                      np.random.default_rng(12)))]
    want = dict(humans=evaluate_on(None, items, device="cuda:0")[0],
                train=train_steps(batches, device="cuda:0"),
                maps=sharded_forward(make_mesh(1, 1, ["cuda:0"]), imgs)()
                .cpu().numpy())
    devices = [f"cuda:{i}" for i in range(N_CARDS)]
    return want, launch(rank_cards, N_CARDS, devices, "nccl", items, imgs,
                        batches, devices, timeout=120)


def test_train_step_on_2x2_cards(ranks):
    """Loss rtol 1e-5, BN statistics rtol 1e-5 (atol 1e-7), parameters
    atol 2.1e-4, gradients (Adam's first moment) within 0.15 of the
    largest; the four states equal bit for bit (checked in the ranks)."""
    want, got = ranks
    loss, ref = want["train"]
    assert abs(got[0]["losses"][0] - loss[0]) <= 1e-5 * loss[0]
    params, bn, mu = state_diff(got[0]["state"], ref)
    assert params <= 2.1e-4 and bn <= 1 and mu <= 0.15


@pytest.mark.parametrize("grid", ["4x1", "2x2"])
def test_evaluator_on_the_cards(ranks, grid):
    """Every rank's humans the unsharded evaluator's (parts exact, coords
    1e-6, scores 1e-4), through K1 and K3."""
    want, got = ranks
    for r, out in enumerate(got):
        counts = out[f"launches_{grid}"]
        assert counts["smooth_nms_topk_raw"] > 0, counts
        assert counts["score_candidates_raw"] > 0, counts
        for g, w in zip(out[f"humans_{grid}"], want["humans"]):
            for i, (gh, wh) in enumerate(zip(g, w)):
                same_humans(gh, wh, f"rank {r} {grid} image {i}")


def test_rows_sharded_forward_on_1x4_cards(ranks):
    """The thin368_coco forward of the 16 scenes with rows over four
    cards, gathered on every rank: within atol 1e-4 of the unsharded
    forward."""
    want, got = ranks
    for out in got:
        assert np.abs(out["maps"] - want["maps"]).max() <= 1e-4
