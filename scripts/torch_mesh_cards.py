#!/usr/bin/env python3
"""The port's mesh over NCCL across several cards of one host, against
the unsharded computations on the first card.

    python3 scripts/torch_mesh_cards.py        # needs 4 cards

One process per card (``parallel/mesh.py:launch``, NCCL), four ranks in
three grids over the same four cards, with ``chip_smoke.py``'s helpers:

* (2 x 2): one train step of the seeded mobilenet_thin at 368x368, B=16,
  lr 1e-4, against the unsharded step on the first card: loss rtol
  1e-5, BN statistics rtol 1e-5 (atol 1e-7), parameters atol 2.1e-4,
  gradients (Adam's first moment) within 0.15 of the largest; the four
  states equal bit for bit; then ``BatchedEvaluator`` with ``spatial``;
* (4 x 1): ``BatchedEvaluator`` (thin368_coco, fp32, batch 8) on 16
  rendered 432x368 scenes, every rank's humans against the unsharded
  evaluator's (parts exact, coords 1e-6, scores 1e-4);
* (1 x 4): the thin368_coco forward of the 16 scenes with rows over four
  cards, gathered, against the unsharded forward (atol 1e-4);
* the host times (median ms) of a gradient-sized ``all_reduce``
  (2,213,850 fp32) and of one halo exchange, and the train step's time
  at B=16 per card on (4 x 1) (B=64) against B=16 on one card (after
  warm-up, 5 steps each), beside the cards' name and power limit.

The kernels' launches on each rank's evaluator path are counted. The
last line is one JSON object of the results; the script exits non-zero
if a check fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_CARDS = 4


def step_seconds(mesh, batch, steps: int = 5) -> float:
    """Median seconds of one train step of the seeded thin on ``mesh``
    (or the first card), after two warm-up steps."""
    import torch

    from chip_smoke import seeded_thin
    from tfpose_tpu_torch.parallel.mesh import replicated
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step)

    net = seeded_thin().to(mesh.device if mesh else "cuda:0")
    if mesh is not None:
        replicated(mesh, net)
    state = TrainState.create(net, make_optimizer(1e-4))
    step = make_train_step(mesh=mesh)
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(step(state, batch)[1]["loss"])
        times.append(time.perf_counter() - t)
    return float(sorted(times[2:])[steps // 2])


def rank_cards(items, imgs, batch, big_batch, devices):
    """Every leg on this rank of the four cards."""
    from chip_smoke import (
        counted, evaluate_on, sharded_forward, time_collectives,
        train_steps)
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    grid = make_mesh(2, 2, devices)
    data = make_mesh(4, 1, devices)
    rows = make_mesh(1, 4, devices)
    losses, state = train_steps([batch], grid)
    out = {"losses": losses, "state": state if grid.rank == 0 else None}
    (out["humans_4x1"], _), out["launches_4x1"] = counted(
        lambda: evaluate_on(data, items))
    (out["humans_2x2"], _), out["launches_2x2"] = counted(
        lambda: evaluate_on(grid, items, spatial=True))
    maps = sharded_forward(rows, imgs)()    # every rank takes part
    out["maps"] = maps.cpu().numpy() if rows.rank == 0 else None
    out["times_2x2"] = time_collectives(grid, (8, 24, 184, 184))
    out["times_1x4"] = time_collectives(rows, (16, 24, 184, 216))
    out["step_s_4x1_b64"] = step_seconds(data, big_batch)
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from tfpose_tpu_torch.cli import train as train_cli
    from tfpose_tpu_torch.ops.kernels import build
    from tfpose_tpu_torch.parallel.mesh import launch, make_mesh
    from tfpose_tpu_torch.utils.profiling import card_name_and_power

    if torch.cuda.device_count() < N_CARDS:
        print(f"torch_mesh_cards: needs {N_CARDS} cards, has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = card_name_and_power()
    cs.log(f"{N_CARDS} x {torch.cuda.get_device_name(0)} | {smi} | torch "
           f"{torch.__version__} cuda {torch.version.cuda}")
    cs.log(f"kernels built in {build.build_all():.2f} s")
    dev = torch.device("cuda:0")
    items, _ = cs.rendered_coco(16, 432, 368, seed=11)
    imgs = [img for _, img, _ in items]
    gen = train_cli.synthetic_batches(16, (368, 368),
                                      np.random.default_rng(12))
    batch = next(gen)
    more = [next(gen) for _ in range(3)]
    big = {k: np.concatenate([batch[k]] + [m[k] for m in more])
           for k in batch}

    want_humans, _ = cs.evaluate_on(None, items, device=dev)
    want_loss, want_state = cs.train_steps([batch], device=dev)
    want_maps = cs.sharded_forward(make_mesh(1, 1, [dev]), imgs)()
    want_maps = want_maps.cpu().numpy()
    one_card_s = step_seconds(None, batch)

    t = time.perf_counter()
    devices = [f"cuda:{i}" for i in range(N_CARDS)]
    ranks = launch(rank_cards, N_CARDS, devices, "nccl", items, imgs, batch,
                   big, devices, timeout=120)
    wall = time.perf_counter() - t

    res = {"cards": N_CARDS, "device": torch.cuda.get_device_name(0),
           "smi": smi, "launch_s": wall, "one_card_step_s_b16": one_card_s}
    got = ranks[0]["state"]
    keys = list(want_state)
    par = [k for k in keys if not k.startswith(("mu/", "nu/"))
           and "running" not in k and "num_batches" not in k]
    bn = [k for k in keys if "running" in k]
    mu = [k for k in keys if k.startswith("mu/")]
    top = max(np.abs(want_state[k]).max() for k in mu)
    res["loss_rel"] = abs(ranks[0]["losses"][0] - want_loss[0]) / want_loss[0]
    res["params_max_abs"] = float(max(np.abs(got[k] - want_state[k]).max()
                                      for k in par))
    res["bn_allclose_ratio"] = float(max(
        (np.abs(got[k] - want_state[k])
         / (1e-7 + 1e-5 * np.abs(want_state[k]))).max() for k in bn))
    res["grad_rel_top"] = float(max(np.abs(got[k] - want_state[k]).max()
                                    for k in mu) / top)
    res["maps_max_abs"] = float(np.abs(ranks[0]["maps"] - want_maps).max())
    for key in ("times_2x2", "times_1x4", "launches_4x1", "launches_2x2",
                "step_s_4x1_b64"):
        res[key] = [r[key] for r in ranks]
    ok = (res["loss_rel"] <= 1e-5 and res["params_max_abs"] <= 2.1e-4
          and res["bn_allclose_ratio"] <= 1 and res["grad_rel_top"] <= 0.15
          and res["maps_max_abs"] <= 1e-4)
    for r, out in enumerate(ranks):
        for grid in ("4x1", "2x2"):
            for g, w in zip(out[f"humans_{grid}"], want_humans):
                for i, (gh, wh) in enumerate(zip(g, w)):
                    cs.same_humans(gh, wh, f"rank {r} {grid} image {i}")
            ok = ok and out[f"launches_{grid}"]["smooth_nms_topk_raw"] > 0
            ok = ok and out[f"launches_{grid}"]["score_candidates_raw"] > 0
    res["ok"] = bool(ok)
    cs.log(f"{N_CARDS} cards over NCCL: {json.dumps(res)}")
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
