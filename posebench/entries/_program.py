"""What the single-process entries share: building the program's
estimator with the configuration's weights, the hook that keeps the maps
each call's forward produced, and the closed loop around one kind of
call."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import torch

from posebench.lib import weights
from posebench.lib.cell import humans_px, window
from posebench.lib.trace import Tracer


def estimator(cell):
    """The program's ``TfPoseEstimator`` for the cell's configuration, on
    the cell's device: a checkpoint through its own loader, or the
    seeded weights copied into its network; the configuration's
    ``program`` keys are passed on as keyword arguments."""
    from tfpose_tpu_torch.estimator import TfPoseEstimator

    cfg = cell.config
    path = cell.weights_path()
    est = TfPoseEstimator(
        cfg["model"], target_size=(cell.w, cell.h), dtype=cfg["dtype"],
        params_path=path or os.path.join(cell.root, "no-checkpoint"),
        device=cell.device, **cfg.get("program", {}))
    if path is None:
        weights.load_into(est.net, weights.seeded_tree(
            cfg["model"], cell.seed, est.device, cell.root), cfg["model"],
            cell.root)
    return est


class MapsHook:
    """Keeps the stride-8 maps of the network's latest forward."""

    def __init__(self, net: torch.nn.Module):
        self.maps = None
        net.register_forward_hook(self._hook)

    def _hook(self, module, args, out: Dict):
        self.maps = out["concat_stage7"]


def closed_loop(cell) -> None:
    """Refuses a workload whose ``loop`` is not the closed loop that
    this package's entries run (each entry checks its own keys)."""
    loop = cell.workload.get("loop")
    if loop != "closed":
        raise ValueError(f"workload {cell.workload['name']}: entry "
                         f"{cell.workload['entry']} drives a closed loop, "
                         f"not {loop!r}")


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def drive(cell, call: Callable[[object, List], List]) -> Dict:
    """Set up the estimator, warm up the cell's shapes, run the window of
    ``call(est, images) -> one Human list per image`` over the pool, and
    return the outcome with the kept calls' maps and humans."""
    cell.render()
    est = estimator(cell)
    hook = MapsHook(est.net)
    for i in range(cell.workload["warmup_calls"]):
        call(est, [cell.pool[s] for s in cell.scenes_of(i)])
    synchronize(cell.device)
    keeper = cell.keeper()
    tracer = Tracer(cell.trace, cell.workload["trace_calls"])

    def step(i):
        scenes = cell.scenes_of(i)
        humans = call(est, [cell.pool[s] for s in scenes])
        keeper.offer(i, (scenes, hook.maps, humans))

    setup_end = time.time()
    res = window(cell, step, tracer)
    res["memory_peak_bytes"] = memory_peak(cell.device)
    kept = [{"scenes": scenes, "maps": maps.float().cpu().numpy(),
             "humans": [humans_px(h, cell.up_w, cell.up_h) for h in humans]}
            for scenes, maps, humans in keeper.kept()]
    del est, hook, keeper
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    n = res["calls"] * cell.batch
    res.update(setup_s=setup_end - cell.t_start, kept=kept, images=n,
               attempted=n, failed=0,
               traces=[tracer.summary] if tracer.summary else [],
               traced_calls=tracer.traced_calls, local_batch=cell.batch)
    return res
