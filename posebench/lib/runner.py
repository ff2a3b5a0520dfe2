"""One run of one cell, end to end: the entry's window, the check
against the reference, the cell's metrics and the result line."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from posebench.lib import check, spec
from posebench.lib.cell import Cell
from posebench.lib.trace import breakdown
from posebench.reference import decode as ref_decode

FORBIDDEN = ("jax", "jaxlib", "flax", "tfpose_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (``tfpose_tpu_torch`` is not ``tfpose_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(bench: Dict, workload: str, trace: bool) -> List[str]:
    """The metrics ``BENCHMARK.json`` asks of this cell in this run."""
    kind = "per_layer" if trace else "end_to_end"
    return [m["name"] for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def peak_lists(peaks_map: np.ndarray, skeleton: ref_decode.Skeleton,
               k_min: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """(parts, K, 2) integer (x, y) and (parts, K) validity of the peaks
    the decode keeps from a capped peaks map."""
    per = []
    for p in range(skeleton.parts):
        ys, xs = np.nonzero(peaks_map[:, :, p] > ref_decode.PARAMS.thresh_heat)
        per.append(np.stack([xs, ys], 1))
    k = max(k_min, max(len(q) for q in per))
    pts = np.zeros((skeleton.parts, k, 2), np.int64)
    valid = np.zeros((skeleton.parts, k), bool)
    for p, q in enumerate(per):
        pts[p, :len(q)] = q
        valid[p, :len(q)] = True
    return pts, valid


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: str = spec.ROOT,
        t_start: Optional[float] = None
        ) -> Tuple[Dict, List[str], Dict[str, float]]:
    """Run the cell once. Returns the result line's object, the
    comparison's lines (each number beside its limit) and every number
    the comparison worked out."""
    bench = spec.benchmark(root)
    cell = Cell(workload, seed, seconds, trace, device, root, t_start)
    readers = {n: spec.metric_reader(n, root)
               for n in cell_metrics(bench, workload, trace)}
    outcome = spec.entry(cell.workload["entry"], root).run(cell)
    if not cell.pool:
        cell.render()
    dev = torch.device("cuda:0" if torch.device(device).type == "cuda"
                       else device)
    items = check.sample(cell, outcome["kept"])
    local = outcome["local_batch"]
    traced = [cell.scenes_of(i)[:local] for i in outcome["traced_calls"]]
    ref = check.reference_maps(
        cell, [s for s, _, _ in items] + [s for c in traced for s in c], dev)
    low = check.low_precision(cell)
    ref_low = None if low is None else check.reference_maps(
        cell, [s for s, _, _ in items], dev, dtype=low)
    numbers = check.compare(cell, items, ref, dev, ref_low)
    peaks = {}
    for s in {s for c in traced for s in c}:
        pm, _ = ref_decode.post(ref[s], cell.up_h, cell.up_w,
                                skeleton=cell.skeleton)
        peaks[s] = peak_lists(ref_decode.capped_peaks(
            pm.cpu().numpy(), skeleton=cell.skeleton), cell.skeleton)
    limits = cell.config["limits"]
    correct = (bool(items) and outcome["failed"] == 0
               and check.verdict(numbers, limits))
    traces = outcome["traces"]
    ctx = {"cell": cell, "outcome": outcome, "peaks": peaks,
           "trace": traces[0] if traces else None, "traced_scenes": traced}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    if dev.type == "cuda":
        kind = outcome.get("kind") or torch.cuda.get_device_name(dev)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics,
              "device": {"platform": platform, "kind": kind,
                         "count": cell.workload["chips"],
                         "memory_peak_bytes": outcome["memory_peak_bytes"]}}
    if trace and traces:
        result["device"]["busy_s"] = float(np.mean([t["busy_s"]
                                                    for t in traces]))
        result["device"]["window_s"] = float(np.mean([t["window_s"]
                                                      for t in traces]))
        result["breakdown"] = breakdown(traces[0])
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    lines = [f"reading {k} {v!r} (not compared in this cell)"
             for k, v in numbers.items() if k not in limits]
    lines += [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    lines.append(f"check images_compared {len(items)} limit 1 or more")
    return result, lines, numbers
