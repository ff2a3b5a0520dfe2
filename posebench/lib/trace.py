"""The traced run: a bounded ``torch.profiler`` trace of a few calls of
the measured window, and the arithmetic that turns it into counts.

The arithmetic is a copy of the program's (``utils/profiling.py``:
device events matched to a call by the correlation id of the runtime
call that launched them; ``profiles/stages.py``: kernels and host syncs
per call), frozen here so that the yardstick does not move with the
program. The trace holds the first ``WARM_CALLS + trace_calls`` calls of
the window: the first ``WARM_CALLS`` outside any range (CUPTI's device
lane can start late in a trace), then one ``posebench#i`` range per
call. Its window is from the first range's start to the last one's end.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls that wait for the card, and copies to the host that block
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")
BLOCKING_COPIES = ("cudaMemcpy", "cudaMemcpy2D")
RANGE = "posebench#"
WARM_CALLS = 2
TOP = 10


class Tracer:
    """Wraps the window's calls: :meth:`start` before the window (the
    profiler's start-up takes seconds), then ``with tracer.call(i):``
    around each call. Without ``enabled`` it does nothing."""

    def __init__(self, enabled: bool, n_calls: int):
        self.enabled, self.n_calls = enabled, n_calls
        self.prof = None
        self.summary: Optional[Dict] = None
        self.traced_calls: List[int] = []

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    @contextlib.contextmanager
    def call(self, i: int):
        if self.prof is None:
            yield
            return
        from torch.profiler import record_function

        if i < WARM_CALLS:
            yield
        else:
            with record_function(f"{RANGE}{i}"):
                yield
            self.traced_calls.append(i)
        if i == WARM_CALLS + self.n_calls - 1:
            self.close()

    def close(self) -> None:
        """Stop the trace (after its last call, or where the window ended
        first) and count what it holds."""
        if self.prof is None:
            return
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        if self.traced_calls:
            self.summary = summarize(_events(self.prof))
        self.prof = None


def _events(prof) -> List[dict]:
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _ranges(events) -> List[tuple]:
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(RANGE))


def _union(intervals) -> List[list]:
    merged: List[list] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def summarize(events: List[dict]) -> Dict:
    """Counts of the ranged calls of a trace: the window (s), the union
    of their device events (s), kernels, host syncs, device seconds by
    kernel name, and the device's idle time in the window by what the
    host was doing (the innermost host op at the gap's middle)."""
    ranges = _ranges(events)
    if not ranges:
        raise RuntimeError("the trace holds no posebench ranges")
    starts = [lo for lo, _ in ranges]

    def in_range(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= ranges[i][1]

    owned = set()
    syncs = 0
    dtoh = {e["args"]["correlation"] for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
            and "correlation" in e.get("args", {})}
    host_ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") in DEVICE_CATEGORIES:
            continue
        if e.get("cat") == "cpu_op":
            host_ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        corr = e.get("args", {}).get("correlation")
        if corr is not None and in_range(e["ts"]):
            owned.add(corr)
        if e.get("cat") == "cuda_runtime" and in_range(e["ts"]) and (
                e["name"] in SYNC_CALLS
                or (e["name"] in BLOCKING_COPIES
                    and e.get("args", {}).get("correlation") in dtoh)):
            syncs += 1
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATEGORIES
           and e.get("args", {}).get("correlation") in owned]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    lo, hi = ranges[0][0], ranges[-1][1]
    gaps, prev = [], lo
    for t0, t1 in busy + [[hi, hi]]:
        if t0 > prev:
            gaps.append((prev, min(t0, hi)))
        prev = max(prev, t1)
    host_ops.sort()
    op_starts = [s for s, _, _ in host_ops]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        label, best = "host: python, outside any op", None
        j = bisect.bisect_right(op_starts, mid)
        for s, e, name in host_ops[max(0, j - 400):j]:
            if s <= mid <= e and (best is None or e - s < best):
                label, best = "host: " + name, e - s
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(t1 - t0 for t0, t1 in busy) / 1e6,
        "calls": len(ranges),
        "kernels": sum(1 for e in dev if e.get("cat") == "kernel"),
        "syncs": syncs,
        "by_name": by_name,
        "idle_by_host": idle,
    }


def kernel_seconds(summary: Dict, symbol: str) -> float:
    """Device seconds of the kernels whose name holds ``symbol`` as a
    whole identifier (``select_kernel`` but not ``masked_select_kernel``)."""
    pat = re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(symbol)
                     + r"($|[^A-Za-z0-9_])")
    return sum(s for n, s in summary["by_name"].items() if pat.search(n))


def breakdown(summary: Dict) -> Dict:
    """The ``breakdown`` of the result line: the device ops with the most
    time and the longest idle time by host activity, [name, seconds]."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n[:200], s] for n, s in idle[:TOP]]}
