"""Profiling and timing helpers — port of ``tfpose_tpu/utils/profiling.py``
on ``torch.profiler`` (CUPTI) and CUDA events.

* :func:`trace` records the enclosed block and writes a chrome trace
  (``*.pt.trace.json``) under ``log_dir``;
* :class:`StageTimer` accumulates host wall time per named section;
* :func:`device_event_durations_ms` reads the device events (CUDA
  kernels, copies, memsets) of the newest trace in ``log_dir``, grouped
  by name;
* :func:`device_p50_ms` is the median device-busy time of one call,
  from a trace (:func:`call_device_events` gives each traced call's
  device events, :func:`call_event_durations_ms` their durations by
  name); :func:`amortized_ms` the per-call time of a loop, timed
  with CUDA events as the slope between N and N // 4 calls;
* :func:`card_name_and_power` names the card a measurement ran on;
* :func:`span` marks a layer of the program's call path in a trace.

The device measurements need a CUDA card and raise without one: a CPU
tensor has no device lane, and no number from the CPU stands in for a
device's. ``start_server`` (JAX's live profiler service) has no PyTorch
counterpart and raises.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# chrome-trace categories of the events that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def card_name_and_power(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` reports them (e.g. "NVIDIA
    H100 80GB HBM3, 700.00 W"), to write beside every time taken on it;
    ``"cpu"`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=10, check=True)
    return out.stdout.strip().splitlines()[0]


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("<layer>.<stage>"):`` around one layer of the call path
    (``model.forward``, ``decode.greedy``, ...). While a profiler records
    (:func:`trace`, ``torch.profiler.profile``) the block is a
    ``record_function`` range, in the same trace as the device events
    and on the same clock, so that the device's idle time can be put
    down to the layer the host was in; otherwise it is a no-op, since a
    ``record_function`` costs ~9-13 us even with no profiler running and
    the check ~0.1-0.15 us (an H100 machine's host CPU). A span adds no
    kernel, sync or allocation; the number of times it opens counts its
    occurrences."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block with ``torch.profiler`` (host ops, and
    CUDA kernels where a card is present) and write it as a chrome trace
    ``<host>.<pid>.<ns>.pt.trace.json`` under ``log_dir`` (Perfetto and
    ``chrome://tracing`` open it): ``with trace(d): est.inference(img)``.
    """
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}."
                 f"{time.time_ns()}.pt.trace.json"))


def start_server(port: int = 9999):
    """Not ported: PyTorch has no live profiler service (TensorBoard's
    profile tab connects to JAX's) short of the separate ``dynolog``
    daemon, which the port does not ship. Use :func:`trace`."""
    raise NotImplementedError(
        "start_server: PyTorch has no live profiler service without the "
        "dynolog daemon; record with tfpose_tpu_torch.utils.profiling."
        "trace(log_dir) instead")


class StageTimer:
    """Accumulating wall-clock stage timer. Device work is asynchronous:
    end a section with a synchronising call (``.cpu()`` of a result, or
    ``torch.cuda.synchronize()``) to time it."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:30s} {total*1e3:10.2f} ms total "
                         f"{total/n*1e3:8.3f} ms/call x{n}")
        return "\n".join(lines)


def _newest_trace(log_dir: str) -> dict:
    paths = [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pattern),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _device_events(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES]


def device_event_durations_ms(log_dir: str,
                              prefix: Optional[str] = None
                              ) -> Dict[str, list]:
    """Durations (ms) of the device events in the newest trace under
    ``log_dir``, grouped by name: on a card each CUDA kernel (e.g.
    ``smooth_nms_kernel``, cuDNN's convolutions), copy and memset. These
    are device timestamps, not host ones. ``prefix`` keeps the names
    that start with it; the default ``None`` keeps every event (JAX's
    default, ``"jit_"``, names XLA programs, which PyTorch does not
    have)."""
    out: Dict[str, list] = {}
    for e in _device_events(_newest_trace(log_dir)["traceEvents"]):
        name = e["name"]
        if prefix is None or name.startswith(prefix):
            out.setdefault(name, []).append(e["dur"] / 1e3)
    return out


def _require_cuda(args) -> None:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not torch.cuda.is_available() or not tensors or not all(
            a.is_cuda for a in tensors):
        raise ValueError("device timing needs CUDA tensors on a card: a "
                         "CPU tensor has no device lane")


# A trace that holds fewer than half the calls is taken again, this many
# times in all. In a process that has traced many times, the device lane
# of a new trace starts late (on an H100: the first 5.7 ms of records
# missing after ~500 s and hundreds of traces), so each trace first runs
# the call outside the ranges for WARMUP_S, doubled at each new attempt.
TRACE_ATTEMPTS = 8
WARMUP_S = 0.1


def device_p50_ms(fn, args, n_runs: int = 30, log_dir: str = "") -> float:
    """Median device time (ms) of one call of ``fn(*args)``: each call
    is traced between synchronisations, and its time is how long the
    device was busy with its events (the union of their intervals, so
    streams that overlap count once), as an XLA program's device
    duration is in JAX's version; the host's gaps between launches do
    not count, and neither does the profiler's own host cost. The median
    is over the calls whose events the trace holds, at least half of
    them (a trace that holds fewer is taken again, up to
    :data:`TRACE_ATTEMPTS` traces; each first calls ``fn`` outside the
    ranges for :data:`WARMUP_S`, doubled at each attempt). ``args`` must
    hold CUDA tensors; ``log_dir`` keeps the trace where given."""
    from torch.profiler import profile, record_function

    _require_cuda(args)
    fn(*args)  # warm-up outside the trace
    torch.cuda.synchronize()
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=_activities()) as prof:
            t_end = time.perf_counter() + WARMUP_S * 2 ** attempt
            while True:  # the device lane's start, outside every range
                fn(*args)
                torch.cuda.synchronize()
                if time.perf_counter() >= t_end:
                    break
            for i in range(n_runs):
                with record_function(f"device_p50_ms#{i}"):
                    fn(*args)
                    torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(log_dir or tmp,
                                f"device_p50.{os.getpid()}.pt.trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            with open(path) as f:
                busy = _call_busy_ms(json.load(f)["traceEvents"])
        if 2 * len(busy) >= n_runs:
            return float(np.percentile(busy, 50))
        time.sleep(0.5)
    raise RuntimeError(f"device events of only {len(busy)} of {n_runs} "
                       f"calls in each of {TRACE_ATTEMPTS} traces")


def call_ranges(events, prefix: str = "device_p50_ms#") -> list:
    """The (start, end) host times of a trace's ``<prefix>i`` ranges
    (``device_p50_ms#i`` by default), in order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(prefix))


def call_device_events(events, prefix: str = "device_p50_ms#") -> list:
    """The device events of each ``<prefix>i`` range of a trace
    (``device_p50_ms#i`` by default), in the ranges' order: those whose
    correlation id is that of a runtime call made within the range. The
    device's timestamps are converted to the host's clock, and the two
    drift apart over a long process (a short call's kernels need not lie
    within its range after minutes), so the runtime call, on the host's
    clock, names the range."""
    ranges = call_ranges(events, prefix)
    starts = [lo for lo, _ in ranges]
    owner = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if (corr is None or e.get("ph") != "X"
                or e.get("cat") in DEVICE_CATEGORIES):
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0 and e["ts"] <= ranges[i][1]:
            owner[corr] = i
    out = [[] for _ in ranges]
    for e in _device_events(events):
        i = owner.get(e.get("args", {}).get("correlation"))
        if i is not None:
            out[i].append(e)
    return out


def call_event_durations_ms(log_dir: str) -> Tuple[Dict[str, list], int]:
    """The device events of the traced calls of ``device_p50_ms`` (its
    ``device_p50_ms#i`` ranges) in the newest trace under ``log_dir``:
    their durations (ms) grouped by name, as
    :func:`device_event_durations_ms` groups a trace's, and the number
    of calls whose events the trace holds. The warm-up calls outside the
    ranges are left out."""
    calls = [c for c in call_device_events(
        _newest_trace(log_dir)["traceEvents"]) if c]
    out: Dict[str, list] = {}
    for e in (e for c in calls for e in c):
        out.setdefault(e["name"], []).append(e["dur"] / 1e3)
    return out, len(calls)


def _call_busy_ms(events) -> list:
    """Device-busy time (ms) of each ``device_p50_ms#i`` range of a trace
    whose device events it holds (:func:`call_device_events`): the union
    of their intervals."""
    busy = []
    for dev in call_device_events(events):
        if not dev:
            continue
        total, end = 0.0, float("-inf")
        for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
            total += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
        busy.append(total / 1e3)
    return busy


def amortized_ms(body, xs, n_rep: int = 3,
                 differential: bool = True) -> float:
    """Per-iteration time (ms) of ``body`` over the leading axis of
    ``xs`` (a CUDA tensor), its results summed as JAX's scan carries
    them, timed with CUDA events, best of ``n_rep``. ``differential``
    returns the slope between N and N // 4 iterations, which cancels
    the fixed cost of a run, as JAX's does."""
    _require_cuda([xs])
    n_iter = int(xs.shape[0])

    def timed(arr):
        def run():
            acc = torch.zeros((), device=arr.device)
            for x in arr:
                acc = acc + body(x)
            return acc

        run()  # warm-up
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(n_rep):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    t_full = timed(xs)
    if not differential or n_iter < 8:
        return t_full / n_iter
    n_small = n_iter // 4
    t_small = timed(xs[:n_small])
    return (t_full - t_small) / (n_iter - n_small)
