"""Where the card waits, by layer: a traced run of the estimator's calls,
with the device's idle time put down to the program's spans
(``utils/profiling.span``: ``api.*``, ``model.*``, ``decode.*``,
``mesh.*``).

``calls`` calls of ``TfPoseEstimator.inference`` (``--batch 1``) or
``inference_batch`` (a larger batch) on rendered scenes
(``evaluation/backbone_sweep.make_scenes``), decoded at 4x, run in one
``torch.profiler`` trace, each in a ``spans#i`` range, after
:data:`WARM_CALLS` calls outside the ranges (CUPTI's device lane can
start late in a trace). The window runs from the first range's start to
the last one's end; the device is busy in the union of the device events
launched in the ranges (matched by correlation id,
``call_device_events``), idle in the rest. Each idle interval goes to
the innermost span the host was in, by exact overlap (:data:`NONE`
outside every span), so the shares add up to the window's idle share.
Per span that opened or held idle time: its idle share of the window,
how often it opened a call (``model.replay`` once a call where the
backbone's CUDA graph replays), and the device ms a call of the work
launched inside it.

    tfpose-torch-profile spans [--model mobilenet_thin] [--resize 432x368]
        [--batch 1] [--dtype float32] [--params PATH] [--calls 10] [--json]

Under the profiler a call takes longer than without it, so the idle
shares read high. Every number needs the card: on the CPU it raises.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

from tfpose_tpu_torch.cli.common import add_device_flag, network_size
from tfpose_tpu_torch.utils.profiling import (
    _activities,
    call_device_events,
    call_ranges,
    card_name_and_power,
)

RANGE = "spans#"
WARM_CALLS = 2
NONE = "(none)"
LAYERS = ("model", "decode", "api", "mesh")
# the decode's size over the stride-8 maps (the reference's
# --resize-out-ratio 4.0, as every benchmark cell runs it)
UPSAMPLE = 4.0
PROGRAM_SPAN = re.compile(r"^[a-z]+\.[a-z_]+$")
# the host events that launch device work
LAUNCHERS = ("cuda_runtime", "cuda_driver")


def record(call: Callable[[int], object], n_calls: int) -> List[dict]:
    """The chrome-trace events of ``call(i)`` for ``i`` below
    ``WARM_CALLS + n_calls``, the last ``n_calls`` each in a ``spans#i``
    range ending after a synchronisation."""
    from torch.profiler import profile, record_function

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    with profile(activities=_activities()) as prof:
        for i in range(WARM_CALLS + n_calls):
            if i < WARM_CALLS:
                call(i)
                continue
            with record_function(f"{RANGE}{i}"):
                call(i)
                sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spans.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _pieces(spans: List[Tuple[float, float, str]], lo: float, hi: float
            ) -> List[Tuple[float, float, str]]:
    """[lo, hi] cut into (start, end, name) pieces, each under the
    innermost span covering it (the one opened last), or :data:`NONE`."""
    cuts = sorted({lo, hi} | {t for s, e, _ in spans for t in (s, e)
                              if lo < t < hi})
    order, active, j, out = sorted(spans), [], 0, []
    for a, b in zip(cuts, cuts[1:]):
        while j < len(order) and order[j][0] <= a:
            active.append(order[j])
            j += 1
        active = [s for s in active if s[1] > a]
        out.append((a, b, max(active, key=lambda s: (s[0], -s[1]))[2]
                    if active else NONE))
    return out


def idle_by_span(events: List[dict]) -> Dict:
    """The window of a trace's ``spans#i`` ranges (s), its busy time (the
    union of the ranges' device events, s), the number of ranges, and by
    program span: ``idle_s``, the window's idle seconds under it (exact
    overlaps; they sum to the idle time); ``count``, how often it opened
    within the ranges; ``device_s``, the device seconds of the events
    launched while it was the innermost span."""
    ranges = call_ranges(events, RANGE)
    if not ranges:
        raise ValueError(f"the trace holds no {RANGE} ranges")
    lo, hi = ranges[0][0], ranges[-1][1]
    dev = [e for c in call_device_events(events, RANGE) for e in c]
    busy: List[list] = []
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        if busy and t0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t1)
        else:
            busy.append([t0, t1])
    gaps, prev = [], lo
    for t0, t1 in busy + [[hi, hi]]:
        if t0 > prev:
            gaps.append((prev, min(t0, hi)))
        prev = max(prev, t1)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and PROGRAM_SPAN.match(str(e.get("name", "")))
             and lo <= e["ts"] <= hi]
    pieces = _pieces(spans, lo, hi)
    idle: Dict[str, float] = {}
    for a, b, name in pieces:
        for g0, g1 in gaps[max(0, bisect.bisect_left(gaps, (a,)) - 1):]:
            if g0 >= b:
                break
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0:
                idle[name] = idle.get(name, 0.0) + overlap / 1e6
    count: Dict[str, int] = {}
    for _, _, name in spans:
        count[name] = count.get(name, 0) + 1
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") in LAUNCHERS
              and "correlation" in e.get("args", {})}
    starts = [a for a, _, _ in pieces]
    device: Dict[str, float] = {}
    for e in dev:
        ts = launch.get(e["args"]["correlation"])
        k = -1 if ts is None else bisect.bisect_right(starts, ts) - 1
        name = pieces[k][2] if k >= 0 and ts <= pieces[k][1] else NONE
        device[name] = device.get(name, 0.0) + e["dur"] / 1e6
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(t1 - t0 for t0, t1 in busy) / 1e6,
            "calls": len(ranges), "idle_s": idle, "count": count,
            "device_s": device}


def layer_shares(doc: Dict) -> Dict[str, float]:
    """The window's idle share (%) under each layer's spans (the
    ``<layer>.`` prefix) and under :data:`NONE`, and ``device_idle`` in
    all: the parts add up to it."""
    pct = {layer: 0.0 for layer in LAYERS}
    pct[NONE] = 0.0
    for name, s in doc["idle_s"].items():
        key = name if name == NONE else name.split(".")[0]
        pct[key] = pct.get(key, 0.0) + 100.0 * s / doc["window_s"]
    pct["device_idle"] = 100.0 * (1 - doc["busy_s"] / doc["window_s"])
    return pct


def profile_spans(model: str = "mobilenet_thin", w: int = 432,
                  h: int = 368, batch: int = 1, dtype: str = "float32",
                  params_path: str = "", n_calls: int = 10,
                  device=None) -> Dict:
    """:func:`idle_by_span` of ``n_calls`` estimator calls at ``batch``
    on the card, with :func:`layer_shares` and each span's idle share,
    count and device ms a call. ``params_path`` '' uses the model's
    default checkpoint, or the seeded weights where there is none."""
    from tfpose_tpu_torch.estimator import TfPoseEstimator
    from tfpose_tpu_torch.evaluation.backbone_sweep import make_scenes

    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("the idle split needs a CUDA card: a CPU run has "
                         "no device lane")
    est = TfPoseEstimator(model, target_size=(w, h), dtype=dtype,
                          params_path=params_path or None, device=device)
    imgs, _ = make_scenes(max(8, 2 * batch), w, h)

    def call(i):
        chosen = [imgs[(i * batch + k) % len(imgs)] for k in range(batch)]
        if batch == 1:
            return est.inference(chosen[0], upsample_size=UPSAMPLE)
        return est.inference_batch(chosen, upsample_size=UPSAMPLE)

    for i in range(3):  # every shape built outside the trace
        call(i)
    torch.cuda.synchronize()
    doc = idle_by_span(record(call, n_calls))
    n = doc["calls"]
    idle = {name: doc["idle_s"].get(name, 0.0)
            for name in {*doc["idle_s"], *doc["count"]}}
    rows = [{"span": name, "idle_pct": 100.0 * s / doc["window_s"],
             "per_call": doc["count"].get(name, 0) / n,
             "device_ms_per_call": 1e3 * doc["device_s"].get(name, 0.0) / n}
            for name, s in sorted(idle.items(),
                                  key=lambda kv: (-kv[1], kv[0]))]
    return {"model": model, "size": f"{w}x{h}", "batch": batch,
            "dtype": dtype, "calls": n,
            "call_ms": 1e3 * doc["window_s"] / n,
            "busy_ms_per_call": 1e3 * doc["busy_s"] / n,
            "layers": layer_shares(doc), "spans": rows,
            "device": card_name_and_power(device)}


def report(doc: Dict) -> str:
    lay = doc["layers"]
    lines = [f"{doc['model']} {doc['size']} {doc['dtype']} B={doc['batch']}"
             f": {doc['calls']} traced calls, {doc['call_ms']:.2f} ms a "
             f"call, {doc['busy_ms_per_call']:.2f} ms busy "
             f"[{doc['device']}]",
             "  idle % of the window: " + ", ".join(
                 f"{k} {lay[k]:.2f}" for k in ("device_idle", *LAYERS, NONE))]
    for r in doc["spans"]:
        lines.append(f"  {r['span']:20s} idle {r['idle_pct']:6.2f} %  "
                     f"x{r['per_call']:.2f} a call  device "
                     f"{r['device_ms_per_call']:.3f} ms a call")
    return "\n".join(lines)


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser(
        description="the card's idle time by the program's spans")
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--resize", type=str, default="432x368")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--params", type=str, default="",
                        help="checkpoint (default: the model's own, else "
                             "seeded weights)")
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--json", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    w, h = network_size(args.resize)
    doc = profile_spans(args.model, w, h, args.batch, args.dtype,
                        args.params, args.calls, args.device)
    print(json.dumps(doc) if args.json else report(doc), flush=True)
    return doc
