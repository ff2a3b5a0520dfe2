"""Arithmetic that several metric readers share. ``ctx`` holds the
cell (``cell``), the entry's outcome (``outcome``), rank 0's trace
counts (``trace``, None in a run without ``--trace 1``), the pool
indices of rank 0's images in each traced call (``traced_scenes``) and
the reference's peaks of those scenes (``peaks``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from posebench.lib import counts
from posebench.lib.trace import WARM_CALLS, kernel_seconds


def percentile_ms(ctx, q: float) -> Optional[float]:
    lat = ctx["outcome"]["latencies_s"]
    return float(np.percentile(lat, q)) * 1e3 if lat else None


def traced_images(ctx) -> int:
    return ctx["trace"]["calls"] * ctx["outcome"]["local_batch"]


def device_idle_pct(ctx) -> Optional[float]:
    t = ctx["trace"]
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(ctx) -> Optional[float]:
    """Model FLOPs of the images of the window's untraced calls over
    those calls' time on the host clock (rank 0's on a mesh, whose calls
    each carry the global batch), as a share of the cards' peak for the
    configuration's ``peak`` (its dtype by default). The profiler slows
    the calls it traces, so they are left out."""
    if ctx["trace"] is None:
        return None
    cell = ctx["cell"]
    lat = ctx["outcome"]["latencies_s"][
        WARM_CALLS + cell.workload["trace_calls"]:]
    if not lat:
        return None
    flops = counts.model_flops(cell.config["model"], cell.h, cell.w)
    rate = flops * cell.batch * len(lat) / sum(lat)
    peak = counts.PEAK_FLOPS[cell.config.get("peak", cell.config["dtype"])]
    return 100.0 * rate / (peak * cell.workload["chips"])


def per_image(ctx, key: str) -> Optional[float]:
    t = ctx["trace"]
    if t is None:
        return None
    return t[key] / traced_images(ctx)


def roofline_pct(ctx, symbols, bound_s: float) -> Optional[float]:
    """The least time of the traced calls' work over the device time of
    the kernels named ``symbols``, as a share."""
    t = ctx["trace"]
    if t is None:
        return None
    spent = sum(kernel_seconds(t, s) for s in symbols)
    if spent <= 0:
        return None
    return 100.0 * bound_s / spent


def fp32_bound(ops: float, nbytes: float) -> float:
    return counts.bound_s(ops, nbytes, counts.PEAK_FLOPS["float32"])
