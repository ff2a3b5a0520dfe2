"""One run of one cell: set-up, the measured window, the check, the
metrics.

An entry (``entries/<entry>.py``) drives the program: it builds it,
warms up the cell's shapes, runs the closed loop of :func:`window` for
``--seconds`` and returns an outcome (the calls' latencies, the images
done, the set-up time, the device's peak memory, the maps and humans of
the calls kept for the check, the trace's counts). This module then
works out the reference for the kept images (``check.py``), reads each
metric of the cell (``metrics/<name>.py``) and assembles the result.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from posebench.lib import scenes, spec
from posebench.lib.trace import Tracer


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


class Cell:
    """A workload, its configuration and this run's arguments."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda",
                 root: str = spec.ROOT, t_start: Optional[float] = None):
        self.workload = spec.workload(workload, root)
        self.config = spec.config(self.workload["config"], root)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.root = device, root
        self.t_start = process_start_wall() if t_start is None else t_start
        w, h = self.config["input_wh"]
        self.w, self.h = w, h
        self.up_h = int(h / 8 * self.config["upsample"])
        self.up_w = int(w / 8 * self.config["upsample"])
        self.batch = self.workload["batch"]
        self.pool: List[np.ndarray] = []

    def render(self) -> None:
        """The scene pool, drawn from the seed (part of set-up)."""
        self.pool = scenes.scene_pool(self.seed, self.workload["scenes"],
                                      self.w, self.h,
                                      tuple(self.workload["people"]))

    def scenes_of(self, call: int) -> List[int]:
        """The pool indices of one call's images: the pool, cycled."""
        n = len(self.pool)
        return [(call * self.batch + j) % n for j in range(self.batch)]

    def weights_path(self) -> Optional[str]:
        w = self.config["weights"]
        return None if w == "seeded" else os.path.join(
            os.path.dirname(self.root), w)

    def keeper(self) -> "Keeper":
        """Which calls keep their maps and humans for the check: enough
        calls for ``check_images`` images, drawn from the seed over the
        whole window."""
        return Keeper(self.seed, -(-self.workload["check_images"]
                                   // self.batch))


class Keeper:
    """``k`` of the window's calls, each alike likely, drawn from the
    seed as the calls come (reservoir sampling): at most ``k`` calls'
    outputs are held at any time, however long the window."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([seed, 1])
        self.k = k
        self.slots: List[tuple] = []

    def offer(self, call: int, item) -> None:
        if len(self.slots) < self.k:
            self.slots.append((call, item))
            return
        j = int(self.rng.integers(call + 1))
        if j < self.k:
            self.slots[j] = (call, item)

    def kept(self) -> list:
        """The kept items, in the order of their calls."""
        return [item for _, item in sorted(self.slots, key=lambda c: c[0])]


def window(cell: Cell, step: Callable[[int], None],
           tracer: Tracer) -> Dict:
    """The closed loop: ``step(i)`` for i = 0, 1, ... until ``seconds``
    have passed; each call's latency on the host clock. Returns the
    latencies (s), the calls and the window's length (s)."""
    lat: List[float] = []
    tracer.start()
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    i = 0
    while True:
        t = time.perf_counter()
        if t >= end:
            break
        with tracer.call(i):
            step(i)
        lat.append(time.perf_counter() - t)
        i += 1
    window_s = time.perf_counter() - t0
    tracer.close()
    return {"latencies_s": lat, "calls": i, "window_s": window_s}


def humans_px(humans, up_w: int, up_h: int):
    """The program's ``Human`` list -> ``[({part: (x, y, score)}, score),
    ...]`` at the decode size (its coordinates are normalized by it)."""
    out = []
    for hu in humans:
        parts = {p: (int(round(bp.x * up_w)), int(round(bp.y * up_h)),
                     float(bp.score)) for p, bp in hu.body_parts.items()}
        out.append((parts, float(hu.score)))
    return out
