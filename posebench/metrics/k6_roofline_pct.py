"""K6 (``csrc/bias_prelu.cu``: ``bias_prelu_vec``): the least time of
the traced calls' bias and PReLU passes over the kernel's device time.

The work, worked out here from the configuration's architecture file
(``reference/archs/<model>.py``) and frozen with the benchmark: for each
conv followed by a PReLU (a ``prelu`` leaf), B x h8 x w8 x cout values
read once and written once in the configuration's compute type, plus the
conv's bias and slopes (fp32) read once; about 2 operations a value,
far below the bytes' time. Every such conv of BODY_25 works at stride 8
(conv4_2 onward). A network without PReLU convs, or a program without
the kernel, reads nothing."""

from __future__ import annotations

from typing import Tuple

from posebench.lib import counts, spec
from posebench.metrics import _common

UNIT = "%"
SYMBOLS = ("bias_prelu_vec",)
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def k6_work(model: str, h: int, w: int, batch: int, dtype: str,
            root: str = spec.ROOT) -> Tuple[int, int]:
    """(operations, bytes) of one call's K6 passes: ``model`` at h x w,
    ``batch`` images, activations in ``dtype``."""
    h8, w8 = -(-h // 8), -(-w // 8)
    values = nbytes = 0
    for c in spec.arch(model, root).convs():
        if "prelu" in c.leaves:
            n = batch * h8 * w8 * c.cout
            values += n
            nbytes += 2 * n * DTYPE_BYTES[dtype] + 2 * c.cout * 4
    return 2 * values, nbytes


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    if t is None:
        return None
    ops, nbytes = k6_work(cell.config["model"], cell.h, cell.w,
                          ctx["outcome"]["local_batch"],
                          cell.config["dtype"], cell.root)
    if nbytes == 0:
        return None
    bound = t["calls"] * counts.bound_s(
        ops, nbytes, counts.PEAK_FLOPS[cell.config["dtype"]])
    return _common.roofline_pct(ctx, SYMBOLS, bound)
