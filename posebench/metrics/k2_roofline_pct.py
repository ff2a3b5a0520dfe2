"""K2 (``csrc/smooth_nms.cu``, ``smooth_nms_kernel``): the least time
of its traced launches (the upsampled heat map, the skeleton's heat
channels, read once and written once, or its blur and NMS operations at
the fp32 peak, whichever is longer) over their device time."""

from posebench.lib import counts
from posebench.metrics import _common

UNIT = "%"


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    if t is None:
        return None
    work = counts.k2_work(cell.up_h, cell.up_w,
                          cell.skeleton.heat_channels)
    bound = t["calls"] * _common.fp32_bound(*work)
    return _common.roofline_pct(ctx, ("smooth_nms_kernel",), bound)
