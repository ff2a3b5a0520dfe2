"""K1 (``csrc/smooth_nms_topk_raw.cu`` with ``peak_select.cuh``:
``phase_peaks_kernel`` and ``select_kernel``): the least time of the
traced calls' raw-grid blur, NMS and top-K over the B x 18 heat planes
(operations at the fp32 peak, or the planes read once, whichever is
longer) over the two kernels' device time."""

from posebench.lib import counts
from posebench.metrics import _common

UNIT = "%"


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    if t is None:
        return None
    planes = ctx["outcome"]["local_batch"] * counts.NUM_PARTS
    work = counts.k1_work(planes, cell.h // 8, cell.w // 8,
                          int(cell.config["upsample"]))
    bound = t["calls"] * _common.fp32_bound(*work)
    return _common.roofline_pct(ctx, ("phase_peaks_kernel", "select_kernel"),
                                bound)
