"""K3 (``csrc/paf_score.cu``, ``score_candidates_kernel``): the least
time of the candidate scoring that the traced images need (counted from
the reference's peaks of the same scenes over the cell's skeleton: the
peaks, 5 B per candidate slot, each raw PAF cell a live candidate
samples) over the kernel's device time. Nothing to read where the
images hold no peaks."""

from posebench.lib import counts
from posebench.metrics import _common

UNIT = "%"


def read(ctx):
    t, cell = ctx["trace"], ctx["cell"]
    if t is None or not ctx["peaks"]:
        return None
    bound, live = 0.0, False
    for scenes in ctx["traced_scenes"]:
        for s in scenes:
            peaks, valid = ctx["peaks"][s]
            live = live or bool(valid.any())
            bound += _common.fp32_bound(*counts.k3_work(
                peaks, valid, cell.h // 8, cell.w // 8, cell.up_h,
                cell.up_w, cell.skeleton.pairs))
    if not live:
        return None
    return _common.roofline_pct(ctx, ("score_candidates_kernel",), bound)
