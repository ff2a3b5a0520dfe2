"""Rank 0's device time in NCCL kernels per global batch (the gathers
of the decoded arrays), from the trace."""

UNIT = "ms"


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    spent = sum(s for n, s in t["by_name"].items() if "nccl" in n.lower())
    if spent <= 0:
        return None
    return 1e3 * spent / t["calls"]
