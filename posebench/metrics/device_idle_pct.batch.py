"""Share of the traced window in which no operation ran on the card (rank 0
on a mesh)."""

from posebench.metrics import _common

UNIT = "%"


def read(ctx):
    return _common.device_idle_pct(ctx)
