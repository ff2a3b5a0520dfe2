"""95th percentile latency of the window's calls (host clock)."""

from posebench.metrics import _common

UNIT = "ms"


def read(ctx):
    return _common.percentile_ms(ctx, 95)
