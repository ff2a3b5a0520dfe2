"""Model FLOPs (frozen count, lib/counts.py) of the untraced calls' images
over those calls' host time, as a share of the cards' peak for the dtype."""

from posebench.metrics import _common

UNIT = "%"


def read(ctx):
    return _common.mfu_pct(ctx)
