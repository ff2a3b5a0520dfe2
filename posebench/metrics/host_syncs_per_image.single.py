"""Host waits in the traced calls (stream and event synchronizations,
blocking copies to the host), per image."""

from posebench.metrics import _common

UNIT = "syncs/image"


def read(ctx):
    return _common.per_image(ctx, "syncs")
