"""CUDA kernels that ran in the traced calls, per image (rank 0's images on
a mesh)."""

from posebench.metrics import _common

UNIT = "launches/image"


def read(ctx):
    return _common.per_image(ctx, "kernels")
