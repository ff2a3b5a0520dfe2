"""The work the benchmark divides by: model FLOPs and the hand kernels'
operations and bytes, computed from shapes (and, for the PAF scorer,
from the peaks the reference finds), and the card's peaks. Frozen here
so that a change to the program cannot move the yardstick.

FLOPs of a forward are 2 per multiply-add of every convolution of the
configuration's architecture file (``reference/archs/``), padded taps
included (``torch.utils.flop_counter``'s rule, which the program's
``get_flops`` uses): 10.83 GFLOP for mobilenet_thin at 432x368 and
484.63 GFLOP for CMU at 656x368. The kernels' work follows the cell's
skeleton (``cell.skeleton``): its parts, heat channels and limbs. A
roofline bound is the larger of operations over the peak rate and bytes
over the HBM bandwidth, each input byte read once and each output byte
written once.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from posebench.lib import spec
from posebench.reference import decode, models

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit, by the type the
# tensor cores (or, for float32 with TF32 off, the CUDA cores) compute in
PEAK_FLOPS = {"float32": 67e12, "tfloat32": 494.5e12, "bfloat16": 989e12,
              "float16": 989e12, "float8": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# K1 blurs the integer-upsampled heat as phase convolutions on the raw
# grid: a 25-tap Gaussian at factor 4 is 7 taps per phase on each axis
K1_PHASE_TAPS = {(4, 25): 7}


@functools.lru_cache(maxsize=None)
def model_flops(model: str, h: int, w: int, root: str = spec.ROOT) -> int:
    """FLOPs of one image's forward at h x w (counted on the meta
    device: shapes only)."""
    tree = models.random_tree(model, None, "meta", root)
    macs = []
    models.forward(model, tree, torch.empty(1, h, w, 3, device="meta"),
                   count=macs, root=root)
    return 2 * sum(macs)


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time of a kernel: operations at the peak rate or bytes
    at the HBM bandwidth, whichever is longer."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def k1_work(planes: int, h8: int, w8: int, factor: int = 4,
            kernlen: int = 25, k_top: int = 32) -> Tuple[int, int]:
    """(operations, bytes) of ``smooth_nms_topk_raw`` over ``planes``
    raw h8 x w8 heat planes (the batch times the skeleton's parts): the
    vertical and horizontal phase convolutions (a multiply and an add
    per tap), the 3x3 NMS and the threshold (8 compares a value); it
    reads each raw value and the two phase tables once and writes K
    (score, index) pairs a plane."""
    taps = K1_PHASE_TAPS[(factor, kernlen)]
    up_h, up_w = factor * h8, factor * w8
    ops = planes * (up_h * (w8 + taps - 1) * 2 * taps
                    + up_h * up_w * 2 * taps + up_h * up_w * 8)
    nbytes = (planes * h8 * w8 * 4 + 2 * factor * taps * 4
              + planes * k_top * 8)
    return ops, nbytes


def k2_work(up_h: int, up_w: int, channels: Optional[int] = None,
            kernlen: int = 25) -> Tuple[int, int]:
    """(operations, bytes) of ``smooth_nms`` on an up_h x up_w x C map,
    C the skeleton's heat channels (COCO-18's 19 by default): a
    separable blur (two passes of a multiply and an add per tap) and the
    3x3 NMS per value; the map is read once and written once."""
    if channels is None:
        channels = decode.skeleton().heat_channels
    n = up_h * up_w * channels
    return n * (2 * (2 * kernlen - 1) + 9), 2 * n * 4


def k3_work(peaks: np.ndarray, valid: np.ndarray, h8: int, w8: int,
            up_h: int, up_w: int, pairs: np.ndarray,
            step: int = 10) -> Tuple[int, int]:
    """(operations, bytes) that ``score_candidates_raw`` needs for one
    image: ``peaks`` (parts, K, 2) integer (x, y) at the decode size,
    ``valid`` (parts, K) and the skeleton's ``pairs`` (limbs, 2). Bytes:
    the peaks (x, y, valid: 9 B a slot), 5 B of result per candidate
    slot, and each raw PAF cell (both channels of its pair, 8 B) that a
    candidate with two valid endpoints samples, once. Operations: 16 per
    candidate (geometry, criteria) and 13 per sample of a live one."""
    k = peaks.shape[1]
    cells, live = set(), 0
    fy, fx = up_h // h8, up_w // w8
    t = np.arange(step, dtype=np.float64) / step
    for pid, (pa, pb) in enumerate(pairs):
        for ia in np.nonzero(valid[pa])[0]:
            ax, ay = peaks[pa, ia]
            for ib in np.nonzero(valid[pb])[0]:
                bx, by = peaks[pb, ib]
                live += 1
                sx = np.clip(np.floor(ax + (bx - ax) * t + 0.5), 0, up_w - 1)
                sy = np.clip(np.floor(ay + (by - ay) * t + 0.5), 0, up_h - 1)
                for cy, cx in zip((sy // fy).astype(int),
                                  (sx // fx).astype(int)):
                    cells.add((pid, cy, cx))
    n = len(pairs) * k * k
    return (16 * n + (13 * step + 1) * live,
            len(cells) * 8 + peaks.shape[0] * k * 9 + n * 5)
