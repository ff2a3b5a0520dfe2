"""Peak extraction: max-pool NMS + fixed-K top-k per part channel.

Port of ``tfpose_tpu/ops/nms.py`` (reference in-graph ``tf.nn.pool`` MAX
+ the C++ decoder's row-major peak scan): the peaks plane is reduced to
the top ``max_peaks`` candidates per part, each with (x, y, score,
valid). Ties go to the lower flat index, as ``jax.lax.top_k`` and the
reference scan do; ``torch.topk`` does not promise that order, so the
selection is a stable descending sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Peaks(NamedTuple):
    """Fixed-shape peak set; all tensors are (..., num_parts, K)."""

    x: torch.Tensor       # int32 column
    y: torch.Tensor       # int32 row
    score: torch.Tensor   # float32 (smoothed heatmap value)
    valid: torch.Tensor   # bool


def max3x3(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Window max over the two spatial dims of (..., H, W) with -inf
    outside the plane (SAME padding)."""
    pad = window // 2
    lead = x.shape[:-2]
    y = x.reshape(-1, 1, *x.shape[-2:])
    y = F.max_pool2d(F.pad(y, (pad, pad, pad, pad), value=-float("inf")),
                     window, 1)
    return y.reshape(*lead, *x.shape[-2:])


def nms(x: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Keep local maxima of (..., H, W, C), zero elsewhere (SAME pad)."""
    chw = x.movedim(-1, -3)
    pooled = max3x3(chw, window).movedim(-3, -1)
    return torch.where(x >= pooled, x, torch.zeros_like(x))


def stable_topk(flat: torch.Tensor, k: int):
    """Top-k along the last dim, ties to the lower index."""
    vals, order = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def top_peaks(peaks_map: torch.Tensor, max_peaks: int,
              thresh: float, num_parts: int = 18) -> Peaks:
    """Extract top-K peaks per part from an NMS'd (H, W, heat channels)
    plane; ``num_parts``: the skeleton's parts (COCO-18's by default)."""
    h, w, _ = peaks_map.shape
    flat = peaks_map[:, :, :num_parts].reshape(h * w, num_parts).T
    scores, idx = stable_topk(flat, max_peaks)
    return Peaks(x=(idx % w).int(), y=(idx // w).int(),
                 score=scores.float(), valid=scores > thresh)
