"""Multi-scale / sliding-window inference.

Port of ``tfpose_tpu/pipeline/multiscale.py``. Images larger than the
network are covered with overlapping network-size windows (0.2 overlap,
origins on the stride-8 grid), all windows of a scale go through the
backbone as one batch, and their stride-8 maps are merged with
distance weights that peak at each window's centre (the reference's
vendored ``slidingwindow`` merge). Multi-scale inference does this at
each scale and averages the maps, area-resampled onto the base grid.
Tensors are (H, W, C), as in the JAX package; everything stays on the
image's device until decode.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from tfpose_tpu_torch.ops.resize import resize_area, resize_bilinear


class WindowGrid(NamedTuple):
    """Static sliding-window geometry (pixel units, stride-1 space)."""

    origins: np.ndarray   # (n_windows, 2) int (y0, x0)
    win_h: int
    win_w: int
    img_h: int
    img_w: int


def generate_windows(img_h: int, img_w: int, win_h: int, win_w: int,
                     overlap: float = 0.2, stride: int = 8) -> WindowGrid:
    """Cover (img_h, img_w) with windows of (win_h, win_w) at >= the
    given fractional overlap (reference generateForSize semantics).
    Window origins snap to multiples of ``stride`` so the networks'
    stride-8 output grids align exactly when merged."""
    def starts(total: int, win: int) -> List[int]:
        if total <= win:
            return [0]
        step = max(int(win * (1.0 - overlap)) // stride * stride, stride)
        last = (total - win) // stride * stride
        xs = list(range(0, last + 1, step))
        if xs[-1] != last:
            xs.append(last)
        return xs

    if img_h % stride or img_w % stride:
        raise ValueError(
            f"image dims must be multiples of stride {stride}; "
            f"pad first (windowed_forward does this automatically)")
    ys = starts(img_h, win_h)
    xs = starts(img_w, win_w)
    origins = np.asarray([(y, x) for y in ys for x in xs], np.int32)
    return WindowGrid(origins, win_h, win_w, img_h, img_w)


@functools.lru_cache(maxsize=64)
def _merge_weights(grid_key) -> np.ndarray:
    """(n_windows, img_h, img_w) normalised distance weights: each
    window's contribution peaks at its centre (reference distance-
    weighted merge)."""
    origins, win_h, win_w, img_h, img_w = grid_key
    origins = np.asarray(origins)
    n = origins.shape[0]
    w = np.zeros((n, img_h, img_w), np.float32)
    yy, xx = np.mgrid[0:win_h, 0:win_w].astype(np.float32)
    cy, cx = (win_h - 1) / 2.0, (win_w - 1) / 2.0
    # distance-to-centre weight, strictly positive
    dist = np.hypot((yy - cy) / max(cy, 1), (xx - cx) / max(cx, 1))
    win_w_mat = 1.0 / (1.0 + dist)
    for i, (y0, x0) in enumerate(origins):
        w[i, y0:y0 + win_h, x0:x0 + win_w] = win_w_mat
    norm = w.sum(axis=0, keepdims=True)
    return w / np.maximum(norm, 1e-12)


@functools.lru_cache(maxsize=64)
def _merge_weights_on(grid_key, device: str) -> torch.Tensor:
    """:func:`_merge_weights` as a tensor, kept on ``device``."""
    return torch.from_numpy(_merge_weights(grid_key)).to(device)


def extract_windows(img: torch.Tensor, grid: WindowGrid) -> torch.Tensor:
    """(img_h, img_w, C) -> (n_windows, win_h, win_w, C)."""
    return torch.stack([img[y0:y0 + grid.win_h, x0:x0 + grid.win_w]
                        for y0, x0 in grid.origins.tolist()])


def merge_maps(window_maps: torch.Tensor, grid: WindowGrid,
               out_scale: float = 1.0) -> torch.Tensor:
    """(n_windows, wh, ww, C) feature maps (window size scaled by
    ``out_scale`` vs pixel space, e.g. 1/8 for the net output) ->
    merged (img_h*s, img_w*s, C). Windows are added in grid order, as
    in the JAX package."""
    s = out_scale
    origins = np.asarray(grid.origins * s, np.int64)
    key = (tuple(map(tuple, origins)), int(grid.win_h * s),
           int(grid.win_w * s), int(grid.img_h * s), int(grid.img_w * s))
    weights = _merge_weights_on(key, str(window_maps.device))  # (n, H, W)
    n, wh, ww, c = window_maps.shape
    merged = torch.zeros((key[3], key[4], c), dtype=window_maps.dtype,
                         device=window_maps.device)
    for i, (y0, x0) in enumerate(origins.tolist()):
        patch = window_maps[i] * weights[i, y0:y0 + wh, x0:x0 + ww, None]
        merged[y0:y0 + wh, x0:x0 + ww] += patch
    return merged


def pad_edge(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Pad (H, W, C) at the bottom and right to (out_h, out_w) by
    repeating the last row and column (numpy's ``mode="edge"``), for any
    dtype: the rows and columns are gathered with clamped indices."""
    h, w = img.shape[:2]
    rows = torch.arange(out_h, device=img.device).clamp(max=h - 1)
    cols = torch.arange(out_w, device=img.device).clamp(max=w - 1)
    return img[rows][:, cols]


def windowed_forward(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                     img: torch.Tensor, win_h: int, win_w: int,
                     overlap: float = 0.2) -> torch.Tensor:
    """Run ``apply_fn`` (batched NHWC -> (N, h/8, w/8, 57)) over all
    windows of ``img`` as one batch and merge to a full-image stride-8
    map. Pads the image (edge mode) to stride multiples, and up to the
    window size, when needed."""
    img_h, img_w = int(img.shape[0]), int(img.shape[1])
    tgt_h = max(img_h + (-img_h) % 8, win_h)
    tgt_w = max(img_w + (-img_w) % 8, win_w)
    if (tgt_h, tgt_w) != (img_h, img_w):
        img = pad_edge(img, tgt_h, tgt_w)
        img_h, img_w = tgt_h, tgt_w
    grid = generate_windows(img_h, img_w, win_h, win_w, overlap)
    maps = apply_fn(extract_windows(img, grid))   # (n, wh/8, ww/8, 57)
    return merge_maps(maps, grid, out_scale=1.0 / 8.0)


def multiscale_forward(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                       img: torch.Tensor, win_h: int, win_w: int,
                       scales: Sequence[float] = (1.0,),
                       overlap: float = 0.2) -> torch.Tensor:
    """Scale search (reference ``_get_scaled_img`` with float scales):
    the image is resized to each scale (bilinear, kept float and
    unrounded), every scale is covered with windows whose maps are
    merged, and the per-scale stride-8 maps are area-resampled onto the
    native grid and averaged."""
    img_h, img_w = int(img.shape[0]), int(img.shape[1])
    base_h = (img_h + (-img_h) % 8) // 8
    base_w = (img_w + (-img_w) % 8) // 8
    acc = None
    for s in scales:
        if s == 1.0:
            scaled = img
        else:
            sh = max(int(round(img_h * s / 8.0)) * 8, 8)
            sw = max(int(round(img_w * s / 8.0)) * 8, 8)
            scaled = resize_bilinear(img.float(), sh, sw)
        m = windowed_forward(apply_fn, scaled, win_h, win_w, overlap)
        if m.shape[:2] != (base_h, base_w):
            m = resize_area(m, base_h, base_w)
        acc = m if acc is None else acc + m
    return acc / len(scales)
