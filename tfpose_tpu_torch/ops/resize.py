"""Resize ops with exact TF1 semantics, as separable matmuls.

Port of ``tfpose_tpu/ops/resize.py``: the reference post-graph
upsamples heatmaps/PAFs with TF1 ``tf.image.resize_area``
(align_corners=False). Area resize is separable and linear, so 1-D
weight matrices are built on the host and applied as two matmuls; an
integer upscale is plain replication. Half-pixel bilinear weights serve
the multi-scale image resize, and :func:`resize_area_u8` is the host
resize the JAX estimator applies to an image smaller than the network
(``cv2.INTER_AREA``). Tensors are (..., H, W, C), as in JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _area_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights for TF1 resize_area, align_corners=False."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo, hi = i * scale, (i + 1) * scale
        j0, j1 = int(np.floor(lo)), int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap
        w[i] /= scale
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _bilinear_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights for half-pixel bilinear resize."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        w[0, :] = 0.0
        w[0, min(in_size - 1, 0)] = 1.0
        return w.astype(np.float32)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        j0 = int(np.floor(src))
        frac = src - j0
        j0c = min(max(j0, 0), in_size - 1)
        j1c = min(max(j0 + 1, 0), in_size - 1)
        w[i, j0c] += 1.0 - frac
        w[i, j1c] += frac
    return w.astype(np.float32)


def _apply_separable(x: torch.Tensor, wh: np.ndarray,
                     ww: np.ndarray) -> torch.Tensor:
    """Apply (out_h, in_h) and (out_w, in_w) weights to (..., H, W, C)."""
    x = x.float()
    wh_t = torch.from_numpy(wh).to(x.device)
    ww_t = torch.from_numpy(ww).to(x.device)
    x = torch.einsum("hH,...HWc->...hWc", wh_t, x)
    return torch.einsum("wW,...hWc->...hwc", ww_t, x)


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 resize_area on (..., H, W, C). For integer upscale factors it
    is exact nearest-neighbour replication (each output cell lies inside
    one input cell), the common case on stride-8 maps."""
    *_, h, w, _ = x.shape
    if out_h % h == 0 and out_w % w == 0 and (out_h > h or out_w > w):
        x = x.float().repeat_interleave(out_h // h, dim=-3)
        return x.repeat_interleave(out_w // w, dim=-2)
    return _apply_separable(x, _area_weights_np(h, out_h),
                            _area_weights_np(w, out_w))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize on (..., H, W, C)."""
    *_, h, w, _ = x.shape
    return _apply_separable(x, _bilinear_weights_np(h, out_h),
                            _bilinear_weights_np(w, out_w))


@functools.lru_cache(maxsize=256)
def _cv_area_linear_np(in_size: int, out_size: int):
    """One axis of ``cv2.resize(..., INTER_AREA)`` when the image does not
    shrink on both axes: cv2 then interpolates linearly between source
    pixels ``src`` and ``src + 1`` with its "pixel area" weights,
    ``src = floor(d * scale)``, ``f = (d + 1) - (src + 1) / scale``,
    ``f = 0 if f <= 0 else f - floor(f)`` (f in float32), clamped to the
    last pixel, as 11-bit fixed-point coefficients (``1 - f`` and ``f``
    times 2048, rounded to nearest even). Returns (src (out,), weights
    (out, 2)) as int64."""
    inv = out_size / in_size
    scale = 1.0 / inv
    src = np.empty(out_size, np.int64)
    wts = np.empty((out_size, 2), np.int64)
    one, fix = np.float32(1), np.float32(2048)
    for d in range(out_size):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0) if f <= 0 else np.float32(f - np.floor(f))
        if s >= in_size - 1:
            s, f = in_size - 1, np.float32(0)
        src[d] = s
        wts[d] = (np.rint((one - f) * fix), np.rint(f * fix))
    return src, wts


def resize_area_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 (..., H, W, C) -> uint8 (..., out_h, out_w, C), equal to
    ``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` byte
    for byte where the image does not shrink on both axes (it enlarges on
    one or both). cv2's fixed-point arithmetic, in int32: the horizontal
    pass ``x[src] * w0 + x[src + 1] * w1`` exactly, then the vertical pass
    as its SIMD rows compute it, ``((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1
    >> 16)`` rounded by ``(v + 2) >> 2``."""
    *_, h, w, _ = img.shape
    dev = img.device
    sy, wy = (torch.from_numpy(a).to(dev) for a in _cv_area_linear_np(h, out_h))
    sx, wx = (torch.from_numpy(a).to(dev) for a in _cv_area_linear_np(w, out_w))
    x = img.to(torch.int32)
    wx, wy = wx.to(torch.int32), wy.to(torch.int32)
    hor = (x.index_select(-2, sx) * wx[:, 0, None]
           + x.index_select(-2, (sx + 1).clamp(max=w - 1)) * wx[:, 1, None])
    r0 = hor.index_select(-3, sy) >> 4
    r1 = hor.index_select(-3, (sy + 1).clamp(max=h - 1)) >> 4
    v = ((r0 * wy[:, 0, None, None]) >> 16) + ((r1 * wy[:, 1, None, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)
