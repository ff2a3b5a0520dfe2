"""Resize ops with exact TF1 semantics, as separable matmuls.

Port of ``tfpose_tpu/ops/resize.py``: the reference post-graph
upsamples heatmaps/PAFs with TF1 ``tf.image.resize_area``
(align_corners=False). Area resize is separable and linear, so 1-D
weight matrices are built on the host and applied as two matmuls; an
integer upscale is plain replication. Half-pixel bilinear weights serve
the multi-scale image resize, and :func:`resize_area_u8` is the host
resize the JAX estimator applies to an image smaller than the network
(``cv2.INTER_AREA``). The bilinear resize applies its two taps per
output elementwise, so it rounds alike on every device (the int8
backbone of mobilenet_v2 quantises its output). Tensors are
(..., H, W, C), as in JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tfpose_tpu_torch.parallel import halo


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


@functools.lru_cache(maxsize=256)
def _bilinear_taps_np(in_size: int, out_size: int):
    """The two taps of each row of :func:`_bilinear_weights_np`: (first
    index, second index, first weight, second weight); a row with one
    nonzero weight gets a second tap of weight 0."""
    w = _bilinear_weights_np(in_size, out_size)
    taps = np.zeros((out_size, 2), np.int64)
    wts = np.zeros((out_size, 2), np.float32)
    for i, row in enumerate(w):
        nz = np.flatnonzero(row)
        if not 1 <= len(nz) <= 2:
            raise ValueError("a bilinear row has one or two taps")
        taps[i] = (nz[0], nz[-1])
        wts[i, :len(nz)] = row[nz]
    return taps[:, 0], taps[:, 1], wts[:, 0], wts[:, 1]


def _two_taps(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """``x[i0] * w0 + x[i1] * w1`` along ``dim``, each op rounded on its
    own: the same bits on every device, where a matrix product's sum
    order is the library's."""
    i0, i1, w0, w1 = (torch.from_numpy(a).to(x.device) for a in taps)
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, i0) * w0.view(shape)
            + x.index_select(dim, i1) * w1.view(shape))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize on (..., H, W, C), two taps per output
    along each axis (:func:`_bilinear_weights_np`'s nonzero weights).

    Row sharded inside ``parallel/halo.py:use`` (mobilenet_v2's 2x
    upsample): ``x`` and the result are this rank's blocks of rows (the
    result's ``out_h`` of them), the global heights are read off the
    widths, and the rows the block's taps reach are fetched from the
    neighbours first; each output is the same two-tap sum as unsharded."""
    *_, h, w, _ = x.shape
    rows = halo.current_rows()
    if rows is None:
        x = _two_taps(x.float(), _bilinear_taps_np(h, out_h), -3)
    else:
        in_rows, out_rows = rows.rows_at(w), rows.rows_at(out_w)
        i0, i1, w0, w1 = _bilinear_taps_np(in_rows, out_rows)
        b = rows.bounds(out_rows)
        o0, o1 = b[rows.index], b[rows.index + 1]
        if o1 - o0 != out_h:
            raise ValueError(f"rank {rows.index} holds {o1 - o0} of the "
                             f"{out_rows} output rows, not {out_h}")
        needs = [(int(i0[b[r]:b[r + 1]].min()),
                  int(i1[b[r]:b[r + 1]].max()) + 1) for r in range(rows.n)]
        x = halo.fetch(x.float(), rows, -3, in_rows, needs)
        lo = needs[rows.index][0]
        x = _two_taps(x, (i0[o0:o1] - lo, i1[o0:o1] - lo, w0[o0:o1],
                          w1[o0:o1]), -3)
    return _two_taps(x, _bilinear_taps_np(w, out_w), -2)


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
