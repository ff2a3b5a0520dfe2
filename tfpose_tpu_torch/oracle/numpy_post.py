"""NumPy oracle for the in-graph post-processing the reference builds in
``TfPoseEstimator.__init__`` (``tf_pose/estimator.py:~310-470``) — the
port's copy of ``tfpose_tpu/oracle/numpy_post.py``:

  upsample (TF1 ``tf.image.resize_area``, align_corners=False)
  -> Gaussian smoothing (``tf_pose/tensblur/smoother.py``: 25x25 kernel
     built from scipy norm.cdf differences, nsig=3, depthwise conv SAME)
  -> max-pool NMS (``tf.nn.pool`` 3x3 MAX SAME + equality mask).

These are the parity anchors of the decode kernels' inputs in the port's
parity sweep (``evaluation/parity_sweep.py``).
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def area_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Row-weight matrix W (out_size, in_size) for 1-D area resize,
    matching TF1 ``tf.image.resize_area(align_corners=False)`` semantics:
    output cell i covers input span [i*s, (i+1)*s), s = in/out; each input
    cell contributes proportionally to its overlap with the span.

    Area resize is separable, so 2-D resize = W_h @ X @ W_w^T — on TPU
    the port's ``ops/resize.py`` applies it as two matmuls.
    """
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        lo = i * scale
        hi = (i + 1) * scale
        j0 = int(np.floor(lo))
        j1 = int(np.ceil(hi))
        for j in range(j0, min(j1, in_size)):
            overlap = min(hi, j + 1) - max(lo, j)
            if overlap > 0:
                w[i, j] = overlap
        w[i] /= scale
    return w


def area_resize(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) -> (out_h, out_w, C) area resize.

    Two separable contractions (W_h over rows, then W_w over columns)
    rather than one naive 4-way einsum — ~100x faster on one CPU
    host and identical to ~1e-15 relative (float64 reassociation
    only). Every output pixel is computed by the same dot-product
    routine, so exactly-equal neighborhoods still produce exactly
    equal outputs — the tie determinism the NMS parity recipes need.
    """
    wh = area_resize_weights(x.shape[0], out_h)
    ww = area_resize_weights(x.shape[1], out_w)
    tmp = np.tensordot(wh, x.astype(np.float64), axes=(1, 0))  # (h,W,C)
    return np.tensordot(ww, tmp, axes=(1, 1)).transpose(1, 0, 2)


def gauss_kernel_1d(kernlen: int = 25, nsig: float = 3.0) -> np.ndarray:
    """1-D Gaussian weights via the reference Smoother's construction:
    differences of the normal CDF over kernlen+1 evenly spaced points in
    [-nsig, nsig] (tf_pose/tensblur/smoother.py gauss_kernel).

    The reference builds the 2-D kernel as the outer product of this
    vector with itself, then normalises by the 2-D sum — i.e. the kernel
    is exactly separable.
    """
    interval = (2.0 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0,
                    kernlen + 1)
    kern1d = np.diff(stats.norm.cdf(x))
    return kern1d


def gauss_kernel_2d(kernlen: int = 25, nsig: float = 3.0) -> np.ndarray:
    k1 = gauss_kernel_1d(kernlen, nsig)
    raw = np.outer(k1, k1)
    return raw / raw.sum()


def smooth(x: np.ndarray, kernlen: int = 25, nsig: float = 3.0) -> np.ndarray:
    """Depthwise 2-D Gaussian blur, SAME zero padding (reference Smoother)."""
    kern = gauss_kernel_2d(kernlen, nsig)
    h, w, c = x.shape
    pad = kernlen // 2
    xp = np.zeros((h + 2 * pad, w + 2 * pad, c), dtype=np.float64)
    xp[pad:pad + h, pad:pad + w] = x
    out = np.zeros_like(x, dtype=np.float64)
    # direct separable convolution (kernel is symmetric => corr == conv)
    k1 = gauss_kernel_1d(kernlen, nsig)
    k1n = k1 / np.sqrt(np.outer(k1, k1).sum())
    tmp = np.zeros((h, w + 2 * pad, c), dtype=np.float64)
    for i in range(kernlen):
        tmp += k1n[i] * xp[i:i + h, :, :]
    for j in range(kernlen):
        out += k1n[j] * tmp[:, j:j + w, :]
    return out


def nms_peaks(x: np.ndarray, window: int = 3) -> np.ndarray:
    """3x3 max-pool NMS with SAME padding: keep values equal to the local
    max, zero elsewhere (reference tf.nn.pool MAX + tf.where)."""
    h, w, c = x.shape
    pad = window // 2
    xp = np.full((h + 2 * pad, w + 2 * pad, c), -np.inf, dtype=np.float64)
    xp[pad:pad + h, pad:pad + w] = x
    pooled = np.full_like(x, -np.inf, dtype=np.float64)
    for di in range(window):
        for dj in range(window):
            np.maximum(pooled, xp[di:di + h, dj:dj + w, :], out=pooled)
    return np.where(x >= pooled, x, 0.0)


def full_post(heat57: np.ndarray, up_h: int, up_w: int,
              kernlen: int = 25, nsig: float = 3.0):
    """Reference post-graph: split 57ch -> upsample both -> smooth heat ->
    NMS. Returns (peaks, heat_up, paf_up)."""
    heat = heat57[:, :, :19]
    paf = heat57[:, :, 19:]
    heat_up = area_resize(heat, up_h, up_w)
    paf_up = area_resize(paf, up_h, up_w)
    smoothed = smooth(heat_up, kernlen, nsig)
    peaks = nms_peaks(smoothed)
    return peaks, heat_up, paf_up
