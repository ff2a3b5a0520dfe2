"""Gaussian heatmap smoothing (reference ``tf_pose/tensblur/smoother.py``).

Port of ``tfpose_tpu/ops/gaussian.py``'s kernel: a 25x25 kernel from
differences of the normal CDF (nsig=3), the outer product of a 1-D vector
with itself normalised by its sum. The blur that applies it, two 1-D
passes with zero SAME padding, is the smoothing kernels' plain version
(``ops/kernels/smooth_nms.py:blur_in_tap_order``).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=16)
def gauss_kernel_1d(kernlen: int = 25, nsig: float = 3.0) -> np.ndarray:
    """Normalised 1-D Gaussian weights (reference construction)."""
    from scipy import stats

    interval = (2.0 * nsig + 1.0) / kernlen
    x = np.linspace(-nsig - interval / 2.0, nsig + interval / 2.0,
                    kernlen + 1)
    kern1d = np.diff(stats.norm.cdf(x))
    # 2-D kernel = outer(k, k) / sum(outer(k, k)) => 1-D factor = k / sum(k)
    return (kern1d / kern1d.sum()).astype(np.float32)
