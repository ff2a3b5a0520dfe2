"""Image IO helpers — port of ``tfpose_tpu/utils/imload.py`` (reference
``tf_pose/common.py``: ``read_imgfile``, ``get_sample_images``).

They read files with cv2, imported when called: the port's hot path
needs no image decoder, and the card machine has none. Without cv2 they
raise ``RuntimeError``, as the JAX module does.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 is required for read_imgfile") from None
    return cv2


def read_imgfile(path: str, width: Optional[int] = None,
                 height: Optional[int] = None) -> Optional[np.ndarray]:
    """Read an image (BGR uint8), optionally resizing to (width, height)
    with cv2's default (bilinear) interpolation, as the reference does."""
    cv2 = _cv2()
    val_image = cv2.imread(path, cv2.IMREAD_COLOR)
    if val_image is None:
        return None
    if width is not None and height is not None and width > 0 and height > 0:
        val_image = cv2.resize(val_image, (width, height))
    return val_image


def get_sample_images(w: int, h: int,
                      image_dir: Optional[str] = None) -> List[np.ndarray]:
    """Load the sample images directory (reference images/ test photos)."""
    base = image_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "images")
    out = []
    if not os.path.isdir(base):
        return out
    for name in sorted(os.listdir(base)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = read_imgfile(os.path.join(base, name), w, h)
        if img is not None:
            out.append(img)
    return out
