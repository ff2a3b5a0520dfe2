"""Preprocessing on the device: normalize and resize
(port of ``tfpose_tpu/pipeline/preprocess.py``)."""

from __future__ import annotations

import torch

from tfpose_tpu_torch.ops.resize import (
    resize_area,
    resize_area_u8,
    resize_bilinear,
)


def normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 in [-0.5, 0.5]: image / 256 - 0.5,
    the reference training convention (``pose_augment.py pose_to_img``)."""
    return img.float() / 256.0 - 0.5


def downscale_area(img: torch.Tensor, target_h: int,
                   target_w: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> uint8 (..., target_h, target_w, 3) by area
    averaging, rounded half up: the JAX estimator's host resize
    (``cv2.INTER_AREA``) when the image shrinks on both axes. It equals
    cv2 bit for bit at integer factors (864x736 -> 432x368); elsewhere a
    sum that lands within an ulp of .5 can round the other way."""
    x = resize_area(img.float(), target_h, target_w)
    return torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)


def prepare(img: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized float (..., target_h, target_w, 3)
    on the tensor's device, resized to uint8 first as the JAX estimator
    does on the host with ``cv2.INTER_AREA``: an image at least as large
    as the target on both axes by area averaging (:func:`downscale_area`),
    one that is smaller on an axis by cv2's linear rule with area weights
    (:func:`resize_area_u8`, byte for byte)."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (target_h, target_w):
        return normalize(img)
    if h >= target_h and w >= target_w:
        return normalize(downscale_area(img, target_h, target_w))
    return normalize(resize_area_u8(img, target_h, target_w))


def prepare_bilinear(img: torch.Tensor, target_h: int,
                     target_w: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized float (..., target_h, target_w, 3)
    by a half-pixel bilinear resize of the normalized image on the
    tensor's device: the JAX package's ``prepare`` (its estimator's
    ``device_preprocess`` path), not cv2's numerics."""
    x = normalize(img)
    if x.shape[-3] != target_h or x.shape[-2] != target_w:
        x = resize_bilinear(x, target_h, target_w)
    return x
