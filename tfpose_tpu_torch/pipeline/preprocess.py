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
    averaging: the JAX estimator's host resize (``cv2.INTER_AREA``) when
    the image shrinks on both axes. At integer factors it is cv2's fast
    path bit for bit: the int sum of each fy x fx block, at 2 x 2
    ``(sum + 2) >> 2``, else ``sum * float32(1 / (fy * fx))`` rounded half
    to even. Elsewhere the average rounds half up, and a sum that lands
    within an ulp of .5 can round the other way than cv2's."""
    h, w = img.shape[-3], img.shape[-2]
    if h % target_h == 0 and w % target_w == 0:
        fy, fx = h // target_h, w // target_w
        s = img.int().reshape(*img.shape[:-3], target_h, fy, target_w, fx,
                              img.shape[-1]).sum((-4, -2), dtype=torch.int32)
        if fy == fx == 2:
            return ((s + 2) >> 2).to(torch.uint8)
        v = s.float() * torch.tensor(1.0 / (fy * fx), dtype=torch.float32)
        return torch.round(v).clamp(0, 255).to(torch.uint8)
    x = resize_area(img.float(), target_h, target_w)
    return torch.floor(x + 0.5).clamp(0, 255).to(torch.uint8)


def prepare(img: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> normalized float (..., target_h, target_w, 3)
    on the tensor's device, resized to uint8 first as the JAX estimator
    does on the host with ``cv2.INTER_AREA``: an image at least as large
    as the target on both axes by area averaging (:func:`downscale_area`),
    one that is smaller on an axis by cv2's linear rule with area weights
    (:func:`resize_area_u8`, byte for byte)."""
    return normalize(resize_u8(img, target_h, target_w))


def resize_u8(img: torch.Tensor, target_h: int,
              target_w: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> uint8 (..., target_h, target_w, 3) as
    ``cv2.resize(..., interpolation=cv2.INTER_AREA)``: by area averaging
    (:func:`downscale_area`) where it shrinks on both axes, else by cv2's
    linear rule with area weights (:func:`resize_area_u8`)."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (target_h, target_w):
        return img
    if h >= target_h and w >= target_w:
        return downscale_area(img, target_h, target_w)
    return resize_area_u8(img, target_h, target_w)


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
