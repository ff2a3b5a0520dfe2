"""Training augmentations — port of ``tfpose_tpu/train/augment.py``
(reference ``tf_pose/pose_augment.py``): random scale (0.8-1.6),
rotation (±40°), horizontal flip with L/R part swap, shortest-edge
resize, random crop to network input. Joints are (n_people, 18, 2) pixel
coords with NaN for missing parts. cv2 is imported inside each function
that needs it, never when the module is imported."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tfpose_tpu_torch.core.topology import FLIP_SWAP


def random_scale(img, joints, rng, lo=0.8, hi=1.6):
    import cv2

    f = rng.uniform(lo, hi)
    h, w = img.shape[:2]
    nw, nh = max(int(w * f), 1), max(int(h * f), 1)
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    return img, joints * f


def random_rotation(img, joints, rng, max_deg=40.0):
    import cv2

    deg = rng.uniform(-max_deg, max_deg)
    h, w = img.shape[:2]
    center = (w * 0.5, h * 0.5)
    rot = cv2.getRotationMatrix2D(center, deg, 1.0)
    # expand canvas to hold the rotated image (reference uses the
    # bounding box of the rotated frame)
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    rot[0, 2] += nw / 2.0 - center[0]
    rot[1, 2] += nh / 2.0 - center[1]
    img = cv2.warpAffine(img, rot, (nw, nh), flags=cv2.INTER_AREA,
                         borderMode=cv2.BORDER_CONSTANT,
                         borderValue=(128, 128, 128))
    ones = np.ones((*joints.shape[:2], 1))
    pts = np.concatenate([joints, ones], axis=2)  # (n, 18, 3)
    new = pts @ rot.T  # (n, 18, 2)
    # rotated-out joints become missing
    oob = ((new[..., 0] < 0) | (new[..., 0] >= nw)
           | (new[..., 1] < 0) | (new[..., 1] >= nh))
    new[oob] = np.nan
    return img, new


def random_flip(img, joints, rng):
    import cv2

    if rng.uniform() < 0.5:
        return img, joints
    w = img.shape[1]
    img = cv2.flip(img, 1)
    joints = joints.copy()
    joints[..., 0] = w - 1 - joints[..., 0]
    swap = np.asarray([int(p) for p in FLIP_SWAP])
    return img, joints[:, swap]


def resize_shortest_edge(img, joints, target: int):
    import cv2

    h, w = img.shape[:2]
    scale = target / min(h, w)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
    return img, joints * scale


def random_crop(img, joints, wh: Tuple[int, int], rng):
    import cv2

    tw, th = wh
    h, w = img.shape[:2]
    pad_h, pad_w = max(th - h, 0), max(tw - w, 0)
    if pad_h or pad_w:
        img = cv2.copyMakeBorder(img, 0, pad_h, 0, pad_w,
                                 cv2.BORDER_CONSTANT,
                                 value=(128, 128, 128))
        h, w = img.shape[:2]
    x0 = rng.integers(0, w - tw + 1)
    y0 = rng.integers(0, h - th + 1)
    img = img[y0:y0 + th, x0:x0 + tw]
    joints = joints - np.asarray([x0, y0])
    oob = ((joints[..., 0] < 0) | (joints[..., 0] >= tw)
           | (joints[..., 1] < 0) | (joints[..., 1] >= th))
    joints = joints.copy()
    joints[oob] = np.nan
    return img, joints


def resize_fixed(img, joints, wh: Tuple[int, int]):
    tw, th = wh
    h, w = img.shape[:2]
    if (h, w) == (th, tw):
        # cv2.resize to the same size is a copy; so it needs no cv2
        img = img.copy()
    else:
        import cv2

        img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_AREA)
    return img, joints * np.asarray([tw / w, th / h])


def augment(img, joints, wh: Tuple[int, int], rng):
    """Full reference chain: scale -> rotate -> flip -> shortest-edge ->
    crop to network input."""
    img, joints = random_scale(img, joints, rng)
    img, joints = random_rotation(img, joints, rng)
    img, joints = random_flip(img, joints, rng)
    target = int(min(wh) * float(rng.uniform(0.95, 1.6)))
    img, joints = resize_shortest_edge(img, joints, max(target, min(wh)))
    img, joints = random_crop(img, joints, wh, rng)
    return img, joints
