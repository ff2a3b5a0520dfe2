"""COCO keypoints dataset + target rasterization.

Port of ``tfpose_tpu/train/dataset.py`` (NumPy, unchanged semantics),
the rebuild of the reference data layer (``tf_pose/pose_dataset.py``):
``CocoMetadata`` parses person-keypoints json and converts the 17 COCO
keypoints to the 18-part model (Neck = shoulder midpoint); heatmap
targets are per-part Gaussian splats (put_heatmap, sigma default 8.0)
with background = 1 - max; PAF targets are count-normalised unit
vectors within a threshold of each limb segment (put_vectormap).

The rasterizers here are vectorised NumPy (the reference's were
per-pixel Python loops under tensorpack multiprocess workers); they
run in a host thread feeding the device. ``train/targets.py`` renders
the same targets on the device. cv2 is imported only where an image is
read (``utils/imload.py``) and augmented (``train/augment.py``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from tfpose_tpu_torch.core.topology import (
    NUM_HEATMAP_CH,
    NUM_PAF_CH,
    NUM_PAIRS,
    NUM_PARTS,
    pairs_array,
    paf_channels_array,
)

logger = logging.getLogger("tfpose_tpu_torch.dataset")

# COCO-17 keypoint order (dataset json) -> our 18-part model index
# (reference CocoMetadata: model part k comes from these COCO indices;
# Neck(1) is synthesised from the two shoulders)
_COCO17_TO_18 = (0, None, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15,
                 2, 1, 4, 3)


@dataclasses.dataclass
class Annotation:
    """One image's people; joints (n_people, 18, 2) float, NaN=missing."""

    img_path: str
    width: int
    height: int
    joints: np.ndarray


def coco_to_18(keypoints: Sequence[float]) -> np.ndarray:
    """COCO 51-float keypoint triplets -> (18, 2) with NaN for missing."""
    kp = np.asarray(keypoints, dtype=np.float64).reshape(17, 3)
    out = np.full((NUM_PARTS, 2), np.nan)
    for part in range(NUM_PARTS):
        src = _COCO17_TO_18[part]
        if src is None:
            continue
        if kp[src, 2] > 0:
            out[part] = kp[src, :2]
    # Neck = midpoint of the shoulders, present only if both are
    ls, rs = kp[5], kp[6]
    if ls[2] > 0 and rs[2] > 0:
        out[1] = (ls[:2] + rs[:2]) / 2.0
    return out


def load_coco_annotations(json_path: str, img_dir: str,
                          min_kp: int = 1) -> List[Annotation]:
    """Parse a person_keypoints_*.json into per-image annotations."""
    with open(json_path) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    by_img = {}
    for ann in coco.get("annotations", []):
        if ann.get("num_keypoints", 0) < min_kp or ann.get("iscrowd"):
            continue
        by_img.setdefault(ann["image_id"], []).append(
            coco_to_18(ann["keypoints"]))
    out = []
    for img_id, joints in by_img.items():
        im = images[img_id]
        out.append(Annotation(
            img_path=os.path.join(img_dir, im["file_name"]),
            width=im["width"], height=im["height"],
            joints=np.stack(joints)))
    return out


# ---------------------------------------------------------------------------
# target rasterization (vectorised reference semantics)
# ---------------------------------------------------------------------------

def get_heatmap(joints: np.ndarray, target_h: int, target_w: int,
                sigma: float = 8.0, stride: float = 1.0) -> np.ndarray:
    """(n_people, 18, 2) joint pixel coords (at stride-1 scale) ->
    (target_h, target_w, 19) heatmaps at ``stride`` resolution.

    Reference ``put_heatmap``: per-pixel exp(-d^2 / sigma^2) — note the
    reference uses sigma^2 not 2*sigma^2 — accumulated with max, clipped
    at 1.0; background channel = 1 - max(parts).
    """
    heat = np.zeros((target_h, target_w, NUM_HEATMAP_CH), dtype=np.float32)
    if joints.size:
        yy, xx = np.mgrid[0:target_h, 0:target_w]
        cyy = (yy + 0.5) * stride - 0.5 if stride != 1.0 else yy
        cxx = (xx + 0.5) * stride - 0.5 if stride != 1.0 else xx
        for person in joints:
            for part in range(NUM_PARTS):
                px, py = person[part]
                if not np.isfinite(px):
                    continue
                d2 = (cxx - px) ** 2 + (cyy - py) ** 2
                g = np.exp(-d2 / (sigma ** 2))
                np.maximum(heat[:, :, part], g, out=heat[:, :, part])
    np.clip(heat, 0.0, 1.0, out=heat)
    heat[:, :, NUM_PARTS] = 1.0 - heat[:, :, :NUM_PARTS].max(axis=2)
    return heat


def get_vectormap(joints: np.ndarray, target_h: int, target_w: int,
                  threshold: float = 8.0, stride: float = 1.0
                  ) -> np.ndarray:
    """(n_people, 18, 2) -> (target_h, target_w, 38) PAF targets.

    Reference ``put_vectormap``: for each limb, unit vector written at
    every pixel within ``threshold`` of the segment; overlapping limbs
    are count-normalised (``get_vectormap`` divides by nonzero count).
    """
    pairs = pairs_array()
    paf_ch = paf_channels_array()
    vec = np.zeros((target_h, target_w, NUM_PAF_CH), dtype=np.float32)
    cnt = np.zeros((target_h, target_w, NUM_PAIRS), dtype=np.int32)
    if joints.size == 0:
        return vec
    yy, xx = np.mgrid[0:target_h, 0:target_w]
    cyy = ((yy + 0.5) * stride - 0.5) if stride != 1.0 else yy
    cxx = ((xx + 0.5) * stride - 0.5) if stride != 1.0 else xx
    for person in joints:
        for pid in range(NUM_PAIRS):
            a = person[pairs[pid, 0]]
            b = person[pairs[pid, 1]]
            if not (np.isfinite(a[0]) and np.isfinite(b[0])):
                continue
            d = b - a
            norm = float(np.hypot(d[0], d[1]))
            if norm < 1e-6:
                continue
            v = d / norm
            rel_x = cxx - a[0]
            rel_y = cyy - a[1]
            t = np.clip((rel_x * v[0] + rel_y * v[1]) / norm, 0.0, 1.0)
            dist = np.hypot(rel_x - t * d[0], rel_y - t * d[1])
            mask = dist <= threshold
            cx, cy = paf_ch[pid]
            vec[:, :, cx] += np.where(mask, v[0], 0.0).astype(np.float32)
            vec[:, :, cy] += np.where(mask, v[1], 0.0).astype(np.float32)
            cnt[:, :, pid] += mask
    nz = np.maximum(cnt, 1).astype(np.float32)
    for pid in range(NUM_PAIRS):
        cx, cy = paf_ch[pid]
        vec[:, :, cx] /= nz[:, :, pid]
        vec[:, :, cy] /= nz[:, :, pid]
    return vec


# ---------------------------------------------------------------------------
# batching iterator (the tensorpack DataFlow + FIFOQueue equivalent)
# ---------------------------------------------------------------------------

class PrefetchIterator:
    """Background-thread batch prefetcher — the slot of the reference's
    tensorpack ``PrefetchData`` + ``DataFlowToQueue`` FIFO feeder
    (single producer thread, bounded queue, overlap host data prep
    with device steps)."""

    def __init__(self, iterable, depth: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=depth)
        self._done = object()

        def run():
            try:
                for item in iterable:
                    self._q.put(item)
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                return
            yield item


class PoseDataset:
    """Training batch iterator: reads images, augments, rasterises
    targets at stride 8, yields device-ready dicts.

    The reference fed batches via tensorpack PrefetchData workers and a
    TF FIFOQueue thread (``DataFlowToQueue``); here a thread pool
    prefetches batches which the caller overlaps with device steps.
    """

    def __init__(self, annotations: Sequence[Annotation],
                 input_size: Tuple[int, int] = (368, 368),
                 batch_size: int = 8, augment: bool = True,
                 sigma: float = 8.0, paf_threshold: float = 1.0,
                 seed: int = 0, device_targets: bool = False,
                 uint8: bool = False, max_people: int = 8):
        self.anns = list(annotations)
        self.input_wh = input_size
        self.batch = batch_size
        self.augment = augment
        self.sigma = sigma
        self.paf_threshold = paf_threshold
        self.rng = np.random.default_rng(seed)
        # device_targets: skip host rasterization; yield NaN-padded
        # stride-8 'joints' for the train step's on-device
        # targets.batch_targets (train --device-targets).
        # uint8: ship raw frames, normalize on the device (1/4 the
        # host->device bytes; the reference's FIFOQueue shipped uint8).
        self.device_targets = device_targets
        self.uint8 = uint8
        self.max_people = max_people

    def _prepare(self, img: np.ndarray, joints: np.ndarray):
        """Augment (or fixed-resize) + rasterise stride-8 targets."""
        from tfpose_tpu_torch.train import augment as aug

        if self.augment:
            img, joints = aug.augment(img, joints, self.input_wh, self.rng)
        else:
            img, joints = aug.resize_fixed(img, joints, self.input_wh)
        if self.device_targets:
            padded = np.full((self.max_people, NUM_PARTS, 2), np.nan,
                             np.float32)
            n = min(len(joints), self.max_people)
            padded[:n] = joints[:n] / 8.0
            return img, padded, None
        w, h = self.input_wh
        hs, ws = h // 8, w // 8
        heat = get_heatmap(joints / 8.0, hs, ws, sigma=self.sigma / 8.0)
        paf = get_vectormap(joints / 8.0, hs, ws,
                            threshold=self.paf_threshold)
        return img, heat, paf

    def _load_one(self, ann: Annotation):
        from tfpose_tpu_torch.utils.imload import read_imgfile

        img = read_imgfile(ann.img_path, None, None)
        if img is None:
            img = np.zeros((ann.height, ann.width, 3), np.uint8)
        return self._prepare(img, ann.joints.copy())

    def __iter__(self) -> Iterator[dict]:
        order = self.rng.permutation(len(self.anns))
        for i in range(0, len(order) - self.batch + 1, self.batch):
            imgs, heats, pafs = [], [], []
            for j in order[i:i + self.batch]:
                img, heat, paf = self._load_one(self.anns[j])
                imgs.append(img)
                heats.append(heat)
                pafs.append(paf)
            images = np.stack(imgs)
            if not self.uint8:
                images = images.astype(np.float32) / 256.0 - 0.5
            if self.device_targets:
                # 'heats' carries the padded joints in this mode
                yield {"image": images, "joints": np.stack(heats)}
            else:
                yield {"image": images, "heat": np.stack(heats),
                       "paf": np.stack(pafs)}
