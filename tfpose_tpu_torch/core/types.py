"""Public data model: ``BodyPart`` / ``Human`` plus the fixed-shape
representation (``PoseArrays``) the decode path produces.

A copy of ``tfpose_tpu/core/types.py``; the port imports nothing of the
JAX package.

Mirrors the reference API surface in ``tf_pose/estimator.py:~30-160``
(``Human``, ``BodyPart`` with normalized coords and per-part scores,
``get_face_box`` / ``get_upper_body_box``), but the on-device result is a
padded pytree with static shapes — Python objects are only materialised
host-side at the very end. A ``Human`` and its ``BodyPart``s carry their
skeleton (``core/topology.py``: COCO-18 by default, or BODY_25), which
names their parts and places the face and torso parts the boxes read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from tfpose_tpu_torch.core.topology import COCO18, Skeleton


@dataclasses.dataclass(frozen=True)
class BodyPart:
    """One detected keypoint; ``x``/``y`` are normalized to [0, 1]."""

    uidx: str
    part_idx: int
    x: float
    y: float
    score: float
    skeleton: Skeleton = dataclasses.field(default=COCO18, compare=False)

    def get_part_name(self):
        """The part as its skeleton's enum member (``CocoPart``,
        ``Body25Part``)."""
        return self.skeleton.part(self.part_idx)

    def __repr__(self) -> str:
        return "BodyPart:%d-(%.2f, %.2f) score=%.2f" % (
            self.part_idx, self.x, self.y, self.score)


class Human:
    """A detected person: dict of BodyPart keyed by part index, plus score,
    of ``skeleton``'s parts."""

    __slots__ = ("body_parts", "pairs", "uidx_list", "score", "skeleton")

    def __init__(self, pairs=(), skeleton: Skeleton = COCO18):
        self.pairs = list(pairs)
        self.uidx_list = set()
        self.body_parts: Dict[int, BodyPart] = {}
        self.score = 0.0
        self.skeleton = skeleton

    def part_count(self) -> int:
        return len(self.body_parts)

    def get_max_score(self) -> float:
        return max((p.score for p in self.body_parts.values()), default=0.0)

    def get_face_box(self, img_w: int, img_h: int, mode: int = 0) -> Optional[dict]:
        """Bounding box of the face, reference ``Human.get_face_box`` semantics."""
        part = self.skeleton.index
        _NOSE, _NECK = part("Nose"), part("Neck")
        _REye, _LEye = part("REye"), part("LEye")
        _REar, _LEar = part("REar"), part("LEar")

        if _NOSE not in self.body_parts:
            return None
        nose = self.body_parts[_NOSE]
        size = 0.0
        if _NECK in self.body_parts:
            neck = self.body_parts[_NECK]
            size = max(size, img_h * (neck.y - nose.y) * 0.8)
        for eye_i in (_REye, _LEye):
            if eye_i in self.body_parts:
                eye = self.body_parts[eye_i]
                size = max(size, img_w * abs(eye.x - nose.x) * 2.0 * 4.0)
        for ear_i in (_REar, _LEar):
            if ear_i in self.body_parts:
                ear = self.body_parts[ear_i]
                size = max(size, img_w * abs(ear.x - nose.x) * 1.6)
        if size <= 0:
            return None
        if mode == 0:
            x, y = nose.x * img_w, nose.y * img_h
            if _REye in self.body_parts and _LEye in self.body_parts:
                x = img_w * (self.body_parts[_REye].x + self.body_parts[_LEye].x
                             + nose.x) / 3.0
                y = img_h * (self.body_parts[_REye].y + self.body_parts[_LEye].y
                             + nose.y) / 3.0
        else:
            x, y = nose.x * img_w, nose.y * img_h
        return {"x": _round(x), "y": _round(y),
                "w": _round(size), "h": _round(size)}

    def get_upper_body_box(self, img_w: int, img_h: int) -> Optional[dict]:
        """Bounding box of the upper body, reference semantics (needs >=5 of
        the 8 torso/head parts incl. both shoulders)."""
        if not (img_w > 0 and img_h > 0):
            raise Exception("img size should be positive")
        part = self.skeleton.index
        _NOSE, _NECK = part("Nose"), part("Neck")
        _RSHO, _LSHO = part("RShoulder"), part("LShoulder")
        _RHIP, _LHIP = part("RHip"), part("LHip")
        _REye, _LEye = part("REye"), part("LEye")
        part_coords = [
            (img_w * self.body_parts[i].x, img_h * self.body_parts[i].y)
            for i in (_NOSE, _NECK, _RSHO, _LSHO, _RHIP, _LHIP)
            if i in self.body_parts
        ]
        if len(part_coords) < 5:
            return None
        xs = [c[0] for c in part_coords]
        ys = [c[1] for c in part_coords]
        x, y = min(xs), min(ys)
        x2, y2 = max(xs), max(ys)
        # face extension, as in the reference
        if _NOSE in self.body_parts and _NECK in self.body_parts:
            y -= 0.3 * (self.body_parts[_NECK].y - self.body_parts[_NOSE].y) * img_h
        elif _NECK in self.body_parts and (
                _REye in self.body_parts or _LEye in self.body_parts):
            y -= 0.2 * img_h
        w, h = x2 - x, y2 - y
        if w <= 0 or h <= 0:
            return None
        return {"x": _round(x + w / 2.0), "y": _round(y + h / 2.0),
                "w": _round(w), "h": _round(h)}

    def __repr__(self) -> str:
        return " ".join(str(p) for p in self.body_parts.values())


def _round(v: float) -> int:
    return int(round(v))


@dataclasses.dataclass
class PoseArrays:
    """Fixed-shape decode output (device-friendly, padded).

    Attributes:
      coords: (max_humans, parts, 2) float32, (x, y) normalized to [0, 1]
        in heatmap space (x = peak_x / W, y = peak_y / H) — matching the
        reference ``PoseEstimator.estimate_paf`` normalisation.
      scores: (max_humans, parts) float32 per-part heatmap scores.
      part_valid: (max_humans, parts) bool.
      human_scores: (max_humans,) float32 — mean connection score per human
        (reference ``get_score`` semantics).
      human_valid: (max_humans,) bool.
      skeleton: the parts' skeleton (COCO-18 by default).
    """

    coords: np.ndarray
    scores: np.ndarray
    part_valid: np.ndarray
    human_scores: np.ndarray
    human_valid: np.ndarray
    skeleton: Skeleton = COCO18

    @classmethod
    def of(cls, arrays, skeleton: Skeleton = COCO18) -> "PoseArrays":
        """One image's decoded arrays (``ops/assemble.py:Assembled``) as
        the parts of ``skeleton``."""
        return cls(coords=arrays.coords, scores=arrays.part_scores,
                   part_valid=arrays.part_valid,
                   human_scores=arrays.human_scores,
                   human_valid=arrays.human_valid, skeleton=skeleton)

    def to_humans(self) -> List[Human]:
        """Materialise Python Human objects (host-side, reference-compatible)."""
        sk = self.skeleton
        coords = np.asarray(self.coords)
        scores = np.asarray(self.scores)
        part_valid = np.asarray(self.part_valid)
        hscores = np.asarray(self.human_scores)
        hvalid = np.asarray(self.human_valid)
        humans: List[Human] = []
        for h in range(coords.shape[0]):
            if not hvalid[h]:
                continue
            human = Human(skeleton=sk)
            for p in range(sk.num_parts):
                if not part_valid[h, p]:
                    continue
                uidx = "%d-%d" % (h, p)
                human.body_parts[p] = BodyPart(
                    uidx, p,
                    float(coords[h, p, 0]), float(coords[h, p, 1]),
                    float(scores[h, p]), sk)
                human.uidx_list.add(uidx)
            human.score = float(hscores[h])
            if human.body_parts:
                humans.append(human)
        return humans
