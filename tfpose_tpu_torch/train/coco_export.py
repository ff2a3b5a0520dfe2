"""Write a synthetic rendered dataset to disk in COCO
``person_keypoints`` format — port of ``tfpose_tpu/train/coco_export.py``.

It proves the real data path learns: ``images/*.png`` plus a
``person_keypoints`` json of 17-keypoint COCO triplets, the format that
``load_coco_annotations -> PoseDataset -> augment -> rasterizers``
consumes (``train --coco-json <json> --img-dir <dir>``). Images are
written and read with cv2 (BGR both ways, a lossless PNG round trip),
imported inside :func:`write_synthetic_coco`.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

# Inverse of dataset._COCO17_TO_18: model part index for each COCO
# keypoint id (neck has no COCO slot; loaders re-derive it as the
# shoulder midpoint).
_COCO17_FROM_18 = (0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9,
                   13, 10)

COCO_KP_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]


def person_to_coco17(person: np.ndarray) -> Tuple[List[float], int]:
    """(18, 2) model-part coords (NaN = missing) -> COCO 51-float
    keypoint triplets [x, y, v] + num_keypoints. Exact inverse of
    ``dataset.coco_to_18`` up to the derived neck."""
    kp = np.zeros((17, 3), np.float64)
    n = 0
    for coco_id in range(17):
        x, y = person[_COCO17_FROM_18[coco_id]]
        if not np.isnan(x):
            kp[coco_id] = (float(x), float(y), 2)
            n += 1
    return [round(float(v), 2) for v in kp.reshape(-1)], n


def write_synthetic_coco(out_dir: str, n_images: int,
                         wh: Tuple[int, int] = (160, 160),
                         seed: int = 0, max_people: int = 3,
                         ) -> Tuple[str, str]:
    """Render ``n_images`` scenes (same distribution the trainer's
    synthetic stream and the e2e OKS gate use: SPREAD_TEMPLATE
    people on noisy background) and write them as a COCO dataset.

    Returns ``(json_path, img_dir)`` ready for
    ``train.py --coco-json <json> --img-dir <dir>``.
    """
    import cv2

    from tfpose_tpu_torch.utils import synthetic

    w, h = wh
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    ann_id = 1
    for idx in range(n_images):
        n = int(rng.integers(1, max_people + 1))
        people = synthetic.random_people(
            rng, n, h, w, template=synthetic.SPREAD_TEMPLATE)
        img = synthetic.render_image(people, h, w, rng)
        name = f"synth_{idx:06d}.png"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": idx, "file_name": name,
                       "width": w, "height": h})
        for person in people:
            kp, n_vis = person_to_coco17(person)
            xs = person[~np.isnan(person[:, 0]), 0]
            ys = person[~np.isnan(person[:, 1]), 1]
            bw = float(xs.max() - xs.min()) if xs.size else 1.0
            bh = float(ys.max() - ys.min()) if ys.size else 1.0
            annotations.append({
                "id": ann_id, "image_id": idx, "category_id": 1,
                "iscrowd": 0, "num_keypoints": n_vis,
                "keypoints": kp,
                "area": round(bw * bh, 2),
                "bbox": [round(float(xs.min()) if xs.size else 0, 2),
                         round(float(ys.min()) if ys.size else 0, 2),
                         round(bw, 2), round(bh, 2)],
            })
            ann_id += 1
    doc = {
        "info": {"description": "tfpose_tpu synthetic COCO export"},
        "images": images,
        "annotations": annotations,
        "categories": [{
            "id": 1, "name": "person", "supercategory": "person",
            "keypoints": COCO_KP_NAMES,
        }],
    }
    json_path = os.path.join(out_dir, "person_keypoints_synth.json")
    with open(json_path, "w") as f:
        json.dump(doc, f)
    return json_path, img_dir
