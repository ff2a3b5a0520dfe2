"""One-shot convenience API — port of ``tfpose_tpu/runner.py``
(reference ``tf_pose/runner.py``): ``infer(image, model, resize,
resize_out_ratio)`` plus a cached estimator factory.

A file path is read with ``utils/imload.py:read_imgfile``, which needs
cv2 (absent on the card machine: there, pass the decoded array).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from tfpose_tpu_torch.core.types import Human
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import model_wh
from tfpose_tpu_torch.utils.imload import read_imgfile

_estimators = {}


def get_estimator(model: str = "mobilenet_thin", resize: str = "0x0",
                  device: Optional[str] = None) -> TfPoseEstimator:
    """Cached estimator factory (reference ``get_estimator``): one
    estimator per model, size and device; ``0x0`` means 432x368."""
    w, h = model_wh(resize)
    if w == 0 or h == 0:
        w, h = 432, 368
    key = (model, w, h, device)
    if key not in _estimators:
        _estimators[key] = TfPoseEstimator(model, target_size=(w, h),
                                           device=device)
    return _estimators[key]


def infer(image: Union[str, np.ndarray], model: str = "mobilenet_thin",
          resize: str = "0x0", resize_out_ratio: float = 4.0,
          device: Optional[str] = None) -> List[Human]:
    """Estimate poses on one image, a path or an (H, W, 3) uint8 BGR
    array — reference ``tf_pose.runner.infer``. Reading a path needs
    cv2 (``RuntimeError`` without it)."""
    if isinstance(image, str):
        image = read_imgfile(image, None, None)
    if image is None:
        raise Exception("Image can not be read.")
    e = get_estimator(model, resize, device)
    return e.inference(image, resize_to_default=True,
                       upsample_size=resize_out_ratio)


Estimator = TfPoseEstimator
