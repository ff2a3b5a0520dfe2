"""Training observability — port of ``tfpose_tpu/train/summaries.py``:
TensorBoard scalars + rendered sample predictions, matching the
reference trainer's summaries (``tf_pose/train.py:~110``: loss scalars
per stage + image grids of input / GT heatmap / predicted heatmap).

Backed by ``torch.utils.tensorboard``, imported inside
:func:`make_writer` only when a log directory is given; without one, or
without tensorboard, the writer is a no-op, so training never depends on
it.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("tfpose_tpu_torch.summaries")


class NullWriter:
    def scalar(self, *a, **k):
        pass

    def image(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class TensorboardWriter:
    """``scalar`` / ``image`` / ``flush`` / ``close``, the JAX package's
    writer interface, over ``torch.utils.tensorboard``."""

    def __init__(self, writer):
        self._w = writer

    def scalar(self, tag: str, value: float, step: int):
        self._w.add_scalar(tag, value, step)

    def image(self, tag: str, image: np.ndarray, step: int):
        self._w.add_image(tag, image, step, dataformats="HWC")

    def flush(self):
        self._w.flush()

    def close(self):
        self._w.close()


def make_writer(logdir: Optional[str]):
    """A TensorBoard writer for ``logdir``; NullWriter when logdir is
    falsy or tensorboard is not installed."""
    if not logdir:
        return NullWriter()
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:  # pragma: no cover - env-dependent
        logger.warning("tensorboard unavailable (%s); summaries off", e)
        return NullWriter()
    return TensorboardWriter(SummaryWriter(logdir))


def _colorize(plane: np.ndarray) -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 heat colormap (no matplotlib
    dependency inside the train loop)."""
    p = plane - plane.min()
    p = p / max(float(p.max()), 1e-6)
    r = np.clip(3.0 * p - 1.0, 0, 1)
    g = np.clip(3.0 * p - 0.5, 0, 1) - np.clip(3.0 * p - 2.0, 0, 1)
    b = np.clip(1.0 - 2.0 * p, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_scalars(writer, step: int, metrics: Dict[str, float]):
    for name, value in metrics.items():
        writer.scalar(name, float(value), step)


def write_prediction_panel(writer, step: int, image: np.ndarray,
                           heat_pred: np.ndarray,
                           heat_gt: Optional[np.ndarray] = None,
                           tag: str = "train/prediction"):
    """Reference-style rendered sample: input image beside the
    max-over-parts predicted heatmap (and GT heatmap when given).

    ``image``: (H, W, 3) float in [-0.5, 0.5] or [0, 1];
    ``heat_*``: (h, w, 19) stage outputs (background ch. excluded).
    """
    img = np.asarray(image, np.float32)
    img = img - img.min()
    img = (img / max(float(img.max()), 1e-6) * 255).astype(np.uint8)
    h, w = img.shape[:2]

    def amax_panel(heat):
        plane = np.asarray(heat, np.float32)[..., :18].max(axis=-1)
        # nearest-neighbour upsample to image size
        ry = max(h // plane.shape[0], 1)
        rx = max(w // plane.shape[1], 1)
        up = np.repeat(np.repeat(plane, ry, 0), rx, 1)[:h, :w]
        pad_y, pad_x = h - up.shape[0], w - up.shape[1]
        up = np.pad(up, ((0, pad_y), (0, pad_x)))
        return _colorize(up)

    panels = [img, amax_panel(heat_pred)]
    if heat_gt is not None:
        panels.append(amax_panel(heat_gt))
    writer.image(tag, np.concatenate(panels, axis=1), step)
