"""Batched evaluation sweep — port of ``tfpose_tpu/evaluation/sweep.py``
(BASELINE.json config 5: "COCO keypoint eval sweep across the
backbones, bf16 batched inference").

Images are resized to the network size on the host (the port's area
resize, equal to cv2's ``INTER_AREA``), batched, and each batch runs the
backbone and :func:`decode_batch` on one device; detections come back
as padded arrays and become COCO keypoint dicts on the host.

With a ``mesh`` (``parallel/mesh.py``) every rank is given the same
images; each data rank runs its block of each batch through the
backbone and the decode, and the padded results are gathered over the
data ranks, so that every rank returns the single-device evaluator's
list, in the same order. With ``spatial`` the backbone also runs on row
blocks of the images (halo exchanges over the spatial ranks); the
stride-8 maps are gathered over the spatial group and the decode runs
on whole maps, replicated per image, as JAX's does.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.types import PoseArrays
from tfpose_tpu_torch.estimator import _DTYPES, run_backbone
from tfpose_tpu_torch.evaluation.coco_eval import (
    evaluate_oks_ap,
    humans_to_detections,
)
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.models.layers import init_weights
from tfpose_tpu_torch.ops.assemble import Assembled
from tfpose_tpu_torch.ops.decode import decode_batch
from tfpose_tpu_torch.parallel.halo import row_bounds
from tfpose_tpu_torch.parallel.mesh import (
    Mesh,
    gather_blocks,
    replicated,
    shard_batch,
    sharded,
)
from tfpose_tpu_torch.pipeline.preprocess import normalize, resize_u8

logger = logging.getLogger("tfpose_tpu_torch.sweep")


class BatchedEvaluator:
    """Runs one backbone over image batches on one device (the card by
    default; ``device="cpu"`` runs the kernels' plain versions), or on
    this rank of ``mesh`` (on the mesh's device; ``spatial`` also splits
    the image rows). Without :meth:`load_params` the network has the
    port's seeded random weights (``models/layers.py:init_weights``,
    seed 0)."""

    def __init__(self, model: str, target_size: Tuple[int, int],
                 batch_size: int = 8, dtype: str = "bfloat16",
                 upsample: float = 4.0, mesh: Optional[Mesh] = None,
                 params: DecodeParams = DecodeParams(),
                 spatial: bool = False, device: Optional[str] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a parallel.mesh.Mesh, got "
                             f"{type(mesh).__name__}")
        if spatial and mesh is None:
            raise ValueError("spatial sharding needs a mesh")
        if mesh is not None and device is not None:
            raise ValueError("a mesh names each rank's device; pass no "
                             "device")
        if mesh is not None and batch_size < mesh.n_data:
            raise ValueError(f"batch {batch_size} is smaller than the "
                             f"{mesh.n_data} data ranks")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.mesh, self.spatial = mesh, spatial
        if mesh is not None:
            device = mesh.device
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchedEvaluator runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run on the CPU")
        self.w, self.h = target_size
        self.batch = batch_size
        self.net = get_network(model, _DTYPES[dtype])
        init_weights(self.net, torch.Generator().manual_seed(0))
        self.net.eval().to(self.device)
        if mesh is not None:
            replicated(mesh, self.net)
        self.up = (int(self.h / 8 * upsample), int(self.w / 8 * upsample))
        self.decode_params = params
        # (B, 18) bool after each run_batch: peak-cap saturation per
        # image (same surfacing contract as TfPoseEstimator)
        self.last_peak_saturated = None
        self._warned_saturation = False

    def load_params(self, path: str):
        variables_from_numpy(self.net, load_flax_msgpack(path))
        if self.mesh is not None:
            replicated(self.mesh, self.net)

    def _decode_sharded(self, x: torch.Tensor) -> Assembled:
        """This rank's block of the batch through the backbone (on its
        rows, with ``spatial``) and the decode; the results of every
        data rank, gathered."""
        mesh = self.mesh
        n, h, w = x.shape[:3]
        spatial = self.spatial and mesh.n_spatial > 1
        with sharded(mesh, image_hw=(h, w) if spatial else None):
            maps = run_backbone(self.net, normalize(shard_batch(
                mesh, x, spatial_axis=1 if spatial else None)))
        if spatial:
            rows = row_bounds(-(-h // 8), mesh.n_spatial)
            maps = gather_blocks(maps, rows, mesh.spatial_index,
                                 mesh.spatial, dim=1)
        out = decode_batch(maps, *self.up, self.decode_params)
        blocks = row_bounds(n, mesh.n_data)
        return Assembled(*(gather_blocks(t, blocks, mesh.data_index,
                                         mesh.data) for t in out))

    def forward_decode(self, x: torch.Tensor) -> Assembled:
        """(B, H, W, 3) uint8 at the network size, on the device -> the
        backbone and the padded decode, on the device (one device)."""
        return decode_batch(run_backbone(self.net, normalize(x)),
                            *self.up, self.decode_params)

    def run_batch(self, imgs: np.ndarray) -> List[List]:
        """(B, H, W, 3) uint8 at the network size -> list of per-image
        Human lists (on a mesh, every rank is given the same batch and
        returns the whole list)."""
        x = torch.as_tensor(np.ascontiguousarray(imgs), device=self.device)
        if self.mesh is None:
            out = self.forward_decode(x)
        else:
            out = self._decode_sharded(x)
        arrays = Assembled(*(t.cpu().numpy() for t in out))
        self.last_peak_saturated = arrays.peak_saturated
        if arrays.peak_saturated.any() and not self._warned_saturation:
            logger.warning(
                "peak cap (max_peaks=%d) saturated — crowded batch, "
                "low-score peaks may have been dropped",
                self.decode_params.max_peaks)
            self._warned_saturation = True
        return [PoseArrays(
            coords=arrays.coords[i], scores=arrays.part_scores[i],
            part_valid=arrays.part_valid[i],
            human_scores=arrays.human_scores[i],
            human_valid=arrays.human_valid[i]).to_humans()
            for i in range(imgs.shape[0])]

    def evaluate(self, images: Iterable[Tuple[int, np.ndarray,
                                              Tuple[int, int]]]
                 ) -> List[dict]:
        """images: iterable of (image_id, uint8 HxWx3, (orig_w, orig_h));
        an image not at the network size is resized to it. The tail batch
        is padded with zero images whose results are dropped. Returns COCO
        detection dicts."""
        dets: List[dict] = []
        buf, meta = [], []
        for image_id, img, orig_wh in images:
            if img.shape[:2] != (self.h, self.w):
                img = resize_u8(torch.from_numpy(np.ascontiguousarray(img)),
                                self.h, self.w).numpy()
            buf.append(img)
            meta.append((image_id, orig_wh))
            if len(buf) == self.batch:
                self._flush(buf, meta, dets)
                buf, meta = [], []
        if buf:
            while len(buf) < self.batch:  # pad the tail batch
                buf.append(np.zeros_like(buf[0]))
                meta.append((None, (1, 1)))
            self._flush(buf, meta, dets)
        return dets

    def _flush(self, buf, meta, dets):
        results = self.run_batch(np.stack(buf))
        for humans, (image_id, (ow, oh)) in zip(results, meta):
            if image_id is None:
                continue
            dets.extend(humans_to_detections(humans, image_id, ow, oh))


def sweep(models: Sequence[str], images_fn, gts: Dict[int, List[dict]],
          target_size=(432, 368), batch_size: int = 8,
          mesh=None, device: Optional[str] = None
          ) -> Dict[str, Dict[str, float]]:
    """Evaluate several backbones; ``images_fn()`` returns a fresh
    image iterable per model. Returns {model: AP stats}."""
    out = {}
    for model in models:
        ev = BatchedEvaluator(model, target_size, batch_size, mesh=mesh,
                              device=device)
        dets = ev.evaluate(images_fn())
        out[model] = evaluate_oks_ap(gts, dets)
        logger.info("%s: %s", model, out[model])
    return out
