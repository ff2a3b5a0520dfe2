"""Training loss — port of ``tfpose_tpu/train/loss.py`` (reference
``tf_pose/train.py``): the sum over the refinement stages and both
branches of ``tf.nn.l2_loss(out - target)`` (sum of squares / 2),
averaged over the batch, in fp32."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch


def stage_l2_loss(stages: List[Tuple[torch.Tensor, torch.Tensor]],
                  paf_gt: torch.Tensor, heat_gt: torch.Tensor,
                  batch: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``stages``: [(paf, heat)] per refinement stage, NHWC, any float
    type; ``paf_gt``: (N, H/8, W/8, 38); ``heat_gt``: (N, H/8, W/8, 19).
    ``batch`` divides the sums: the global batch when these are one
    rank's block of it (default N). Returns (loss, {"loss",
    "loss_last_paf", "loss_last_heat"})."""
    if batch is None:
        batch = paf_gt.shape[0]
    total = 0.0
    for paf, heat in stages:
        paf, heat = paf.float(), heat.float()
        total = total + torch.sum((paf - paf_gt) ** 2) / 2.0
        total = total + torch.sum((heat - heat_gt) ** 2) / 2.0
    total = total / batch
    metrics = {
        "loss": total,
        "loss_last_paf": torch.sum((paf - paf_gt) ** 2) / 2.0 / batch,
        "loss_last_heat": torch.sum((heat - heat_gt) ** 2) / 2.0 / batch,
    }
    return total, metrics
