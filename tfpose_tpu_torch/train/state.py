"""Train state and train step — port of ``tfpose_tpu/train/state.py``
(reference ``tf_pose/train.py`` semantics: the stage-summed L2 loss,
Adam with a staircase exponential learning-rate decay).

The network lives on one device (the card unless the caller passes a CPU
network); a batch of numpy arrays goes to that device inside the step.
Semantics kept from flax and optax:

  * BatchNorm in training normalises with the biased batch variance and
    updates its running averages with it (``models/layers.py``);
  * Adam is written out as ``optax.adam`` computes it: b1 0.9, b2 0.999,
    eps 1e-8 (its defaults), ``mu = 0.1 g + 0.9 mu``, ``nu = 0.001 g^2 + 0.999 nu``,
    bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)``, scaled by the
    learning rate at the count *before* the step (step 1 uses ``lr``),
    ``lr * decay_rate ** floor(count / decay_steps)`` in fp32;
  * a uint8 image is normalised on the device (``/ 256 - 0.5``);
  * in a bf16 network the convs compute in bf16 while the parameters,
    the Adam moments, the BN statistics and the loss stay fp32;
  * cuDNN's TF32 is off for the forward and the backward.

On a mesh (``parallel/mesh.py``) every rank takes the same global batch,
keeps its block of it (``shard_batch``: its rows of the batch and, with
more than one spatial rank, of the image and targets), and runs the
step as JAX's sharded step computes it: BatchNorm's statistics over the
whole batch and image (summed over the ranks), each rank's loss its
block's stage-summed L2 divided by the global batch, the gradients and
metrics summed over the ranks, then the same Adam step on every rank,
which leaves the parameters, BN statistics and moments equal bit for
bit on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tfpose_tpu_torch.models.body25 import Body25Network
from tfpose_tpu_torch.parallel import halo
from tfpose_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    shard_batch,
    sharded,
    sum_metrics,
)
from tfpose_tpu_torch.train.loss import stage_l2_loss


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass
class Adam:
    """``optax.adam(exponential_decay(lr, decay_steps, decay_rate,
    staircase=True))``."""

    lr: float = 1e-4
    decay_rate: float = 0.33
    decay_steps: int = 10000

    def learning_rate(self, count: int) -> float:
        """The schedule at ``count`` steps taken, rounded to fp32."""
        if self.decay_steps <= 0 or count <= 0:
            return float(np.float32(self.lr))
        p = np.floor(np.float32(count) / np.float32(self.decay_steps))
        return float(np.float32(self.lr)
                     * np.power(np.float32(self.decay_rate), np.float32(p)))


def make_optimizer(lr: float = 1e-4, decay_rate: float = 0.33,
                   decay_steps: int = 10000) -> Adam:
    """Adam with exponential decay (reference train.py defaults)."""
    return Adam(lr, decay_rate, decay_steps)


@dataclasses.dataclass
class TrainState:
    """``step`` (steps taken), the network (its parameters and BN
    statistics), the optimizer and its moments, one per parameter;
    ``history`` holds what the trainer logged (step, loss, images/s)."""

    step: int
    net: nn.Module
    tx: Adam
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    @classmethod
    def create(cls, net: nn.Module, tx: Adam) -> "TrainState":
        mu = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
        nu = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
        return cls(step=0, net=net, tx=tx, mu=mu, nu=nu)

    def state_dict(self) -> Dict[str, Any]:
        """What ``torch.save`` keeps for ``--resume``."""
        return {"step": self.step, "net": self.net.state_dict(),
                "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.net.load_state_dict(sd["net"])
        for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            for k, v in theirs.items():
                mine[k].copy_(v)


def to_device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays (or tensors) -> tensors on ``device``; a uint8 image
    is normalised there (``/ 256 - 0.5``)."""
    out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                              device=device) for k, v in batch.items()}
    if out["image"].dtype == torch.uint8:
        out["image"] = out["image"].float() / 256.0 - 0.5
    return out


def batch_loss(net: nn.Module, batch: Dict[str, Any], rasterize: bool = False,
               sigma: float = 1.0, paf_threshold: float = 1.0,
               batch_size: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train-mode forward of ``batch`` and its stage-summed L2 loss,
    divided by ``batch_size`` (default: the batch's N).

    ``batch``: 'image' (N, H, W, 3) float or uint8, and either the
    targets 'heat' (N, H/8, W/8, 19) and 'paf' (N, H/8, W/8, 38) or, with
    ``rasterize``, NaN-padded 'joints' (N, P, 18, 2) at stride 8, made
    into targets on the device (``train/targets.py``; inside a
    row-sharded forward, this rank's rows of them)."""
    device = next(net.parameters()).device
    if isinstance(net, Body25Network):
        raise NotImplementedError(
            "BODY_25 has no training path: the targets and the stage loss "
            "are the COCO-18 networks' (25-part labels are not in the repo)")
    b = to_device_batch(batch, device)
    net.train()
    out = net(b["image"])
    if rasterize:
        from tfpose_tpu_torch.train.targets import batch_targets
        hs, ws = out["stages"][0][1].shape[1:3]
        t = batch_targets(b["joints"].float(), hs, ws, sigma=sigma,
                          threshold=paf_threshold, y0=halo.row_offset(ws))
        heat_gt, paf_gt = t["heat"], t["paf"]
    else:
        heat_gt, paf_gt = b["heat"].float(), b["paf"].float()
    return stage_l2_loss(out["stages"], paf_gt, heat_gt, batch_size)


def adam_update(state: TrainState) -> None:
    """One Adam step on the parameters' ``grad``, in place, with the
    learning rate of ``state.step`` (before it is incremented)."""
    names = [k for k, p in state.net.named_parameters() if p.grad is not None]
    params = dict(state.net.named_parameters())
    ps = [params[k] for k in names]
    grads = [params[k].grad for k in names]
    mu = [state.mu[k] for k in names]
    nu = [state.nu[k] for k in names]
    count = state.step + 1
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
    with torch.no_grad():
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - B1))
        torch._foreach_mul_(nu, B2)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1 - B2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -state.tx.learning_rate(state.step))
        torch._foreach_add_(ps, upd)


def make_train_step(rasterize: bool = False, sigma: float = 1.0,
                    paf_threshold: float = 1.0, mesh=None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    loss, its gradients and an Adam step, updating ``state`` (which
    carries the network and the optimizer) in place. ``batch`` as
    :func:`batch_loss` takes it; with ``mesh``, the global batch, of
    which each rank trains on its block (module docstring). The metrics
    are 0-dim tensors on the device (reading one waits for the step)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            state.net.zero_grad(set_to_none=True)
            if mesh is None:
                loss, metrics = batch_loss(state.net, batch, rasterize,
                                           sigma, paf_threshold)
            else:
                n, h, w = batch["image"].shape[:3]
                with sharded(mesh, image_hw=(h, w), stats=True):
                    loss, metrics = batch_loss(
                        state.net, shard_batch(mesh, batch), rasterize,
                        sigma, paf_threshold, batch_size=n)
            loss.backward()
        if mesh is not None:
            all_reduce_grads(mesh, list(state.net.parameters()))
            metrics = sum_metrics(mesh, metrics)
        adam_update(state)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def replica_tensors(state: TrainState) -> List[torch.Tensor]:
    """What must be equal on every rank of a mesh after a step: the
    parameters, the floating buffers (BN statistics), Adam's moments."""
    net = state.net
    return (list(net.parameters())
            + [b for b in net.buffers() if b.is_floating_point()]
            + [state.mu[k] for k in sorted(state.mu)]
            + [state.nu[k] for k in sorted(state.nu)])
