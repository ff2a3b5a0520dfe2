"""Training targets rasterised on the device.

Port of ``tfpose_tpu/train/targets_jax.py``: PyTorch versions of the
NumPy target builders (``train/dataset.py`` ``get_heatmap`` /
``get_vectormap``), so that the host ships (people, 18, 2) joint
coordinates instead of rasterised planes (``train --device-targets``).
``joints`` is NaN-padded: a missing part, or a padding person, is NaN.
"""

from __future__ import annotations

from typing import Dict

import torch

from tfpose_tpu_torch.core.topology import (
    NUM_PAF_CH,
    paf_channels_array,
    pairs_array,
)


def _grid(h: int, w: int, device, y0: int = 0):
    yy = torch.arange(y0, y0 + h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return yy, xx


def _heat(joints: torch.Tensor, h: int, w: int, sigma: float,
          y0: int = 0) -> torch.Tensor:
    """(N, P, 18, 2) -> (N, h, w, 19): rows y0 .. y0 + h - 1."""
    yy, xx = _grid(h, w, joints.device, y0)
    px, py = joints[..., 0], joints[..., 1]                  # (N, P, 18)
    valid = torch.isfinite(px)
    px = torch.where(valid, px, torch.full_like(px, -1e6))
    py = torch.where(valid, py, torch.full_like(py, -1e6))
    d2 = ((xx - px[..., None, None]) ** 2
          + (yy - py[..., None, None]) ** 2)                 # (N, P, 18, h, w)
    g = torch.exp(-d2 / (sigma ** 2))
    g = torch.where(valid[..., None, None], g, torch.zeros((), device=g.device))
    if g.shape[1]:
        parts = torch.clamp(g.amax(dim=1), 0.0, 1.0)          # (N, 18, h, w)
    else:
        parts = g.new_zeros((g.shape[0], joints.shape[2], h, w))
    bg = 1.0 - parts.amax(dim=1, keepdim=True)
    return torch.cat([parts, bg], 1).permute(0, 2, 3, 1)


def _paf(joints: torch.Tensor, h: int, w: int,
         threshold: float, y0: int = 0) -> torch.Tensor:
    """(N, P, 18, 2) -> (N, h, w, 38): rows y0 .. y0 + h - 1."""
    dev = joints.device
    pairs = torch.as_tensor(pairs_array(), device=dev)
    yy, xx = _grid(h, w, dev, y0)
    a = joints[:, :, pairs[:, 0], :]                         # (N, P, 19, 2)
    b = joints[:, :, pairs[:, 1], :]
    valid = torch.isfinite(a[..., 0]) & torch.isfinite(b[..., 0])
    a, b = torch.nan_to_num(a), torch.nan_to_num(b)
    d = b - a
    norm = torch.sqrt((d ** 2).sum(-1))
    ok = valid & (norm > 1e-6)
    nclip = torch.clamp(norm, min=1e-6)
    v = d / nclip[..., None]
    rel_x = xx - a[..., 0][..., None, None]                  # (N, P, 19, h, w)
    rel_y = yy - a[..., 1][..., None, None]
    t = (rel_x * v[..., 0][..., None, None]
         + rel_y * v[..., 1][..., None, None]) / nclip[..., None, None]
    t = torch.clamp(t, 0.0, 1.0)
    dist = torch.sqrt((rel_x - t * d[..., 0][..., None, None]) ** 2
                      + (rel_y - t * d[..., 1][..., None, None]) ** 2)
    mask = (dist <= threshold) & ok[..., None, None]
    zero = torch.zeros((), device=dev)
    vx = torch.where(mask, v[..., 0][..., None, None], zero).sum(1)
    vy = torch.where(mask, v[..., 1][..., None, None], zero).sum(1)
    cnt = torch.clamp(mask.sum(1), min=1).float()            # (N, 19, h, w)
    out = torch.zeros((joints.shape[0], NUM_PAF_CH, h, w), device=dev)
    pc = torch.as_tensor(paf_channels_array(), device=dev)
    out[:, pc[:, 0]] = vx / cnt
    out[:, pc[:, 1]] = vy / cnt
    return out.permute(0, 2, 3, 1)


def heatmap_targets(joints: torch.Tensor, h: int, w: int,
                    sigma: float = 1.0) -> torch.Tensor:
    """(P, 18, 2) pixel coords (NaN = missing) -> (h, w, 19) heatmaps:
    exp(-d^2 / sigma^2) per part, max over people, background 1 - max."""
    return _heat(joints[None], h, w, sigma)[0]


def paf_targets(joints: torch.Tensor, h: int, w: int,
                threshold: float = 1.0) -> torch.Tensor:
    """(P, 18, 2) -> (h, w, 38) count-normalised PAF targets: a limb's
    unit vector at every cell within ``threshold`` of its segment."""
    return _paf(joints[None], h, w, threshold)[0]


def batch_targets(joints_batch: torch.Tensor, h: int, w: int,
                  sigma: float = 1.0, threshold: float = 1.0, y0: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """(N, P, 18, 2) -> {"heat": (N, h, w, 19), "paf": (N, h, w, 38)},
    the whole batch in one set of ops; ``y0`` > 0 gives the rows
    ``y0 .. y0 + h - 1`` of taller maps (one rank's block of a row-sharded
    batch: every cell depends on its own coordinates alone)."""
    return {"heat": _heat(joints_batch, h, w, sigma, y0),
            "paf": _paf(joints_batch, h, w, threshold, y0)}
