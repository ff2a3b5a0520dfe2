"""Post-training int8 quantisation: calibration and the int8 network.

Port of ``tfpose_tpu/models/quantize.py``. The int8 backbone is the fp32
network with every conv in mode ``"int8"`` (``models/layers.py``):
int8 x int8 products accumulated exactly in int32, a calibrated
per-tensor input scale and per-output-channel weight scales; BatchNorm
and the decode stay in floating point. Calibration runs the fp32
forward, one image at a time, and keeps each conv's largest |input| in
its ``in_absmax`` buffer, the flax ``quant`` collection's leaf.

Usage:
    net = get_network(name)            # fp32 weights loaded
    quantize_network(net, images)      # calibrate, then int8
    maps = net(normalize(x))["concat_stage7"]
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from tfpose_tpu_torch.convert.checkpoint import (
    variables_from_numpy,
    variables_to_numpy,
)
from tfpose_tpu_torch.models.layers import (
    SameConv2d,
    set_compute_dtype,
    set_quant_mode,
)
from tfpose_tpu_torch.models.registry import get_network
from tfpose_tpu_torch.pipeline.preprocess import normalize


def default_calibration_images(target_size, n: int = 8,
                               seed: int = 0) -> np.ndarray:
    """The JAX package's calibration set: ``n`` rendered scenes of 1-3
    separated people at the network input size ``target_size`` (w, h),
    from ``default_rng(seed)``. Returns (n, h, w, 3) uint8."""
    from tfpose_tpu_torch.utils import synthetic

    w, h = target_size
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(n):
        n_people = int(rng.integers(1, 4))
        people = synthetic.random_people(rng, n_people, h, w,
                                         separated=True)
        imgs.append(synthetic.render_image(people, h, w, rng))
    return np.stack(imgs)


def calibrate(net: nn.Module, images: np.ndarray) -> Dict[str, Any]:
    """Run ``net``'s fp32 forward over ``images`` (N, H, W, 3 uint8), one
    image at a time on the network's device, with cuDNN's TF32 off,
    recording each conv's input absmax from zero. Leaves every conv in
    mode ``"calib"`` with its ``in_absmax`` and the network in eval mode
    at its own compute type; returns the calibrated ``quant`` tree
    (numpy), as the JAX ``calibrate`` does."""
    device = next(net.parameters()).device
    dtype = net.dtype
    set_compute_dtype(net, torch.float32)  # JAX calibrates an fp32 net
    set_quant_mode(net, "calib")
    net.eval()
    cudnn = torch.backends.cudnn
    try:
        with torch.no_grad(), cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False):
            for mod in net.modules():
                if isinstance(mod, SameConv2d):
                    mod.in_absmax.zero_()
            for img in images:
                x = torch.as_tensor(np.ascontiguousarray(img[None]),
                                    device=device)
                net(normalize(x))
    finally:
        set_compute_dtype(net, dtype)
    return variables_to_numpy(net)["quant"]


def quantize_network(net: nn.Module, images: np.ndarray) -> nn.Module:
    """Calibrate ``net`` on ``images`` and switch it to int8, in place."""
    calibrate(net, images)
    return set_quant_mode(net, "int8")


def quantize_variables(model_name: str, variables: Dict[str, Any],
                       images: Optional[np.ndarray] = None,
                       target_size=(432, 368)) -> Dict[str, Any]:
    """The JAX package's API on numpy trees: an fp32 variables tree ->
    the same ``params`` / ``batch_stats`` plus a calibrated ``quant``
    collection, calibrated on the CPU (on the default rendered set at
    ``target_size`` when ``images`` is None)."""
    if images is None:
        images = default_calibration_images(target_size)
    net = variables_from_numpy(get_network(model_name), variables)
    out = dict(variables)
    out["quant"] = calibrate(net, images)
    return out
