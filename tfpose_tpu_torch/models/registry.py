"""Model registry — port of ``tfpose_tpu/models/registry.py``
(reference ``tf_pose/networks.py``): ``get_network(name)``,
``model_wh('432x368')`` and checkpoint path resolution."""

from __future__ import annotations

import os
from typing import Tuple

from torch import nn

from tfpose_tpu_torch.models.cmu import CmuNetwork
from tfpose_tpu_torch.models.mobilenet import MobilenetNetwork
from tfpose_tpu_torch.models.mobilenet_v2 import MobilenetV2Network

MODEL_NAMES = (
    "cmu",
    "mobilenet",
    "mobilenet_thin",
    "mobilenet_v2_large",
    "mobilenet_v2_small",
)

_DEFAULT_MODEL_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "models")


def get_network(name: str) -> nn.Module:
    """Instantiate a backbone (fp32) by reference model name ("vgg" is
    an alias of "cmu")."""
    if name in ("cmu", "vgg"):
        return CmuNetwork()
    if name == "mobilenet":
        return MobilenetNetwork(conv_width=1.0, conv_width2=1.0)
    if name == "mobilenet_thin":
        return MobilenetNetwork(conv_width=0.75, conv_width2=0.50)
    if name == "mobilenet_v2_large":
        return MobilenetV2Network(conv_width=1.4, refine_width=1.0)
    if name == "mobilenet_v2_small":
        return MobilenetV2Network(conv_width=0.50, refine_width=0.50)
    raise ValueError(
        f"unknown model {name!r}; known: {', '.join(MODEL_NAMES)}")


def get_checkpoint_path(model_name: str, model_dir: str | None = None) -> str:
    """Path of the converted msgpack checkpoint for ``model_name``
    (models/jax/<name>/params.msgpack, as in the JAX package)."""
    base = model_dir or os.environ.get("TFPOSE_TPU_MODEL_DIR",
                                       _DEFAULT_MODEL_DIR)
    return os.path.join(base, "jax", model_name, "params.msgpack")


def model_wh(resolution_str: str) -> Tuple[int, int]:
    """Parse '432x368' -> (432, 368); '0x0' means dynamic (reference)."""
    width, height = map(int, resolution_str.split("x"))
    if width % 16 != 0 or height % 16 != 0:
        raise ValueError("width and height should be multiples of 16")
    return width, height
