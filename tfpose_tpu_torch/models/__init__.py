from tfpose_tpu_torch.models.cmu import CmuNetwork
from tfpose_tpu_torch.models.mobilenet import MobilenetNetwork
from tfpose_tpu_torch.models.mobilenet_v2 import MobilenetV2Network
from tfpose_tpu_torch.models.registry import (
    MODEL_NAMES,
    get_checkpoint_path,
    get_network,
    model_wh,
)

__all__ = [
    "CmuNetwork", "MobilenetNetwork", "MobilenetV2Network",
    "MODEL_NAMES", "get_checkpoint_path",
    "get_network", "model_wh",
]
