from tfpose_tpu_torch.models.body25 import Body25Network
from tfpose_tpu_torch.models.cmu import CmuNetwork
from tfpose_tpu_torch.models.mobilenet import MobilenetNetwork
from tfpose_tpu_torch.models.mobilenet_v2 import MobilenetV2Network
from tfpose_tpu_torch.models.registry import (
    MODEL_NAMES,
    get_checkpoint_path,
    get_network,
    model_wh,
    skeleton_of,
)

__all__ = [
    "Body25Network", "CmuNetwork", "MobilenetNetwork", "MobilenetV2Network",
    "MODEL_NAMES", "get_checkpoint_path",
    "get_network", "model_wh", "skeleton_of",
]
