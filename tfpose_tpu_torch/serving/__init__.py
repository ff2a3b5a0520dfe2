from tfpose_tpu_torch.serving.messages import (
    BodyPartElm,
    Person,
    Persons,
    humans_to_msg,
)
from tfpose_tpu_torch.serving.batcher import DynamicBatcher
from tfpose_tpu_torch.serving.service import PoseClient, PoseService

__all__ = ["BodyPartElm", "Person", "Persons", "humans_to_msg",
           "PoseClient", "PoseService", "DynamicBatcher"]
