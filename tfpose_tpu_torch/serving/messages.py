"""Serving message types — port of ``tfpose_tpu/serving/messages.py``:
equivalents of the reference ROS messages (``msgs/BodyPartElm.msg``:
part_id/x/y/confidence, ``msgs/Person.msg``, ``msgs/Persons.msg`` with
header), JSON-serialisable for the TCP service in
:mod:`tfpose_tpu_torch.serving.service`. Field for field the JAX
package's, so the two packages' clients and servers interoperate, with
one addition: ``Persons.skeleton`` names the skeleton whose part ids the
message carries; it is written only where it is not COCO-18 (a JAX
client reads the message as it did), and a message without it is
COCO-18's."""

from __future__ import annotations

import dataclasses
import time
from typing import List

from tfpose_tpu_torch.core.topology import COCO18, Skeleton
from tfpose_tpu_torch.core.types import Human


@dataclasses.dataclass
class BodyPartElm:
    part_id: int
    x: float
    y: float
    confidence: float


@dataclasses.dataclass
class Person:
    body_part: List[BodyPartElm]


@dataclasses.dataclass
class Persons:
    persons: List[Person]
    image_w: int
    image_h: int
    header_stamp: float
    skeleton: str = COCO18.name

    def to_dict(self) -> dict:
        out = {
            "image_w": self.image_w,
            "image_h": self.image_h,
            "header": {"stamp": self.header_stamp},
            "persons": [
                {"body_part": [dataclasses.asdict(bp)
                               for bp in p.body_part]}
                for p in self.persons
            ],
        }
        if self.skeleton != COCO18.name:
            out["skeleton"] = self.skeleton
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Persons":
        return cls(
            persons=[Person([BodyPartElm(**bp)
                             for bp in p["body_part"]])
                     for p in d["persons"]],
            image_w=d["image_w"], image_h=d["image_h"],
            header_stamp=d["header"]["stamp"],
            skeleton=d.get("skeleton", COCO18.name))


def humans_to_msg(humans: List[Human], image_w: int, image_h: int,
                  skeleton: Skeleton = COCO18) -> Persons:
    """Reference ``broadcaster_ros.humans_to_msg`` semantics; the humans
    are of ``skeleton``'s parts."""
    persons = []
    for human in humans:
        parts = [BodyPartElm(part_id=bp.part_idx, x=bp.x, y=bp.y,
                             confidence=bp.score)
                 for bp in human.body_parts.values()]
        persons.append(Person(parts))
    return Persons(persons=persons, image_w=image_w, image_h=image_h,
                   header_stamp=time.time(), skeleton=skeleton.name)
