"""Skeleton topology tables: the COCO 18-part body model and OpenPose's
BODY_25, each a :class:`Skeleton` that the decode, the ``Human`` API and
the drawing take.

The COCO tables are a copy of ``tfpose_tpu/core/topology.py`` (the port
imports nothing of the JAX package). It rebuilds the constant tables in
the reference (``tf_pose/common.py:~1-130`` — ``CocoPart``,
``CocoPairs``, ``CocoPairsNetwork``, ``CocoPairsRender``, ``CocoColors``,
``MPIIPart``) and the native decoder's pair tables
(``tf_pose/pafprocess/pafprocess.h`` — ``COCOPAIRS``, ``COCOPAIRS_NET``).
BODY_25's are OpenPose's (``src/openpose/pose/poseParameters.cpp``:
``POSE_BODY_25_BODY_PARTS``, ``POSE_BODY_25_PAIRS``,
``POSE_BODY_25_MAP_IDX``; ``poseParametersRender.hpp``: its render pairs
and colours).

Everything here is pure data; the decode path turns the numpy arrays
into index tensors on the device it runs on.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple, Type

import numpy as np

NUM_PARTS = 18  # body parts (Background = index 18 is channel-only)
NUM_HEATMAP_CH = 19  # 18 parts + background
NUM_PAF_CH = 38  # 19 limb pairs x (x, y)
NUM_PAIRS = 19
NUM_OUT_CH = NUM_HEATMAP_CH + NUM_PAF_CH  # 57: network emits [heat(19), paf(38)]


class CocoPart(enum.IntEnum):
    """Part indices of the 18-keypoint COCO body model (reference common.py)."""

    Nose = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    REye = 14
    LEye = 15
    REar = 16
    LEar = 17
    Background = 18


# 19 limb pairs (part-index pairs). The last two (ears<->shoulders) are used
# for assembly but not rendered, exactly as in the reference.
CocoPairs = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
)
CocoPairsRender = CocoPairs[:-2]

# PAF channel index pairs (x-channel, y-channel) into the 38-channel PAF
# block, one per limb pair, same order as CocoPairs (reference
# CocoPairsNetwork / pafprocess.h COCOPAIRS_NET).
CocoPairsNetwork = (
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (8, 9), (10, 11), (6, 7), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
)

CocoColors = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)


class MPIIPart(enum.IntEnum):
    """MPII 16-part model (reference common.MPIIPart)."""

    RAnkle = 0
    RKnee = 1
    RHip = 2
    LHip = 3
    LKnee = 4
    LAnkle = 5
    RWrist = 6
    RElbow = 7
    RShoulder = 8
    LShoulder = 9
    LElbow = 10
    LWrist = 11
    Neck = 12
    Head = 13


# (MPII part, COCO part) correspondence used by MPIIPart.from_coco in the
# reference; Head maps from Nose.
MPII_FROM_COCO = (
    (MPIIPart.Head, CocoPart.Nose),
    (MPIIPart.Neck, CocoPart.Neck),
    (MPIIPart.RShoulder, CocoPart.RShoulder),
    (MPIIPart.RElbow, CocoPart.RElbow),
    (MPIIPart.RWrist, CocoPart.RWrist),
    (MPIIPart.LShoulder, CocoPart.LShoulder),
    (MPIIPart.LElbow, CocoPart.LElbow),
    (MPIIPart.LWrist, CocoPart.LWrist),
    (MPIIPart.RHip, CocoPart.RHip),
    (MPIIPart.RKnee, CocoPart.RKnee),
    (MPIIPart.RAnkle, CocoPart.RAnkle),
    (MPIIPart.LHip, CocoPart.LHip),
    (MPIIPart.LKnee, CocoPart.LKnee),
    (MPIIPart.LAnkle, CocoPart.LAnkle),
)

# COCO-17 keypoint order used by the COCO dataset / eval json
# (reference eval.write_coco_json maps the 18-part model back to this).
COCO17_FROM_MODEL18 = (
    CocoPart.Nose, CocoPart.LEye, CocoPart.REye, CocoPart.LEar, CocoPart.REar,
    CocoPart.LShoulder, CocoPart.RShoulder, CocoPart.LElbow, CocoPart.RElbow,
    CocoPart.LWrist, CocoPart.RWrist, CocoPart.LHip, CocoPart.RHip,
    CocoPart.LKnee, CocoPart.RKnee, CocoPart.LAnkle, CocoPart.RAnkle,
)

# Left/right part swap table for horizontal flips (reference
# pose_augment.pose_flip).
FLIP_SWAP = (
    CocoPart.Nose, CocoPart.Neck, CocoPart.LShoulder, CocoPart.LElbow,
    CocoPart.LWrist, CocoPart.RShoulder, CocoPart.RElbow, CocoPart.RWrist,
    CocoPart.LHip, CocoPart.LKnee, CocoPart.LAnkle, CocoPart.RHip,
    CocoPart.RKnee, CocoPart.RAnkle, CocoPart.LEye, CocoPart.REye,
    CocoPart.LEar, CocoPart.REar,
)


def mpii_from_coco(human) -> list:
    """Convert a Human's COCO-18 parts to MPII order — reference
    ``MPIIPart.from_coco``: returns [(MPIIPart, BodyPart)] for the
    parts present."""
    out = []
    for mpii_part, coco_part in MPII_FROM_COCO:
        idx = int(coco_part)
        if idx in human.body_parts:
            out.append((mpii_part, human.body_parts[idx]))
    return out


def pairs_array() -> np.ndarray:
    """(19, 2) int32 array of part-index pairs."""
    return np.asarray(CocoPairs, dtype=np.int32)


def paf_channels_array() -> np.ndarray:
    """(19, 2) int32 array of (x, y) PAF channel indices."""
    return np.asarray(CocoPairsNetwork, dtype=np.int32)


def colors_array() -> np.ndarray:
    return np.asarray(CocoColors, dtype=np.uint8)


class Body25Part(enum.IntEnum):
    """Part indices of OpenPose's BODY_25 model (``POSE_BODY_25_BODY_PARTS``)."""

    Nose = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    MidHip = 8
    RHip = 9
    RKnee = 10
    RAnkle = 11
    LHip = 12
    LKnee = 13
    LAnkle = 14
    REye = 15
    LEye = 16
    REar = 17
    LEar = 18
    LBigToe = 19
    LSmallToe = 20
    LHeel = 21
    RBigToe = 22
    RSmallToe = 23
    RHeel = 24
    Background = 25


# 26 limbs in OpenPose's order; 18 and 19 (shoulder <-> ear) are redundant
Body25Pairs = (
    (1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9), (9, 10),
    (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15), (15, 17),
    (0, 16), (16, 18), (2, 17), (5, 18), (14, 19), (19, 20), (14, 21),
    (11, 22), (22, 23), (11, 24),
)
# each limb's (x, y) channels in the 52-channel PAF block
# (POSE_BODY_25_MAP_IDX less the 26 heat channels): not in limb order
Body25PairsNetwork = (
    (0, 1), (14, 15), (22, 23), (16, 17), (18, 19), (24, 25), (26, 27),
    (6, 7), (2, 3), (4, 5), (8, 9), (10, 11), (12, 13), (30, 31),
    (32, 33), (36, 37), (34, 35), (38, 39), (20, 21), (28, 29), (40, 41),
    (42, 43), (44, 45), (46, 47), (48, 49), (50, 51),
)
Body25PairsRender = Body25Pairs[:18] + Body25Pairs[20:]
Body25Colors = (
    (255, 0, 85), (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (255, 0, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255), (0, 0, 255),
    (255, 0, 170), (170, 0, 255), (255, 0, 255), (85, 0, 255), (0, 0, 255),
    (0, 0, 255), (0, 0, 255), (0, 255, 255), (0, 255, 255), (0, 255, 255),
)


@dataclasses.dataclass(frozen=True, eq=False)
class Skeleton:
    """A body model: its parts (``part``, an ``IntEnum`` whose last member
    is the background channel), the limbs in the decoder's order
    (``pairs``) with each limb's (x, y) channels in the PAF block
    (``paf_channels``), the two consecutive ``redundant`` limbs (each
    joins an ear to a shoulder: it joins two humans' parts but never
    starts one), and the render pairs and colours of the drawing. The
    network emits the heat channels (parts and background), then the PAF
    channels.

    The decode assembles humans by connected components, which equals
    the reference's sequential loop for a skeleton whose other limbs
    form a tree grown in order: the first limb's first part is the root,
    every later limb's first part has appeared before it and its second
    part has not; the redundant limbs' parts appear before them, and no
    later limb starts at a redundant limb's second part. The
    constructor checks this."""

    name: str
    part: Type[enum.IntEnum]
    pairs: Tuple[Tuple[int, int], ...]
    paf_channels: Tuple[Tuple[int, int], ...]
    redundant: Tuple[int, int]
    render_pairs: Tuple[Tuple[int, int], ...]
    colors: Tuple[Tuple[int, int, int], ...]

    def __post_init__(self):
        r0, r1 = self.redundant
        seen = {self.pairs[0][0]}
        ok = (r1 == r0 + 1 and 0 < r0 and r1 < self.num_pairs
              and len(self.paf_channels) == self.num_pairs
              and sorted(c for xy in self.paf_channels for c in xy)
              == list(range(self.paf_ch))
              and len(self.colors) >= max(self.num_parts,
                                          len(self.render_pairs))
              and self.part(self.num_parts).name == "Background")
        ears = {self.pairs[r0][1], self.pairs[r1][1]}
        for i, (a, b) in enumerate(self.pairs):
            if i in self.redundant:
                ok = ok and a in seen and b in seen
                continue
            ok = ok and a in seen and b not in seen and not (
                i > r1 and a in ears)
            seen.add(b)
        if not ok or seen != set(range(self.num_parts)):
            raise ValueError(f"skeleton {self.name}: its limbs are not a "
                             f"tree grown in order with two consecutive "
                             f"redundant limbs, or its tables disagree")

    @property
    def num_parts(self) -> int:
        return len(self.part) - 1

    @property
    def heat_ch(self) -> int:
        """Heat channels: the parts and the background."""
        return len(self.part)

    @property
    def num_pairs(self) -> int:
        return len(self.pairs)

    @property
    def paf_ch(self) -> int:
        return 2 * len(self.pairs)

    @property
    def out_ch(self) -> int:
        return self.heat_ch + self.paf_ch

    def index(self, name: str) -> int:
        """The index of the part called ``name`` (e.g. ``"REye"``)."""
        return int(self.part[name])

    def pairs_array(self) -> np.ndarray:
        """(limbs, 2) int32 array of part-index pairs."""
        return np.asarray(self.pairs, dtype=np.int32)

    def paf_channels_array(self) -> np.ndarray:
        """(limbs, 2) int32 array of (x, y) PAF channel indices."""
        return np.asarray(self.paf_channels, dtype=np.int32)

    def __reduce__(self):
        # unpickled (from a worker process) as the module's own instance
        return (skeleton_named, (self.name,))


COCO18 = Skeleton("coco18", CocoPart, CocoPairs, CocoPairsNetwork, (17, 18),
                  CocoPairsRender, CocoColors)
BODY25 = Skeleton("body25", Body25Part, Body25Pairs, Body25PairsNetwork,
                  (18, 19), Body25PairsRender, Body25Colors)
SKELETONS = {s.name: s for s in (COCO18, BODY25)}


def skeleton_named(name: str) -> Skeleton:
    """The skeleton called ``name`` (``"coco18"``, ``"body25"``)."""
    if name not in SKELETONS:
        raise ValueError(f"unknown skeleton {name!r}; known: "
                         f"{', '.join(SKELETONS)}")
    return SKELETONS[name]


def require_coco18(skeleton: Skeleton, what: str) -> None:
    """Raise for a skeleton other than COCO-18 where ``what`` knows only
    COCO's 18 parts (its labels, keypoint mapping or targets)."""
    if skeleton is not COCO18:
        raise NotImplementedError(
            f"{what} knows only the COCO-18 skeleton, not {skeleton.name}: "
            f"its labels and keypoint mapping are COCO's 18 parts")
