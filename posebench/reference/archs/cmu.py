"""CMU's OpenPose network (arXiv:1611.08050): the VGG-19 prefix
(conv1_1 .. conv4_2) with the CPM feature convs (conv4_3_CPM,
conv4_4_CPM), a first two-branch stage of 3x3 and 1x1 convs and five
refinement stages of 7x7 convs, each with a bias and ReLU; COCO's 18
parts."""

from __future__ import annotations

from typing import List

import torch

from posebench.reference.models import Conv

SKELETON = "coco18"

NUM_STAGES = 6
# the VGG-19 prefix and CPM feature convs; "pool" is a 2x2 max-pool
_VGG = [("conv1_1", 64), ("conv1_2", 64), "pool",
        ("conv2_1", 128), ("conv2_2", 128), "pool",
        ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
        ("conv3_4", 256), "pool",
        ("conv4_1", 512), ("conv4_2", 512),
        ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
# heat (19) + PAF (38) channels that each stage after the first takes
_MAPS = 57


def convs() -> List[Conv]:
    out: List[Conv] = []
    ch = 3
    for layer in _VGG:
        if layer != "pool":
            out.append(Conv((layer[0], "conv"), 3, ch, layer[1], bias=True))
            ch = layer[1]
    for li, o in ((1, 38), (2, 19)):
        ch = 128
        for i in (1, 2, 3):
            out.append(Conv((f"conv5_{i}_CPM_L{li}", "conv"), 3, ch, 128,
                            bias=True))
            ch = 128
        out.append(Conv((f"conv5_4_CPM_L{li}", "conv"), 1, 128, 512,
                        bias=True))
        out.append(Conv((f"conv5_5_CPM_L{li}", "conv"), 1, 512, o,
                        bias=True))
        for s in range(2, NUM_STAGES + 1):
            ch = _MAPS + 128
            for i in range(1, 6):
                out.append(Conv((f"Mconv{i}_stage{s}_L{li}", "conv"), 7, ch,
                                128, bias=True))
                ch = 128
            out.append(Conv((f"Mconv6_stage{s}_L{li}", "conv"), 1, 128, 128,
                            bias=True))
            out.append(Conv((f"Mconv7_stage{s}_L{li}", "conv"), 1, 128, o,
                            bias=True))
    return out


def body(net, x: torch.Tensor) -> torch.Tensor:
    h = x
    for layer in _VGG:
        h = net.max_pool(h) if layer == "pool" else net.conv(
            h, (layer[0], "conv"))

    def branch(names, inp):
        for i, name in enumerate(names):
            inp = net.conv(inp, (name, "conv"), relu=i < len(names) - 1)
        return inp

    feat = h
    paf, heat = (branch([f"conv5_{i}_CPM_L{li}" for i in range(1, 6)], feat)
                 for li in (1, 2))
    for s in range(2, NUM_STAGES + 1):
        inp = torch.cat([paf, heat, feat], 1)
        paf, heat = (branch([f"Mconv{i}_stage{s}_L{li}" for i in range(1, 8)],
                            inp) for li in (1, 2))
    return torch.cat([heat, paf], 1)
