"""OpenPose BODY_25 (arXiv:1812.08008; ``models/pose/body_25/
pose_deploy.prototxt`` of CMU-Perceptual-Computing-Lab/openpose): the
VGG-19 prefix conv1_1 .. conv4_1 with ReLU, conv4_2, conv4_3_CPM (256)
and conv4_4_CPM (128) with PReLU, then four PAF stages (``L2``) and two
confidence-map stages (``L1``). A stage is five blocks and two 1x1
convs: a block is three chained 3x3 convs (96 wide in a branch's stage
0, 128 after) whose three outputs are concatenated; Mconv6 is 256 wide
in stage 0 and 512 after; Mconv7 gives 52 PAF or 26 heat channels.
Every conv but Mconv7 is followed by a PReLU with a slope per channel.
25 parts and a background; 26 limbs in OpenPose's map-index order.

Stage inputs: PAF stage 0 takes conv4_4_CPM; PAF stages 1-3 and heat
stage 0 take [conv4_4_CPM, PAF]; heat stage 1 takes [conv4_4_CPM, heat,
PAF]. The order of each concat, as the prototxt's bottoms list it, is
taken on trust (the configuration's ``assumed``)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from posebench.reference.models import Conv, Leaf

SKELETON = "body25"
LEAVES = {"prelu": Leaf("alpha", lambda c: (c.cout,), 0.25, "weight")}

# the VGG-19 prefix with ReLU ("pool": a 2x2 max-pool), then the PReLU
# feature convs
_VGG = [("conv1_1", 64), ("conv1_2", 64), "pool",
        ("conv2_1", 128), ("conv2_2", 128), "pool",
        ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
        ("conv3_4", 256), "pool",
        ("conv4_1", 512)]
_FEAT = [("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
HEAT, PAF, CPM = 26, 52, 128
# (branch, stages, outputs) in the order they run: PAF first
BRANCHES = (("L2", 4, PAF), ("L1", 2, HEAT))


def _stage_in(branch: str, s: int) -> int:
    if branch == "L2":
        return CPM if s == 0 else CPM + PAF
    return CPM + PAF if s == 0 else CPM + HEAT + PAF


def stage_convs(branch: str, s: int, out: int):
    """(name, kernel, cin, cout, PReLU) of one stage's convs, in order."""
    width = 96 if s == 0 else 128
    ch = _stage_in(branch, s)
    rows = []
    for b in range(1, 6):
        for i in range(3):
            rows.append((f"Mconv{b}_stage{s}_{branch}_{i}", 3, ch, width,
                         True))
            ch = width
        ch = 3 * width
    wide = 256 if s == 0 else 512
    rows.append((f"Mconv6_stage{s}_{branch}", 1, ch, wide, True))
    rows.append((f"Mconv7_stage{s}_{branch}", 1, wide, out, False))
    return rows


def convs() -> List[Conv]:
    out: List[Conv] = []
    ch = 3
    for layer in _VGG:
        if layer != "pool":
            out.append(Conv((layer[0], "conv"), 3, ch, layer[1], bias=True))
            ch = layer[1]
    for name, co in _FEAT:
        out.append(Conv((name, "conv"), 3, ch, co, bias=True,
                        leaves=("prelu",)))
        ch = co
    for branch, stages, o in BRANCHES:
        for s in range(stages):
            for name, k, ci, co, prelu in stage_convs(branch, s, o):
                out.append(Conv((name, "conv"), k, ci, co, bias=True,
                                leaves=("prelu",) if prelu else ()))
    return out


def _prelu(net, x: torch.Tensor, name: str) -> torch.Tensor:
    alpha = net.node((name, "prelu"))["alpha"]
    return F.prelu(x, alpha.to(x.dtype))


def _stage(net, x: torch.Tensor, branch: str, s: int, out: int
           ) -> torch.Tensor:
    rows = stage_convs(branch, s, out)
    for b in range(5):
        parts = []
        for name, _, _, _, _ in rows[3 * b:3 * b + 3]:
            x = _prelu(net, net.conv(x, (name, "conv"), relu=False), name)
            parts.append(x)
        x = torch.cat(parts, 1)
    name = rows[15][0]
    x = _prelu(net, net.conv(x, (name, "conv"), relu=False), name)
    return net.conv(x, (rows[16][0], "conv"), relu=False)


def body(net, x: torch.Tensor) -> torch.Tensor:
    h = x
    for layer in _VGG:
        h = net.max_pool(h) if layer == "pool" else net.conv(
            h, (layer[0], "conv"))
    for name, _ in _FEAT:
        h = _prelu(net, net.conv(h, (name, "conv"), relu=False), name)
    feat = h
    paf = _stage(net, feat, "L2", 0, PAF)
    for s in range(1, 4):
        paf = _stage(net, torch.cat([feat, paf], 1), "L2", s, PAF)
    heat = _stage(net, torch.cat([feat, paf], 1), "L1", 0, HEAT)
    heat = _stage(net, torch.cat([feat, heat, paf], 1), "L1", 1, HEAT)
    return torch.cat([heat, paf], 1)
