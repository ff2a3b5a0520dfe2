"""mobilenet_thin (ildoonet/tf-pose-estimation,
``network_mobilenet_thin.py``): a MobileNet v1 backbone at width 0.75
with BatchNorm, its features at stride 8 (Conv2d_3 max-pooled, Conv2d_7
and Conv2d_11 concatenated), and six two-branch stages of separable
convolutions at width 0.5; COCO's 18 parts."""

from __future__ import annotations

from typing import List

import torch

from posebench.reference.models import Conv

SKELETON = "coco18"

NUM_STAGES = 6
# conv_width 0.75, conv_width2 0.5, depths at least 8
_BACKBONE = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1)]
# heat (19) + PAF (38) channels that each stage after the first takes
_MAPS = 57


def _depth(ch: int) -> int:
    return max(int(ch * 0.75), 8)


def _depth2(ch: int) -> int:
    return max(int(ch * 0.5), 8)


def _separable(path, k, cin, cout, stride=1) -> List[Conv]:
    return [Conv(path + ("depthwise",), k, cin, cin, stride, True,
                 bn="dw_bn"),
            Conv(path + ("pointwise",), 1, cin, cout, bn="pw_bn")]


def _stage_branches(s: int, in_ch: int):
    mid, mid2 = _depth2(128), _depth2(512)
    for li, out in ((1, 38), (2, 19)):
        ch, convs = in_ch, []
        for i, (k, o) in enumerate(((3, mid), (3, mid), (3, mid),
                                    (1, mid2), (1, out)), start=1):
            convs.append(((f"MConv_Stage{s}", f"L{li}_{i}"), k, ch, o))
            ch = o
        yield convs


def _feat_ch() -> int:
    return _depth(128) + _depth(512) + _depth(512)


def convs() -> List[Conv]:
    out = [Conv(("Conv2d_0", "conv"), 3, 3, _depth(32), 2, bn="bn")]
    ch = _depth(32)
    for i, (o, s) in enumerate(_BACKBONE, start=1):
        out += _separable((f"Conv2d_{i}",), 3, ch, _depth(o), s)
        ch = _depth(o)
    for s in range(1, NUM_STAGES + 1):
        in_ch = _feat_ch() + (0 if s == 1 else _MAPS)
        for branch in _stage_branches(s, in_ch):
            for path, k, ci, co in branch:
                out += _separable(path, k, ci, co)
    return out


def body(net, x: torch.Tensor) -> torch.Tensor:
    x = net.conv(x, ("Conv2d_0", "conv"), 2, bn="bn")
    taps = {}
    for i, (_, s) in enumerate(_BACKBONE, start=1):
        x = net.separable(x, (f"Conv2d_{i}",), s)
        taps[i] = x
    feat = torch.cat([net.max_pool(taps[3]), taps[7], taps[11]], 1)
    h = feat
    for s in range(1, NUM_STAGES + 1):
        if s > 1:
            h = torch.cat([paf, heat, feat], 1)
        branches = []
        for branch in _stage_branches(s, h.shape[1]):
            b = h
            for i, (path, k, _, _) in enumerate(branch):
                b = net.separable(b, path, relu=i < 4)
            branches.append(b)
        paf, heat = branches
    return torch.cat([heat, paf], 1)
