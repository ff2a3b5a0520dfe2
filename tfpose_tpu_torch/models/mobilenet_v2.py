"""MobileNet v2 pose networks (large / small).

Port of ``tfpose_tpu/models/mobilenet_v2.py`` (reference
``tf_pose/network_mobilenet_v2.py`` with the slim V2_DEF): an
inverted-residual backbone tapped at the stride-8 endpoint (the last
32-channel block) and the stride-16 endpoint (the last 96-channel
block); the deeper tap is upsampled 2x (half-pixel bilinear) and
concatenated, then six all-separable two-branch CPM refinement stages.
``mobilenet_v2_large`` uses depth multiplier 1.4 and refine width 1.0,
``mobilenet_v2_small`` 0.50 and 0.50.

The public layout is the JAX package's: the input is NHWC and
``concat_stage7`` = concat(heat 19, paf 38) is NHWC at stride 8; inside,
the convs run NCHW. Submodule names are the flax names (``Conv``,
``Conv_bn``, ``expanded_conv_{i}/{expand,expand_bn,depthwise,dw_bn,
project,project_bn}``, ``MConv_Stage{s}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tfpose_tpu_torch.models.layers import (
    CPMStage,
    SameConv2d,
    batch_norm,
    make_divisible,
    nhwc,
)
from tfpose_tpu_torch.ops.resize import resize_bilinear

# V2_DEF inverted residual blocks: (expansion, channels, stride)
_V2_BLOCKS = [
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),               # stride 8
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),               # stride 16
]
_TAP_S8 = 5    # index into _V2_BLOCKS of the stride-8 tap
_TAP_S16 = 12  # the stride-16 tap


class InvertedResidual(nn.Module):
    """slim ``expanded_conv``: 1x1 expand + 3x3 depthwise (TF ``SAME``) +
    1x1 project, each with BN; ReLU6 after the first two; the residual
    when the stride is 1 and the channel counts match."""

    def __init__(self, in_ch: int, features: int, expansion: int,
                 stride: int):
        super().__init__()
        hidden = in_ch * expansion
        if expansion != 1:
            self.expand = nn.Conv2d(in_ch, hidden, 1, bias=False)
            self.expand_bn = batch_norm(hidden)
        self.depthwise = SameConv2d(hidden, hidden, 3, stride, groups=hidden,
                                    bias=False)
        self.dw_bn = batch_norm(hidden)
        self.project = nn.Conv2d(hidden, features, 1, bias=False)
        self.project_bn = batch_norm(features)
        self.expansion = expansion
        self.residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expansion != 1:
            h = F.relu6(self.expand_bn(self.expand(h)))
        h = F.relu6(self.dw_bn(self.depthwise(h)))
        h = self.project_bn(self.project(h))
        return h + x if self.residual else h


class MobilenetV2Network(nn.Module):
    """MobileNet-v2 two-branch pose network."""

    def __init__(self, conv_width: float = 1.4, refine_width: float = 1.0,
                 num_stages: int = 6):
        super().__init__()

        def dm(ch: int) -> int:  # slim: multiplier with make_divisible
            return make_divisible(ch * conv_width, 8)

        def depth2(ch: int) -> int:
            return max(int(ch * refine_width), 8)

        self.num_stages = num_stages
        self.Conv = SameConv2d(3, dm(32), 3, 2, bias=False)
        self.Conv_bn = batch_norm(dm(32))
        ch = dm(32)
        for i, (t, c, s) in enumerate(_V2_BLOCKS):
            setattr(self, f"expanded_conv_{i}",
                    InvertedResidual(ch, dm(c), t, s))
            ch = dm(c)
        feat_ch = dm(_V2_BLOCKS[_TAP_S8][1]) + dm(_V2_BLOCKS[_TAP_S16][1])
        for s in range(1, num_stages + 1):
            in_ch = feat_ch if s == 1 else 38 + 19 + feat_ch
            setattr(self, f"MConv_Stage{s}",
                    CPMStage(in_ch, 38, 19, depth2(128), depth2(512)))

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, H, W, 3) float -> {"concat_stage7": (N, H/8, W/8, 57),
        "stages": [(paf, heat), ...] NHWC}."""
        h = F.relu6(self.Conv_bn(self.Conv(x.permute(0, 3, 1, 2))))
        for i in range(len(_V2_BLOCKS)):
            h = getattr(self, f"expanded_conv_{i}")(h)
            if i == _TAP_S8:
                tap8 = h
        # the half-pixel bilinear 2x of the stride-16 tap, on NHWC
        up = resize_bilinear(nhwc(h), tap8.shape[2], tap8.shape[3])
        feat = torch.cat([tap8, up.permute(0, 3, 1, 2)], 1)
        g = feat
        stages = []
        for s in range(1, self.num_stages + 1):
            if s > 1:
                g = torch.cat([paf, heat, feat], 1)
            paf, heat = getattr(self, f"MConv_Stage{s}")(g)
            stages.append((paf, heat))
        out = torch.cat([heat, paf], 1)
        return {"concat_stage7": nhwc(out),
                "stages": [(nhwc(p), nhwc(q)) for p, q in stages]}
