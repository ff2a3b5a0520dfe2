"""MobileNet v1 pose networks (full-width and "thin").

Port of ``tfpose_tpu/models/mobilenet.py`` (reference
``tf_pose/network_mobilenet.py`` / ``network_mobilenet_thin.py``): a
depthwise-separable backbone with width multiplier ``conv_width``
(Conv2d_0 stride 2, then 11 separable convs, strides 2 at Conv2d_2/4 —
stride 8 overall), a pyramid feature concat (2x-pooled Conv2d_3 +
Conv2d_7 + Conv2d_11), and all-separable two-branch CPM refinement
stages at width ``conv_width2``. ``mobilenet_thin`` uses
conv_width=0.75 / conv_width2=0.50; ``mobilenet`` 1.0/1.0.

The public layout is the JAX package's: the input is NHWC and
``concat_stage7`` = concat(heat 19, paf 38) is NHWC at stride 8; inside,
the convs run NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from tfpose_tpu_torch.models.layers import (
    ConvBN,
    CPMStage,
    SeparableConv,
    max_pool,
    nhwc,
)

_MIN_DEPTH = 8
_SPEC = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
         (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1)]


class MobilenetNetwork(nn.Module):
    """MobileNet-v1-style two-branch pose network."""

    def __init__(self, conv_width: float = 0.75, conv_width2: float = 0.50,
                 num_stages: int = 6):
        super().__init__()

        def depth(ch):
            return max(int(ch * conv_width), _MIN_DEPTH)

        def depth2(ch):
            return max(int(ch * conv_width2), _MIN_DEPTH)

        self.num_stages = num_stages
        self.Conv2d_0 = ConvBN(3, depth(32), (3, 3), (2, 2))
        ch = depth(32)
        for i, (out, s) in enumerate(_SPEC, start=1):
            setattr(self, f"Conv2d_{i}",
                    SeparableConv(ch, depth(out), (3, 3), (s, s)))
            ch = depth(out)
        feat_ch = depth(128) + depth(512) + depth(512)
        for s in range(1, num_stages + 1):
            in_ch = feat_ch if s == 1 else 38 + 19 + feat_ch
            setattr(self, f"MConv_Stage{s}",
                    CPMStage(in_ch, 38, 19, depth2(128), depth2(512)))

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, H, W, 3) float -> {"concat_stage7": (N, H/8, W/8, 57),
        "stages": [(paf, heat), ...] NHWC}."""
        x = self.Conv2d_0(x.permute(0, 3, 1, 2))
        taps = {}
        for i in range(1, len(_SPEC) + 1):
            x = getattr(self, f"Conv2d_{i}")(x)
            taps[i] = x
        feat = torch.cat([max_pool(taps[3], 2, 2), taps[7], taps[11]], 1)
        h = feat
        stages = []
        for s in range(1, self.num_stages + 1):
            if s > 1:
                h = torch.cat([paf, heat, feat], 1)
            paf, heat = getattr(self, f"MConv_Stage{s}")(h)
            stages.append((paf, heat))
        out = torch.cat([heat, paf], 1)
        return {"concat_stage7": nhwc(out),
                "stages": [(nhwc(p), nhwc(q)) for p, q in stages]}
