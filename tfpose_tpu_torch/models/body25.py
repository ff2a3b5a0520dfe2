"""OpenPose BODY_25 network (arXiv:1812.08008; openpose's
``models/pose/body_25/pose_deploy.prototxt``).

The VGG-19 stem it shares with CMU's network (conv1_1 .. conv4_1 with
ReLU, ``layers.VGG19_STEM``), then conv4_2 (512), conv4_3_CPM (256) and
conv4_4_CPM (128), each with a PReLU; then four PAF stages (``L2``,
``stage0`` .. ``stage3``) and two confidence-map stages (``L1``,
``stage0`` and ``stage1``). A stage is five blocks and two 1x1 convs: a
block ``Mconv{b}_stage{s}_L{l}_{0,1,2}`` is three chained 3x3 convs
(96 wide in stage 0, 128 after) whose three outputs are concatenated
and feed the next block; ``Mconv6`` (1x1; 256 in stage 0, 512 after)
and ``Mconv7`` (1x1; 52 PAF or 26 heat channels). Every conv but
``Mconv7`` is followed by a PReLU with a slope per channel.

Stage inputs: PAF stage 0 takes conv4_4_CPM; PAF stages 1-3 and heat
stage 0 take [conv4_4_CPM, PAF]; heat stage 1 takes [conv4_4_CPM, heat,
PAF]. The output ``concat_stage7`` is [heat (26), PAF (52)], NHWC at
stride 8, in the COCO networks' layout. Module names follow the
prototxt (a PReLU is the ``prelu`` child of its conv's module), so a
variables tree of ``conv``/``prelu`` leaves loads one to one.

Each PReLU conv runs without its bias, and K6 (``ops/kernels/
bias_prelu.py``) adds the bias and applies the PReLU in one pass, writing
a block's three outputs straight into their channel slices of the
block's concat buffer (and the first two also back into the conv output
that the next conv reads): no bias, PReLU or ``torch.cat`` pass of their
own. ``dtype`` and ``quant`` are as in :class:`CmuNetwork`.
"""

from __future__ import annotations

import torch
from torch import nn

from tfpose_tpu_torch.models.layers import (
    Conv,
    ConvPReLU,
    add_vgg19_stem,
    nhwc,
    set_compute_dtype,
    set_quant_mode,
    vgg19_stem,
)
from tfpose_tpu_torch.utils.profiling import span

# after the shared stem: the PReLU feature convs
_CPM = [("conv4_2", 512), ("conv4_3_CPM", 256), ("conv4_4_CPM", 128)]
_FEAT, _HEAT, _PAF = 128, 26, 52
# (branch, stages, output channels, first stage's input) in the order
# they run: the PAF stages first
_BRANCHES = (("L2", 4, _PAF), ("L1", 2, _HEAT))


def _stage_in(branch: str, s: int) -> int:
    if branch == "L2":
        return _FEAT if s == 0 else _FEAT + _PAF
    return _FEAT + _PAF if s == 0 else _FEAT + _HEAT + _PAF


def _width(s: int) -> int:
    return 96 if s == 0 else 128


class Body25Network(nn.Module):
    """BODY_25. Input NHWC in [-0.5, 0.5]; output ``{"concat_stage7":
    (N, H/8, W/8, 78)}``, heat then PAF, in ``self.dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 quant: str = "none"):
        super().__init__()
        ch = add_vgg19_stem(self)
        for name, out in _CPM:
            setattr(self, name, ConvPReLU(ch, out))
            ch = out
        for branch, stages, out in _BRANCHES:
            for s in range(stages):
                ch, width = _stage_in(branch, s), _width(s)
                for b in range(1, 6):
                    for i in range(3):
                        setattr(self, f"Mconv{b}_stage{s}_{branch}_{i}",
                                ConvPReLU(ch, width))
                        ch = width
                    ch = 3 * width
                wide = 256 if s == 0 else 512
                setattr(self, f"Mconv6_stage{s}_{branch}",
                        ConvPReLU(ch, wide, (1, 1)))
                setattr(self, f"Mconv7_stage{s}_{branch}",
                        Conv(wide, out, (1, 1), relu=False))
        # compute type (the parameters stay fp32) and quantisation mode
        set_compute_dtype(self, dtype)
        set_quant_mode(self, quant)

    def _block(self, x: torch.Tensor, name: str, width: int) -> torch.Tensor:
        """Three chained 3x3 convs, each written into its slice of one
        channels-last concat buffer; returns the buffer."""
        buf = None
        for i in range(3):
            layer = getattr(self, f"{name}_{i}")
            y = layer.conv(x, add_bias=False)
            if buf is None:
                n, _, h, w = y.shape
                buf = torch.empty((n, 3 * width, h, w), dtype=y.dtype,
                                  device=y.device,
                                  memory_format=torch.channels_last)
            outs = [buf[:, i * width:(i + 1) * width]]
            if i < 2:
                outs.insert(0, y)   # the next conv of the block reads y
            layer.bias_prelu(y, outs)
            x = y
        return buf

    def _stage(self, x: torch.Tensor, branch: str, s: int) -> torch.Tensor:
        for b in range(1, 6):
            x = self._block(x, f"Mconv{b}_stage{s}_{branch}", _width(s))
        x = getattr(self, f"Mconv6_stage{s}_{branch}")(x)
        return getattr(self, f"Mconv7_stage{s}_{branch}")(x)

    def forward(self, x: torch.Tensor) -> dict:
        """x: (N, H, W, 3) float -> {"concat_stage7": (N, H/8, W/8, 78)}."""
        with span("model.stem"):
            h = vgg19_stem(self, x.to(self.dtype).permute(0, 3, 1, 2))
            for name, _ in _CPM:
                h = getattr(self, name)(h)
            feat = h
        with span("model.stages"):
            paf = self._stage(feat, "L2", 0)
            for s in range(1, 4):
                paf = self._stage(torch.cat([feat, paf], 1), "L2", s)
            heat = self._stage(torch.cat([feat, paf], 1), "L1", 0)
            heat = self._stage(torch.cat([feat, heat, paf], 1), "L1", 1)
            out = torch.cat([heat, paf], 1)
        return {"concat_stage7": nhwc(out)}
