"""Building blocks for the pose backbones, as ``nn.Module``s.

Port of ``tfpose_tpu/models/layers.py`` (the reference layer DSL
``conv``, ``convb``, ``separable_conv``, ``max_pool``). Modules take and
return NCHW tensors; submodule names (``conv``/``bn``, ``depthwise``/
``dw_bn``/``pointwise``/``pw_bn``, ``L{1,2}_{1..5}``) are the flax names, so a
flax variables tree maps onto the state dict one to one
(``convert/checkpoint.py``).

Two numerical details are kept from flax:
  * padding is TF ``SAME``: a 3x3 stride-2 conv on an even input pads
    (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``, which would shift
    every map by one pixel; ``max_pool`` pads with -inf the same way;
  * BatchNorm uses eps 1e-3 and stays a separate op (inference uses the
    running statistics).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 1.0 - 0.997  # flax momentum 0.997 in torch's convention


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of TF/flax ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    top, bottom = same_pads(x.shape[-2], kernel[0], stride[0])
    left, right = same_pads(x.shape[-1], kernel[1], stride[1])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with TF ``SAME`` padding applied per input size:
    symmetric padding (stride 1, odd kernel) by the convolution itself,
    without a padded copy of the input; otherwise an explicit pad."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom = same_pads(x.shape[-2], self.kernel_size[0],
                                self.stride[0])
        left, right = same_pads(x.shape[-1], self.kernel_size[1],
                                self.stride[1])
        pad = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        return F.conv2d(x, self.weight, self.bias, self.stride, pad,
                        self.dilation, self.groups)


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Channel rounding used by the slim MobileNet defs."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class Conv(nn.Module):
    """plain conv + bias + (optional) ReLU — reference ``conv``."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_ch, features, kernel, strides, bias=True)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x) if self.relu else x


class ConvBN(nn.Module):
    """conv + BN + (optional) ReLU — reference ``convb``."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_ch, features, kernel, strides, bias=False)
        self.bn = batch_norm(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class SeparableConv(nn.Module):
    """depthwise conv + BN + ReLU + pointwise conv + BN + (ReLU) —
    reference ``separable_conv``."""

    def __init__(self, in_ch: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True):
        super().__init__()
        self.depthwise = SameConv2d(in_ch, in_ch, kernel, strides,
                                    groups=in_ch, bias=False)
        self.dw_bn = batch_norm(in_ch)
        self.pointwise = nn.Conv2d(in_ch, features, 1, bias=False)
        self.pw_bn = batch_norm(features)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dw_bn(self.depthwise(x)))
        x = self.pw_bn(self.pointwise(x))
        return F.relu(x) if self.relu else x


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H, W, C) view."""
    return t.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """SAME max-pool on NCHW (padding with -inf, as flax does)."""
    x = pad_same(x, (window, window), (stride, stride), value=-float("inf"))
    return F.max_pool2d(x, window, stride)


class CPMStage(nn.Module):
    """One two-branch refinement stage of separable convs —
    reference ``MConv_Stage{n}_L{1,2}_{1..5}`` (3x3 sep x3 at ``mid``,
    1x1 sep at ``mid2``, 1x1 sep to the output, last layer linear)."""

    def __init__(self, in_ch: int, out_l1: int, out_l2: int, mid: int,
                 mid2: int):
        super().__init__()
        for li, out_ch in ((1, out_l1), (2, out_l2)):
            ch = in_ch
            for i in (1, 2, 3):
                setattr(self, f"L{li}_{i}", SeparableConv(ch, mid, (3, 3)))
                ch = mid
            setattr(self, f"L{li}_4", SeparableConv(mid, mid2, (1, 1)))
            setattr(self, f"L{li}_5",
                    SeparableConv(mid2, out_ch, (1, 1), relu=False))

    def forward(self, x: torch.Tensor):
        outs = []
        for li in (1, 2):
            h = x
            for i in range(1, 6):
                h = getattr(self, f"L{li}_{i}")(h)
            outs.append(h)
        return outs[0], outs[1]  # (paf, heat)


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: conv kernels ~ N(0, 1/fan_in) (LeCun normal,
    untruncated), BN at identity (scale 1, bias 0, mean 0, var 1).
    Shape-correct weights for tests and benchmarks without a checkpoint;
    they do not reproduce flax's random bits."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=generator) / fan_in ** 0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
    return net
