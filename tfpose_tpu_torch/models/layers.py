"""Building blocks for the pose backbones, as ``nn.Module``s.

Port of ``tfpose_tpu/models/layers.py`` (the reference layer DSL
``conv``, ``convb``, ``separable_conv``, ``max_pool``). Modules take and
return NCHW tensors; submodule names (``conv``/``bn``, ``depthwise``/
``dw_bn``/``pointwise``/``pw_bn``, ``L{1,2}_{1..5}``) are the flax names, so a
flax variables tree maps onto the state dict one to one
(``convert/checkpoint.py``).

Numerical details kept from flax:
  * padding is TF ``SAME``: a 3x3 stride-2 conv on an even input pads
    (0, 1), not the (1, 1) of ``nn.Conv2d(padding=1)``, which would shift
    every map by one pixel; ``max_pool`` pads with -inf the same way;
  * BatchNorm uses eps 1e-3 and stays a separate op (inference uses the
    running statistics);
  * the compute type is the input's: a network casts its input to its
    ``dtype`` and every layer follows it, while the parameters stay
    fp32. In bf16 a conv rounds as flax's ``nn.Conv(dtype=bf16)`` does
    (input and kernel in bf16, the product rounded to bf16, then the bias
    added in bf16), and BatchNorm as ``nn.BatchNorm(dtype=bf16)`` does
    (flax subtracts the fp32 running mean from the bf16 input, so the
    normalisation runs in fp32 and rounds to bf16 once: PyTorch's
    mixed-type batch norm, bf16 input with fp32 statistics);
  * in training BatchNorm normalises with the biased batch variance
    E[x^2] - E[x]^2 computed in fp32 (flax's ``use_fast_variance``) and
    moves its running averages by 0.997 toward the batch mean and that
    same biased variance, where ``nn.BatchNorm2d`` would store the
    unbiased one.

Quantisation (``QUANT_MODES``, the JAX package's ``QuantConv``): a conv
in mode ``"calib"`` computes in fp32 and records the largest |input| in
its ``in_absmax`` buffer (the flax ``quant`` collection's leaf of the
same path); in mode ``"int8"`` it quantises its fp32 input with that
scale and its weights per output channel, accumulates the int8 products
exactly in int32 (:func:`int_conv2d`) and rescales in fp32. The
parameter names stay those of the fp32 tree.

Sharding (``parallel/halo.py``): inside ``halo.use`` with row shards, a
conv or max-pool whose window spans rows first fetches its neighbours'
halo rows and pads ``SAME`` only at the image's true top and bottom
edge; with a statistics group, BatchNorm in training sums its moments
over the ranks. Outside that context, the default, every layer runs as
on one device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tfpose_tpu_torch.parallel import halo

BN_EPS = 1e-3
FLAX_MOMENTUM = 0.997
BN_MOMENTUM = 1.0 - FLAX_MOMENTUM  # flax's momentum in torch's convention


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


QUANT_MODES = ("none", "calib", "int8")
# JAX computes ``max(absmax, eps) / 127.0``; XLA folds a division by a
# constant into a product with its fp32 reciprocal, and so does the port
_INV_127 = float(np.float32(1) / np.float32(127))


def quantize_input(x: torch.Tensor, absmax: torch.Tensor):
    """fp32 activations and their calibrated absmax -> (int8 values,
    fp32 scale): ``round_half_even(x / s)`` clipped to +-127 with
    ``s = max(absmax, 1e-6) / 127``, a true division by a tensor on every
    device (PyTorch on the card divides by a host scalar as a product
    with its reciprocal)."""
    s = torch.clamp(absmax, min=1e-6) * _INV_127
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q, s


def quantize_weight(w: torch.Tensor):
    """(O, I, kh, kw) fp32 kernel -> (int8 values, (O,) fp32 scales),
    per output channel: ``s_w = max(|w|, 1e-8) / 127`` over I, kh, kw."""
    s = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8) * _INV_127
    q = torch.clamp(torch.round(w / s[:, None, None, None]), -127, 127)
    return q.to(torch.int8), s


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def int_conv2d(xq: torch.Tensor, wq: torch.Tensor,
               stride: Tuple[int, int], groups: int = 1) -> torch.Tensor:
    """Exact int32 accumulators of an int8 convolution: ``xq`` (N, C, H,
    W) int8, already padded; ``wq`` (O, C / groups, kh, kw) int8. Every
    product and sum is an integer operation, so the result is the same on
    every device and in every order (|sum| <= K * 127^2 < 2^31 for
    K = kh * kw * C < 133,000).

    A dense conv is one int8 x int8 -> int32 matrix product
    (``torch._int_mm``) of the im2col rows (N * Ho * Wo, kh * kw * C)
    with the (O, kh * kw * C) kernel, K and O zero-padded to multiples of
    8 and the rows to at least 17, as the card's int8 GEMM requires; a
    depthwise conv (groups = C = O) sums its kh * kw taps in int32."""
    n, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    sh, sw = stride
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    if groups != 1:
        if not groups == c == o or wq.shape[1] != 1:
            raise ValueError("int_conv2d: grouped convs must be depthwise")
        taps = xq.unfold(2, kh, sh).unfold(3, kw, sw)   # N, C, Ho, Wo, kh, kw
        prod = taps.to(torch.int32) * wq.reshape(1, c, 1, 1, kh, kw).to(
            torch.int32)
        return prod.sum(dim=(4, 5), dtype=torch.int32)
    x = xq.permute(0, 2, 3, 1)                             # N, H, W, C
    if kh == kw == 1:
        cols = x[:, ::sh, ::sw].reshape(n * ho * wo, c)
    else:
        cols = x.unfold(1, kh, sh).unfold(2, kw, sw)    # N, Ho, Wo, C, kh, kw
        cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, kh * kw * c)
    k = kh * kw * c
    m = n * ho * wo
    kp, op, mp = _pad8(k), _pad8(o), max(m, 17)
    if (kp, mp) != (k, m):
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    wmat = F.pad(wq.permute(0, 2, 3, 1).reshape(o, k), (0, kp - k, 0, op - o))
    acc = torch._int_mm(cols.contiguous(), wmat.t())       # (mp, op) int32
    return acc[:m, :o].reshape(n, ho, wo, o).permute(0, 3, 1, 2)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with TF ``SAME`` padding applied per input size:
    symmetric padding (stride 1, odd kernel) by the convolution itself,
    without a padded copy of the input; otherwise an explicit pad. It
    computes in its input's type, with the fp32 weights cast to it.

    ``quant`` (set by :func:`set_quant_mode`) is the JAX ``QuantConv``'s
    mode: ``"calib"`` and ``"int8"`` upcast the input to fp32 and return
    fp32; ``"calib"`` keeps the running max of |input| in ``in_absmax``,
    ``"int8"`` computes with it as the module docstring says."""

    quant = "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = halo.current_rows()
        if rows is not None and (self.kernel_size[0] > 1
                                 or self.stride[0] > 1):
            return self._forward_rows(x, rows)
        top, bottom = same_pads(x.shape[-2], self.kernel_size[0],
                                self.stride[0])
        left, right = same_pads(x.shape[-1], self.kernel_size[1],
                                self.stride[1])
        if self.quant == "int8":
            xq, s_in = quantize_input(x.float(), self.in_absmax)
            wq, s_w = quantize_weight(self.weight)
            acc = int_conv2d(F.pad(xq, (left, right, top, bottom)), wq,
                             self.stride, self.groups)
            y = acc.float() * (s_in * s_w)[:, None, None]
            return y if self.bias is None else y + self.bias[:, None, None]
        pad = (top, left)
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        if self.quant == "calib":
            x = x.float()
            with torch.no_grad():
                torch.maximum(self.in_absmax, x.abs().amax(),
                              out=self.in_absmax)
        return self._conv(x, pad)

    def _forward_rows(self, x: torch.Tensor, rows: "halo.RowShard"
                      ) -> torch.Tensor:
        """This rank's block of output rows: the input rows its windows
        read (halos of the neighbours, ``SAME`` zeros at the image's
        edges), then the conv without vertical padding."""
        if self.quant != "none":
            raise ValueError(f"quant={self.quant!r} does not run "
                             f"row-sharded")
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if sh != sw:
            raise ValueError("a row-sharded conv needs equal strides")
        h = rows.rows_at(x.shape[-1])
        x = halo.window(x, rows, 2, h, kh, sh, same_pads(h, kh, sh)[0], 0.0)
        left, right = same_pads(x.shape[-1], kw, sw)
        if left != right:
            return self._conv(F.pad(x, (left, right, 0, 0)), 0)
        return self._conv(x, (0, left))

    def _conv(self, x: torch.Tensor, pad) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.conv2d(x, self.weight, self.bias, self.stride, pad,
                            self.dilation, self.groups)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, pad,
                     self.dilation, self.groups)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype)[:, None, None]


def set_quant_mode(net: nn.Module, mode: str) -> nn.Module:
    """Put every conv of ``net`` in quantisation mode ``mode`` (one of
    ``QUANT_MODES``). Leaving ``"none"`` gives each conv a zero
    ``in_absmax`` buffer (kept if it has one); ``"none"`` removes them, so
    the state dict is the fp32 tree's again."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {mode!r}")
    for mod in net.modules():
        if not isinstance(mod, SameConv2d):
            continue
        has = "in_absmax" in mod._buffers
        if mode == "none" and has:
            del mod.in_absmax
        elif mode != "none" and not has:
            mod.register_buffer("in_absmax", torch.zeros(
                (), device=mod.weight.device))
        mod.quant = mode
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.separate_ops = mode == "int8"
    return net


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.997, epsilon=1e-3)`` on NCHW.

    Inference normalises with the running statistics (PyTorch's batch
    norm; with a bf16 input and fp32 statistics its mixed-type form).
    Training follows flax: the batch mean and the biased variance
    max(E[x^2] - E[x]^2, 0), both in fp32, normalise as
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32, and move
    the running averages as ``0.997 * ra + 0.003 * stat``. ``dtype``, set
    by the network, is the output type (flax's ``dtype``): an int8 conv
    hands BatchNorm fp32, which a bf16 network rounds here once.

    ``separate_ops`` (set in an int8 network) normalises with the running
    statistics as ``(x - mean) * (1 / sqrt(var + eps) * scale) + bias``,
    one correctly rounded op at a time, so that the CPU and the card give
    the same bits: the next conv quantises its input, and an ulp across a
    rounding boundary moves a value by a whole step, which later layers
    amplify. The square root is taken in fp64 and rounded to fp32 (the
    correctly rounded fp32 root): the card's fp32 ``sqrt`` is not
    correctly rounded."""

    dtype: Optional[torch.dtype] = None
    separate_ops = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.separate_ops:
            root = torch.sqrt((self.running_var + self.eps).double()).float()
            mul = (1.0 / root) * self.weight
            y = ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
        elif not self.training:
            y = super().forward(x)
        else:
            xf = x.float()
            sharding = halo.current()
            if sharding is not None and sharding.stats_group is not None:
                mean, var = _global_moments(xf, sharding.stats_group)
            else:
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp((xf * xf).mean(dim=(0, 2, 3))
                                  - mean * mean, min=0.0)
            with torch.no_grad():
                for ra, stat in ((self.running_mean, mean),
                                 (self.running_var, var)):
                    ra.copy_(FLAX_MOMENTUM * ra + (1 - FLAX_MOMENTUM) * stat)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = ((xf - mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
        return y if self.dtype is None else y.to(self.dtype)


def _global_moments(xf: torch.Tensor, group):
    """Mean and biased variance ``max(E[x^2] - E[x]^2, 0)`` per channel
    over every rank's batch and rows: one differentiable ``all_reduce``
    of the fp32 sums of x and x^2 and the count."""
    c = xf.shape[1]
    sums = torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                      xf.new_full((1,), xf.numel() / c)])
    sums = halo.all_reduce_sum(sums, group)
    mean = sums[:c] / sums[2 * c]
    var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
    return mean, var


def batch_norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def set_compute_dtype(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make ``dtype`` the network's compute type: its input cast and
    every BatchNorm's output type."""
    net.dtype = dtype
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            mod.dtype = dtype
    return net


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
        self.pointwise = SameConv2d(in_ch, features, 1, bias=False)
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
    """SAME max-pool on NCHW (padding with -inf, as flax does); row
    sharded inside ``halo.use``."""
    rows = halo.current_rows()
    if rows is None:
        x = pad_same(x, (window, window), (stride, stride),
                     value=-float("inf"))
    else:
        h = rows.rows_at(x.shape[-1])
        x = halo.window(x, rows, 2, h, window, stride,
                        same_pads(h, window, stride)[0], -float("inf"))
        x = F.pad(x, same_pads(x.shape[-1], window, stride) + (0, 0),
                  value=-float("inf"))
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
