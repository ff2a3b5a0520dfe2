"""K6: a conv's bias and per-channel PReLU in one pass, into the conv's
output and/or its channel slice of a concat buffer (``csrc/bias_prelu.cu``).

BODY_25 (``models/body25.py``) runs each of its 99 PReLU convs without
its bias; :func:`bias_prelu` then computes ``v = y + bias[c]``, ``r = v if
v > 0 else v * alpha[c]`` in fp32 and writes ``r``, rounded once to
``y``'s type (fp32 or bf16), into each tensor of ``outs``: ``y`` itself
(a whole tensor is its own slice), a channel slice of a block's concat
buffer, or both, where the next conv of the block reads ``y`` and the
next block reads the buffer. The eager way is three passes (bias add,
PReLU, ``torch.cat``).

:func:`bias_prelu_plain` is the plain version, rounding as the kernel
does; the wrapper runs it for CPU tensors and launches the kernel for
CUDA tensors. ``bias_prelu.launches`` counts launches. Every tensor is
channels last, as the network holds its activations, with 16 bytes'
worth of channels a step; the wrapper refuses any other layout on every
device, so a CPU run refuses what the card would.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tfpose_tpu_torch.ops.kernels import build

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# argument types of the kernel's C launch function, in order
BIAS_PRELU_ARGTYPES = [_ptr] * 7 + [_int] * 2 + [_ptr]
_DTYPES = (torch.float32, torch.bfloat16)


def bias_prelu_plain(y: torch.Tensor, bias: torch.Tensor,
                     alpha: torch.Tensor,
                     outs: Sequence[torch.Tensor]) -> None:
    """The plain version of :func:`bias_prelu`."""
    v = y.float() + bias.float()[:, None, None]
    r = torch.where(v > 0, v, v * alpha.float()[:, None, None]).to(y.dtype)
    for out in outs:
        out.copy_(r)


@functools.lru_cache(maxsize=256)
def _layout(shape, elem, strides):
    """The launch's sizes (N, H, W, C) and the N, H, W strides of y and
    each output (``strides``: their four strides each), or None where one
    is off the kernel's layout: channels last (the channel stride 1), C
    and the pixel strides multiples of 16 bytes' worth of values. The
    network's forward repeats a few hundred layouts, so each is worked
    out once."""
    vec = 16 // elem
    if shape[1] % vec or any(st[1] != 1 or any(st[k] % vec for k in (0, 2, 3))
                             for st in strides):
        return None
    n, c, h, w = shape
    flat = [st[k] for st in strides for k in (0, 2, 3)]
    return ((ctypes.c_longlong * 4)(n, h, w, c),
            (ctypes.c_longlong * 9)(*flat, *[0] * (9 - len(flat))))


def _check(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
           outs: Sequence[torch.Tensor]):
    """Raise ValueError on what the kernel does not take; else return
    the launch's sizes and strides (:func:`_layout`)."""
    if y.dim() != 4 or y.dtype not in _DTYPES:
        raise ValueError(f"bias_prelu: want an (N, C, H, W) fp32 or bf16 "
                         f"tensor, got {tuple(y.shape)} {y.dtype}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bias_prelu: unsupported device {y.device}")
    c = y.shape[1]
    for name, t in (("bias", bias), ("alpha", alpha)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != y.device:
            raise ValueError(f"bias_prelu: {name} must be ({c},) float32 on "
                             f"{y.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if not 1 <= len(outs) <= 2:
        raise ValueError(f"bias_prelu: one or two outputs, got {len(outs)}")
    for out in outs:
        if (out.shape != y.shape or out.dtype != y.dtype
                or out.device != y.device):
            raise ValueError(f"bias_prelu: an output must be "
                             f"{tuple(y.shape)} {y.dtype} on {y.device}, "
                             f"got {tuple(out.shape)} {out.dtype} on "
                             f"{out.device}")
    tensors = (y, *outs)
    plan = _layout(tuple(y.shape), y.element_size(),
                   tuple(t.stride() for t in tensors))
    if plan is None or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            f"bias_prelu: want channels-last tensors (channel stride 1) "
            f"with C and the pixel strides multiples of 16 bytes and the "
            f"data 16-byte aligned, got C={c} {y.dtype}, strides "
            f"{[t.stride() for t in tensors]}")
    return plan


def bias_prelu(y: torch.Tensor, bias: torch.Tensor, alpha: torch.Tensor,
               outs: Sequence[torch.Tensor]) -> None:
    """``prelu(y + bias)`` with a slope per channel, into each of
    ``outs``: y (N, C, H, W) fp32 or bf16, channels last (the conv output
    without its bias); bias, alpha (C,) fp32; ``outs`` one or two
    channels-last tensors of y's shape and type (``y`` itself, in place,
    or a channel slice of a concat buffer). C and the pixel strides are
    multiples of 16 bytes' worth of values and the data 16-byte aligned,
    on every device."""
    sizes, strides = _check(y, bias, alpha, outs)
    if y.device.type == "cpu":
        bias_prelu_plain(y, bias, alpha, outs)
        return
    fn = build.launcher("bias_prelu", "bias_prelu_launch",
                        BIAS_PRELU_ARGTYPES)
    status = fn(y.data_ptr(), bias.data_ptr(), alpha.data_ptr(),
                outs[0].data_ptr(), outs[-1].data_ptr(), sizes, strides,
                len(outs), int(y.dtype == torch.bfloat16),
                torch.cuda.current_stream(y.device).cuda_stream)
    build.check("bias_prelu", status, "bias_prelu")
    bias_prelu.launches += 1


bias_prelu.launches = 0
