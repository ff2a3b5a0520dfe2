"""Gaussian smooth + 3x3 NMS kernels of the decode path.

Port of ``tfpose_tpu/ops/pallas/smooth_nms.py``. Three CUDA kernels, each
with its plain PyTorch version beside it:

* :func:`smooth_nms` (``csrc/smooth_nms.cu``) replaces
  ``smooth_nms_pallas``: the 25-tap blur of an upsampled (H, W, C) heat
  map with zero SAME padding, summed in tap order, then keep a value
  where it is >= its 3x3 neighbourhood max, else 0. No threshold. It
  reads and writes the (H, W, C) layout in place of a transposed copy.
* :func:`smooth_nms_topk_raw` (``csrc/smooth_nms_topk_raw.cu``) replaces
  ``smooth_nms_topk_raw_pallas``: the same blur of the integer
  area-upsampled heat, computed as fy*fx phase convolutions on the raw
  stride-8 grid, then 3x3 NMS with a threshold and an exact top-K per
  plane (scores descending, ties to the lower flat index; empty slots
  hold score 0 and index -1). The upsampled map never exists.
* :func:`smooth_nms_topk` (``csrc/smooth_nms_topk.cu``) replaces
  ``smooth_nms_topk_pallas``: the same blur, NMS, threshold and top-K on
  an already-upsampled (H, W, C) map, for ratios that are not an integer
  replication and for planes beyond the raw-grid route's size limit.

The two top-K kernels share one design (``csrc/peak_select.cuh``): a
tiled peaks pass appends each plane's peaks to a list in device memory
sized for the worst case, and a select kernel cuts each list to its top
K. The route between them depends on shapes only
(:func:`can_use_phase_kernel`): the raw-grid kernel takes an integer
factor of 1..8 and planes within :data:`PHASE_ROUTE_FLOATS`. That limit
stands for the JAX package's VMEM budget and is tighter: a 1280x720
frame in 432x368 windows merges to a 90x160 grid, which the JAX package
decodes at 4x through its raw-grid kernel and the port through
:func:`smooth_nms_topk` (the two kernels select the same peaks).

A wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; anything else raises. Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tfpose_tpu_torch.ops.gaussian import gauss_kernel_1d
from tfpose_tpu_torch.ops.kernels import build
from tfpose_tpu_torch.ops.nms import max3x3, nms, stable_topk

# Peaks per plane that the top-K kernels sort in shared memory; a plane
# with more is cut to its top K by a radix select first (same result).
LIST_CAP = 4096
# Result slots per plane, as in the JAX kernels' (8, 128) result tile.
MAX_K = 1024
# Longest blur the kernels take (taps are a kernel parameter).
MAX_TAPS = 64
# The raw-grid route's size limit: a plane's vertical phase sums
# (fy*h8 rows of w8 + nh - 1 floats) and both phase weight tables within
# this many floats. It is the shared-memory budget of the earlier
# one-block-per-plane kernel ((232,448 B - 2,048 keys of 8 B) / 4 B), kept
# as a number so that every shape keeps its route; the tiled kernel
# itself needs no such limit.
PHASE_ROUTE_FLOATS = 54016

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# argument types of the kernels' C launch functions, in order
SMOOTH_NMS_ARGTYPES = [_ptr] * 3 + [_int] * 4 + [_ptr]
TOPK_RAW_ARGTYPES = [_ptr] * 7 + [_int] * 11 + [ctypes.c_float, _int, _ptr]
TOPK_ARGTYPES = [_ptr] * 6 + [_int] * 5 + [ctypes.c_float, _int, _ptr]


def _check_input(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() != ndim:
        raise ValueError(f"{name}: want a {ndim}-D float32 tensor, got "
                         f"{x.dim()}-D {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@functools.lru_cache(maxsize=32)
def _taps(kernlen: int, nsig: float, device: str) -> torch.Tensor:
    return torch.from_numpy(gauss_kernel_1d(kernlen, nsig)).to(device)


# ---------------------------------------------------------------------------
# K2: smooth + NMS on the upsampled map
# ---------------------------------------------------------------------------

def _check_kernlen(kernlen: int) -> None:
    if not 1 <= kernlen <= MAX_TAPS:
        raise ValueError(f"kernlen must be in 1..{MAX_TAPS}, got {kernlen}")


def smooth_nms_plain(heat: torch.Tensor, kernlen: int = 25,
                     nsig: float = 3.0) -> torch.Tensor:
    """(H, W, C) -> NMS'd peaks plane (H, W, C): blur in tap order, then
    keep values >= their 3x3 max. The plain version of :func:`smooth_nms`,
    rounding as the kernel does."""
    sm = blur_in_tap_order(heat.permute(2, 0, 1), kernlen, nsig)
    return nms(sm.permute(1, 2, 0), 3)


def smooth_nms(heat: torch.Tensor, kernlen: int = 25,
               nsig: float = 3.0) -> torch.Tensor:
    """(H, W, C) fp32 -> NMS'd peaks plane (H, W, C), the reference
    Smoother + ``tf.nn.pool`` NMS semantics. Any H, W, C >= 1 and
    ``kernlen`` 1 .. ``MAX_TAPS``."""
    _check_input(heat, 3, "smooth_nms")
    _check_kernlen(kernlen)
    if min(heat.shape) < 1:
        raise ValueError(f"smooth_nms: empty map {tuple(heat.shape)}")
    if heat.device.type == "cpu":
        return smooth_nms_plain(heat, kernlen, nsig)
    heat = heat.contiguous()
    h, w, c = heat.shape
    out = torch.empty_like(heat)
    taps = _taps(kernlen, float(nsig), "cpu")  # copied into the launch
    fn = build.launcher("smooth_nms", "smooth_nms_launch",
                        SMOOTH_NMS_ARGTYPES)
    status = fn(heat.data_ptr(), out.data_ptr(), taps.data_ptr(),
                h, w, c, kernlen, _stream(heat))
    build.check("smooth_nms", status, "smooth_nms")
    smooth_nms.launches += 1
    return out


smooth_nms.launches = 0


# ---------------------------------------------------------------------------
# K1: smooth + NMS + top-K on the raw grid (phase decomposition)
# ---------------------------------------------------------------------------

def _phase_weights(kern, f: int, p: int):
    """Group the 1-D blur taps by raw-grid cell, per output phase.

    With integer-factor area upsampling, up[X] = raw[X // f], so the
    blurred value at X = f*i + a is
      sum_k kern[k] * up[X + k - p] = sum_d W[a, d] * raw[i + d]
    where d = floor((a + k - p) / f). The grouping is exact under the
    reference's zero padding of the upsampled map, because a raw cell
    outside [0, n) only ever receives taps whose upsampled position is
    also outside [0, f*n). Summed in float64, then cast to float32, as
    in the JAX package. Returns ((f, n_d) weights, dmin, dmax).
    """
    dmin, dmax = _phase_range(f, len(kern), p)
    w = np.zeros((f, dmax - dmin + 1), np.float64)
    for a in range(f):
        for k in range(len(kern)):
            w[a, (a + k - p) // f - dmin] += kern[k]
    return w.astype(np.float32), dmin, dmax


def _phase_range(f: int, nk: int, p: int):
    """(dmin, dmax): the raw-grid offsets an ``nk``-tap blur padded by
    ``p`` reaches from any phase at factor ``f``."""
    return (min((a - p) // f for a in range(f)),
            max((a + nk - 1 - p) // f for a in range(f)))


def can_use_phase_kernel(h8: int, w8: int, up_h: int, up_w: int,
                         kernlen: int = 25) -> bool:
    """The raw-grid kernel is exact iff the upsample is a pure integer
    replication; factors stay within 1..8 as in the JAX package, and the
    plane stays within :data:`PHASE_ROUTE_FLOATS` (the port's counterpart
    of the JAX package's VMEM budget)."""
    if h8 <= 0 or w8 <= 0 or up_h % h8 or up_w % w8:
        return False
    fy, fx = up_h // h8, up_w // w8
    if not (1 <= fy <= 8 and 1 <= fx <= 8):
        return False
    (dvmin, dvmax), (dhmin, dhmax) = (_phase_range(f, kernlen, kernlen // 2)
                                      for f in (fy, fx))
    nv, nh = dvmax - dvmin + 1, dhmax - dhmin + 1
    return fy * h8 * (w8 + nh - 1) + fy * nv + fx * nh <= PHASE_ROUTE_FLOATS


def smooth_nms_topk_raw_plain(heat8: torch.Tensor, fy: int, fx: int,
                              k_top: int, thresh: float,
                              kernlen: int = 25, nsig: float = 3.0):
    """The plain version of :func:`smooth_nms_topk_raw`: upsample by
    replication, then :func:`smooth_nms_topk_plain`."""
    up = heat8.repeat_interleave(fy, 0).repeat_interleave(fx, 1)
    return smooth_nms_topk_plain(up, k_top, thresh, kernlen, nsig)


@functools.lru_cache(maxsize=32)
def _phase_tables(fy: int, fx: int, kernlen: int, nsig: float, device: str):
    """(wv, dvmin, wh, dhmin, zero_taps): both phase weight tables on
    ``device``, and whether a tap t > 0 of either weighs 0 (the kernel
    skips those, as the JAX kernel does)."""
    p = kernlen // 2
    kern = gauss_kernel_1d(kernlen, nsig)
    wv, dvmin, _ = _phase_weights(kern, fy, p)
    wh, dhmin, _ = _phase_weights(kern, fx, p)
    zero_taps = bool((wv[:, 1:] == 0).any() or (wh[:, 1:] == 0).any())
    return (torch.from_numpy(wv).to(device), dvmin,
            torch.from_numpy(wh).to(device), dhmin, zero_taps)


def _check_topk(k_top: int, cap: int, kernlen: int, cap_min: int) -> None:
    if not 1 <= k_top <= MAX_K:
        raise ValueError(f"k_top must be in 1..{MAX_K}, got {k_top}")
    if not cap_min <= cap <= LIST_CAP:
        raise ValueError(f"cap must be in {cap_min}..{LIST_CAP}, got {cap}")
    _check_kernlen(kernlen)


def peak_lists(c: int, plane: int, device):
    """Scratch of the two top-K kernels: each plane's list of peak keys,
    sized for the worst case (every value of the plane a peak, as on a
    plateau), and the per-plane counts, zeroed."""
    return (torch.empty(c * plane, dtype=torch.int64, device=device),
            torch.zeros(c, dtype=torch.int32, device=device))


def smooth_nms_topk_raw(heat8: torch.Tensor, fy: int, fx: int, k_top: int,
                        thresh: float, kernlen: int = 25, nsig: float = 3.0,
                        cap: int = LIST_CAP):
    """(h8, w8, C) raw fp32 planes -> (scores (C, K) f32, flat idx (C, K)
    int32) in upsampled (fy*h8, fx*w8) coordinates.

    ``cap`` (1 .. ``LIST_CAP``) is how many peaks a plane may have for
    the kernel to sort them all in shared memory; a plane with more than
    ``max(cap, k_top)`` is first cut to K by a radix select (same result).
    The CUDA kernel reads planes channel-first, so the wrapper
    transposes the (h8, w8, C) input once (0.18 MB at B=1).
    """
    _check_input(heat8, 3, "smooth_nms_topk_raw")
    if min(fy, fx) < 1:
        raise ValueError("fy and fx must be positive")
    _check_topk(k_top, cap, kernlen, 1)
    if heat8.device.type == "cpu":
        return smooth_nms_topk_raw_plain(heat8, fy, fx, k_top, thresh,
                                         kernlen, nsig)
    h8, w8, c = heat8.shape
    wv, dvmin, wh, dhmin, zero_taps = _phase_tables(
        fy, fx, kernlen, float(nsig), str(heat8.device))
    nv, nh = wv.shape[1], wh.shape[1]
    planes = heat8.permute(2, 0, 1).contiguous()
    lists, counts = peak_lists(c, fy * h8 * fx * w8, heat8.device)
    scores = torch.empty((c, k_top), dtype=torch.float32,
                         device=heat8.device)
    idx = torch.empty((c, k_top), dtype=torch.int32, device=heat8.device)
    fn = build.launcher("smooth_nms_topk_raw", "smooth_nms_topk_raw_launch",
                        TOPK_RAW_ARGTYPES)
    status = fn(planes.data_ptr(), wv.data_ptr(), wh.data_ptr(),
                lists.data_ptr(), counts.data_ptr(), scores.data_ptr(),
                idx.data_ptr(), c, h8, w8, fy, fx, nv, nh, dvmin, dhmin,
                int(zero_taps), k_top, float(thresh), cap, _stream(heat8))
    build.check("smooth_nms_topk_raw", status, "smooth_nms_topk_raw")
    smooth_nms_topk_raw.launches += 1
    return scores, idx


smooth_nms_topk_raw.launches = 0


# ---------------------------------------------------------------------------
# K4: smooth + NMS + top-K on the upsampled map
# ---------------------------------------------------------------------------

def blur_in_tap_order(planes: torch.Tensor, kernlen: int = 25,
                      nsig: float = 3.0) -> torch.Tensor:
    """(C, H, W) -> the separable blur with zero SAME padding, vertical
    pass first, each pass summed tap by tap as the JAX kernel writes it:
    ``acc = k0 * x0``, then ``acc = acc + k_t * x_t``. Every product and
    sum is its own op, so nothing fuses into a multiply-add and the CUDA
    kernel, which rounds each step, gives the same bits."""
    taps = _taps(kernlen, float(nsig), str(planes.device))
    p = kernlen // 2
    h, w = planes.shape[-2:]
    x = torch.nn.functional.pad(planes.float(), (p, p, p, p))
    acc = taps[0] * x[:, 0:h, :]
    for t in range(1, kernlen):
        acc = acc + taps[t] * x[:, t:t + h, :]
    sm = taps[0] * acc[:, :, 0:w]
    for t in range(1, kernlen):
        sm = sm + taps[t] * acc[:, :, t:t + w]
    return sm


def topk_of_smoothed(sm: torch.Tensor, k_top: int, thresh: float):
    """(C, H, W) smoothed planes -> the top-K peaks per plane: values >=
    their 3x3 max (-inf outside) and > thresh, by score descending, ties
    to the lower flat index; empty slots hold 0 and -1."""
    c = sm.shape[0]
    neg = torch.tensor(-float("inf"), device=sm.device)
    peaks = torch.where((sm >= max3x3(sm)) & (sm > thresh), sm, neg)
    flat = peaks.reshape(c, -1)
    if flat.shape[1] < k_top:
        flat = torch.cat([flat, neg.expand(c, k_top - flat.shape[1])], 1)
    vals, order = stable_topk(flat, k_top)
    found = vals > neg
    return (torch.where(found, vals, torch.zeros_like(vals)),
            torch.where(found, order, torch.full_like(order, -1)).int())


def smooth_nms_topk_plain(heat: torch.Tensor, k_top: int, thresh: float,
                          kernlen: int = 25, nsig: float = 3.0):
    """The plain version of :func:`smooth_nms_topk`: blur in tap order,
    3x3 max, threshold, stable top-K."""
    sm = blur_in_tap_order(heat.permute(2, 0, 1), kernlen, nsig)
    return topk_of_smoothed(sm, k_top, thresh)


def smooth_nms_topk(heat: torch.Tensor, k_top: int, thresh: float,
                    kernlen: int = 25, nsig: float = 3.0,
                    cap: int = LIST_CAP):
    """(H, W, C) fp32 upsampled heat -> (scores (C, K) f32, flat idx
    (C, K) int32 into the H*W plane): blur, 3x3 NMS, ``> thresh``, top-K
    by score, ties to the lower index; empty slots hold 0 and -1.

    ``cap`` (``k_top`` .. ``LIST_CAP``) is how many peaks a plane may
    have for the kernel to sort them all in shared memory; beyond it the
    kernel first cuts them to K by a radix select (same result). The
    kernel reads planes channel-first: a (H, W, C) view of a (C, H, W)
    tensor is passed through without a copy.
    """
    _check_input(heat, 3, "smooth_nms_topk")
    _check_topk(k_top, cap, kernlen, k_top)
    if heat.device.type == "cpu":
        return smooth_nms_topk_plain(heat, k_top, thresh, kernlen, nsig)
    h, w, c = heat.shape
    planes = heat.permute(2, 0, 1).contiguous()
    taps = _taps(kernlen, float(nsig), "cpu")  # copied into the launch
    lists, counts = peak_lists(c, h * w, heat.device)
    scores = torch.empty((c, k_top), dtype=torch.float32, device=heat.device)
    idx = torch.empty((c, k_top), dtype=torch.int32, device=heat.device)
    fn = build.launcher("smooth_nms_topk", "smooth_nms_topk_launch",
                        TOPK_ARGTYPES)
    status = fn(planes.data_ptr(), taps.data_ptr(), lists.data_ptr(),
                counts.data_ptr(), scores.data_ptr(), idx.data_ptr(), c, h,
                w, kernlen, k_top, float(thresh), cap, _stream(heat))
    build.check("smooth_nms_topk", status, "smooth_nms_topk")
    smooth_nms_topk.launches += 1
    return scores, idx


smooth_nms_topk.launches = 0
