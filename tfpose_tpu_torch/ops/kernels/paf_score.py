"""PAF candidate scoring kernel of the decode path.

Port of ``tfpose_tpu/ops/pallas/paf_score.py:paf_sample_scores_pallas``
and the ops around it in ``tfpose_tpu/ops/paf.py:
score_candidates_pallas_batch`` (``csrc/paf_score.cu``):
:func:`score_candidates_raw` scores every limb candidate of a batch on
the RAW stride-8 PAF planes, which stand for the upsampled ones exactly
at an integer factor (integer-factor ``resize_area`` is replication). For
pair p and candidate (a, b) it takes ``STEP_PAF`` samples
``v = Px[iy, ix] * vx + Py[iy, ix] * vy`` along the segment and returns
``Candidates(score, ok)``: score = mean(v) + min(0.5 * up_h / dist - 1,
0), ok = #(v > THRESH_VECTOR_SCORE) > THRESH_VECTOR_CNT1, score > 0 and
both endpoints valid. With ``prefix_valid`` (each part's valid peaks fill
a prefix of its K slots, as the top-K gives them) candidates in rows of
``LANES`` beyond the pair's valid a-peaks take mean = count = 0, as the
JAX kernel's row skip does.

The plain version composes the candidate geometry, the per-sample arrays
the TPU kernel reads (:func:`raw_sample_inputs`), their sampling
(:func:`paf_sample_scores_plain`) and the criteria, each step its own
PyTorch op; the kernel computes the same steps per candidate in
registers, rounding each as PyTorch does. The wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors;
``score_candidates_raw.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import COCO18, Skeleton
from tfpose_tpu_torch.ops.kernels import build
from tfpose_tpu_torch.ops.nms import Peaks

LANES = 128  # candidates per row of the prefix-valid row skip
MAX_K = 1024  # peaks per part
MAX_STEPS = 64  # samples per candidate (a kernel parameter table)

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# argument types of the kernel's C launch function, in order
SCORE_ARGTYPES = ([_ptr] * 8 + [_int] * 4 + [ctypes.c_longlong] * 4
                  + [_int] * 5 + [ctypes.c_float] * 3 + [_int, _ptr])


class Candidates(NamedTuple):
    """Per-pair candidate scores; tensors are (..., num_pairs, K, K)."""

    score: torch.Tensor   # criterion2 (length-penalised mean PAF score)
    ok: torch.Tensor      # bool: passes both criteria and endpoints valid


@functools.lru_cache(maxsize=8)
def _steps(s: int, device: str) -> torch.Tensor:
    """The sample fractions i / S as float32, divided on the host so that
    every device (and the kernel, which takes them as a table) samples at
    the same points."""
    return (torch.arange(s, dtype=torch.float32) / s).to(device)


@functools.lru_cache(maxsize=4)
def _pair_table(skeleton: Skeleton) -> torch.Tensor:
    """(limbs, 4) int32 on the host: each limb's parts a, b and its x, y
    PAF channels, the kernel's table."""
    return torch.from_numpy(np.concatenate([
        skeleton.pairs_array(), skeleton.paf_channels_array()], 1))


def candidate_geometry(peaks: Peaks, h: int, w: int, params: DecodeParams,
                       skeleton: Skeleton = COCO18):
    """Candidate geometry on an (h, w) grid: endpoint validity,
    direction vectors, distances, and rounded sample-point coordinates.
    Peaks are (..., parts, K); outputs (..., limbs, K, K[, S])."""
    pairs = torch.as_tensor(skeleton.pairs_array(), dtype=torch.long,
                            device=peaks.x.device)
    ax = peaks.x[..., pairs[:, 0], :].float()
    ay = peaks.y[..., pairs[:, 0], :].float()
    av = peaks.valid[..., pairs[:, 0], :]
    bx = peaks.x[..., pairs[:, 1], :].float()
    by = peaks.y[..., pairs[:, 1], :].float()
    bv = peaks.valid[..., pairs[:, 1], :]

    # a varies over dim -2, b over dim -1
    dx = bx[..., None, :] - ax[..., :, None]
    dy = by[..., None, :] - ay[..., :, None]
    norm = torch.sqrt(dx * dx + dy * dy)
    safe = norm > 1e-12
    inv = torch.where(safe, 1.0 / torch.clamp(norm, min=1e-12),
                      torch.zeros_like(norm))
    vx = dx * inv
    vy = dy * inv

    steps = _steps(params.step_paf, str(dx.device))
    sx = ax[..., :, None, None] + dx[..., None] * steps
    sy = ay[..., :, None, None] + dy[..., None] * steps
    # reference roundpaf: floor(v + 0.5) (round half up, coords >= 0)
    ix = torch.clamp(torch.floor(sx + 0.5).int(), 0, w - 1)
    iy = torch.clamp(torch.floor(sy + 0.5).int(), 0, h - 1)
    return vx, vy, norm, safe, av, bv, iy, ix


def criteria(mean, cnt, norm, safe, av, bv, h: int,
             params: DecodeParams) -> Candidates:
    """Both reference criteria of the candidates from their mean PAF
    score and count of samples above threshold."""
    num = torch.tensor(0.5 * h, dtype=torch.float32, device=norm.device)
    penalty = torch.clamp(num / torch.clamp(norm, min=1e-12) - 1.0, max=0.0)
    criterion2 = mean + penalty
    ok = ((cnt > params.thresh_vector_cnt1)
          & (criterion2 > 0.0)
          & safe
          & av[..., :, None] & bv[..., None, :])
    return Candidates(score=criterion2, ok=ok)


def raw_sample_inputs(peaks_b: Peaks, paf8_b: torch.Tensor, up_h: int,
                      up_w: int, params: DecodeParams,
                      prefix_valid: bool = True,
                      skeleton: Skeleton = COCO18):
    """The inputs of the TPU kernel, and of :func:`paf_sample_scores_plain`,
    for peaks (B, parts, K) on raw planes (B, h8, w8, PAF channels):
    ``(planes, iy, ix, vx, vy, nrows)`` with planes (B*L, 2, h8, w8) and
    per-sample arrays (B*L, S, K*K), L the skeleton's limbs, plus the
    candidate geometry ``(norm, safe, av, bv)`` (B, L, K, K)."""
    b, h8, w8, _ = paf8_b.shape
    fy, fx = up_h // h8, up_w // w8
    vx, vy, norm, safe, av, bv, iy, ix = candidate_geometry(
        peaks_b, up_h, up_w, params, skeleton)
    k = vx.shape[-1]
    s = params.step_paf
    n_pairs = skeleton.num_pairs
    pc = torch.as_tensor(skeleton.paf_channels_array(), dtype=torch.long,
                         device=paf8_b.device)
    planes = paf8_b.float()[..., pc].permute(0, 3, 4, 1, 2)  # (B,L,2,h8,w8)
    planes = planes.reshape(b * n_pairs, 2, h8, w8)

    def sample_major(a):  # (B, L, K, K, S) -> (B*L, S, K*K)
        return a.permute(0, 1, 4, 2, 3).reshape(b * n_pairs, s, k * k)

    if prefix_valid:
        va = av.int().sum(-1)                                  # (B, L)
        nrows = torch.where(bv.any(-1), (va * k + LANES - 1) // LANES,
                            torch.zeros_like(va))
    else:
        nrows = torch.full(av.shape[:2], -(-k * k // LANES),
                           device=av.device)
    samples = (planes, sample_major(iy // fy), sample_major(ix // fx),
               sample_major(vx[..., None].expand(*vx.shape, s)),
               sample_major(vy[..., None].expand(*vy.shape, s)),
               nrows.reshape(b * n_pairs).int())
    return samples, (norm, safe, av, bv)


def paf_sample_scores_plain(planes, iy, ix, vx, vy, nrows, *, s_paf: int,
                            thresh: float):
    """What the TPU kernel computes, as a gather: per candidate (mean PAF
    score, #samples above ``thresh``), summed sample by sample with no
    fused multiply-add. planes (P, 2, h8, w8); iy, ix, vx, vy (P, S, KK);
    nrows (P,) rows of ``LANES`` candidates to score. Returns (mean, cnt),
    each (P, KK) fp32."""
    p, _, h8, w8 = planes.shape
    kk = iy.shape[2]
    lin = (iy.long() * w8 + ix.long()).reshape(p, -1)
    flat = planes.reshape(p, 2, h8 * w8)
    px = flat[:, 0].gather(1, lin).reshape(iy.shape)
    py = flat[:, 1].gather(1, lin).reshape(iy.shape)
    v = px * vx + py * vy
    total = torch.zeros((p, kk), dtype=torch.float32, device=planes.device)
    cnt = torch.zeros_like(total)
    for i in range(s_paf):
        total = total + v[:, i]
        cnt = cnt + (v[:, i] > thresh).float()
    rows = torch.arange(kk, device=planes.device) // LANES
    live = rows[None, :] < nrows[:, None]
    zero = torch.zeros_like(total)
    return (torch.where(live, total * (1.0 / s_paf), zero),
            torch.where(live, cnt, zero))


def score_candidates_raw_plain(peaks_b: Peaks, paf8_b: torch.Tensor,
                               up_h: int, up_w: int, params: DecodeParams,
                               prefix_valid: bool = True,
                               skeleton: Skeleton = COCO18) -> Candidates:
    """The plain version of :func:`score_candidates_raw`."""
    samples, (norm, safe, av, bv) = raw_sample_inputs(
        peaks_b, paf8_b, up_h, up_w, params, prefix_valid, skeleton)
    mean, cnt = paf_sample_scores_plain(
        *samples, s_paf=params.step_paf,
        thresh=float(params.thresh_vector_score))
    return criteria(mean.reshape(norm.shape), cnt.reshape(norm.shape),
                    norm, safe, av, bv, up_h, params)


def _check(peaks_b: Peaks, paf8_b: torch.Tensor, up_h: int, up_w: int,
           params: DecodeParams, skeleton: Skeleton) -> None:
    x, y, valid = peaks_b.x, peaks_b.y, peaks_b.valid
    parts = skeleton.num_parts
    if (x.dim() != 3 or x.shape[1] != parts
            or not 1 <= x.shape[2] <= MAX_K):
        raise ValueError(f"peaks: want (B, {parts}, K) with K in "
                         f"1..{MAX_K}, got {tuple(x.shape)}")
    for name, t, dt in (("x", x, torch.int32), ("y", y, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt or t.shape != x.shape or t.device != paf8_b.device:
            raise ValueError(f"peaks.{name}: want {tuple(x.shape)} {dt} on "
                             f"{paf8_b.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if (paf8_b.dtype != torch.float32 or paf8_b.dim() != 4
            or paf8_b.shape[0] != x.shape[0]
            or paf8_b.shape[3] != skeleton.paf_ch):
        raise ValueError(f"paf8: want ({x.shape[0]}, h8, w8, "
                         f"{skeleton.paf_ch}) float32, got "
                         f"{tuple(paf8_b.shape)} {paf8_b.dtype}")
    h8, w8 = paf8_b.shape[1:3]
    if min(h8, w8) < 1 or up_h % h8 or up_w % w8 or up_h < h8 or up_w < w8:
        raise ValueError(f"({up_h}, {up_w}) is no integer upsample of the "
                         f"raw ({h8}, {w8}) grid")
    if not 1 <= params.step_paf <= MAX_STEPS:
        raise ValueError(f"step_paf must be in 1..{MAX_STEPS}, got "
                         f"{params.step_paf}")
    if paf8_b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {paf8_b.device}")


def score_candidates_raw(peaks_b: Peaks, paf8_b: torch.Tensor, up_h: int,
                         up_w: int, params: DecodeParams,
                         prefix_valid: bool = True,
                         skeleton: Skeleton = COCO18) -> Candidates:
    """Candidates (B, limbs, K, K) of peaks (B, parts, K) (int32 x, y on
    the (up_h, up_w) grid, bool valid) on the raw PAF ``paf8_b`` (B, h8,
    w8, PAF channels) fp32 of ``skeleton``, any strides (a view of the
    network output is read in place), where (up_h, up_w) is an integer
    multiple of (h8, w8)."""
    _check(peaks_b, paf8_b, up_h, up_w, params, skeleton)
    if paf8_b.device.type == "cpu":
        return score_candidates_raw_plain(peaks_b, paf8_b, up_h, up_w,
                                          params, prefix_valid, skeleton)
    b, k = peaks_b.x.shape[0], peaks_b.x.shape[2]
    x, y, valid = (t.contiguous() for t in (peaks_b.x, peaks_b.y,
                                             peaks_b.valid))
    table = _pair_table(skeleton)
    n_pairs = table.shape[0]
    steps = _steps(params.step_paf, "cpu")  # copied into the launch
    dev = paf8_b.device
    score = torch.empty((b, n_pairs, k, k), dtype=torch.float32, device=dev)
    ok = torch.empty((b, n_pairs, k, k), dtype=torch.bool, device=dev)
    fn = build.launcher("paf_score", "score_candidates_raw_launch",
                        SCORE_ARGTYPES)
    status = fn(x.data_ptr(), y.data_ptr(), valid.data_ptr(),
                paf8_b.data_ptr(), score.data_ptr(), ok.data_ptr(),
                table.data_ptr(), steps.data_ptr(), b, x.shape[1], n_pairs, k,
                *paf8_b.stride(), up_h, up_w, up_h // paf8_b.shape[1],
                up_w // paf8_b.shape[2], params.step_paf,
                float(params.thresh_vector_score),
                float(params.thresh_vector_cnt1), 1.0 / params.step_paf,
                int(prefix_valid), torch.cuda.current_stream(dev).cuda_stream)
    build.check("paf_score", status, "score_candidates_raw")
    score_candidates_raw.launches += 1
    return Candidates(score=score, ok=ok)


score_candidates_raw.launches = 0
