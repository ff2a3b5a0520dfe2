"""End-to-end pose decode: network output -> padded humans.

Port of ``tfpose_tpu/ops/decode.py``. The layouts are the JAX
package's: network outputs are (H/8, W/8, C) or (N, H/8, W/8, C), the
skeleton's heat channels then its PAF channels (57 for COCO-18, 78 for
BODY_25), maps are (H, W, C). Each function takes the ``skeleton``
(``core/topology.py``) of the maps, COCO-18 by default.

The JAX package picks its Pallas route by backend (``use_pallas``); the
port takes one route on every device and each kernel wrapper picks the
CUDA kernel for a CUDA tensor and its plain version for a CPU tensor:

* :func:`decode` / :func:`decode_batch`: smooth+NMS+top-K, PAF
  scoring, greedy connections, assembly, the batch x part planes
  flattened into one kernel call each. Shapes alone pick the kernels:
  the raw-grid top-K (:func:`smooth_nms_topk_raw`) where the upsample is
  an integer replication within the route's size limit
  (``can_use_phase_kernel``),
  else the area-upsampled heat through :func:`smooth_nms_topk`; the
  raw-grid PAF scorer (:func:`score_candidates_raw`) at any
  integer ratio, else the gather scorer on the area-upsampled PAF;
* :func:`postprocess` + :func:`decode_maps` (the public single-image
  ``inference`` path, which also returns the maps): area upsample,
  :func:`smooth_nms`, ``top_peaks`` and the gather scorer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import COCO18, Skeleton
from tfpose_tpu_torch.ops import nms, paf, resize
from tfpose_tpu_torch.ops.assemble import Assembled, assemble_dense
from tfpose_tpu_torch.ops.kernels.paf_score import score_candidates_raw
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    can_use_phase_kernel,
    smooth_nms,
    smooth_nms_topk,
    smooth_nms_topk_raw,
)
from tfpose_tpu_torch.utils.profiling import span


def decode_maps(peaks_map: torch.Tensor, paf_up: torch.Tensor,
                params: DecodeParams,
                skeleton: Skeleton = COCO18) -> Assembled:
    """Decode from an NMS'd peaks plane (H, W, heat channels) + upsampled
    PAF map (H, W, PAF channels). Coordinates are normalised to [0, 1] by
    the heatmap size, matching reference ``PoseEstimator.estimate_paf``."""
    h, w, _ = peaks_map.shape
    with span("decode.peaks"):
        pk = nms.top_peaks(peaks_map, params.max_peaks, params.thresh_heat,
                           skeleton.num_parts)
    with span("decode.candidates"):
        cands = paf.score_candidates(pk, paf_up, params, skeleton)
    with span("decode.greedy"):
        conns = paf.greedy_connections(cands, params)
    with span("decode.assemble"):
        return assemble_dense(pk, conns, params, (w, h), skeleton)


def _check_channels(net_out: torch.Tensor, skeleton: Skeleton) -> None:
    if net_out.shape[-1] != skeleton.out_ch:
        raise ValueError(f"{net_out.shape[-1]} map channels; skeleton "
                         f"{skeleton.name} has {skeleton.heat_ch} heat and "
                         f"{skeleton.paf_ch} PAF channels")


def postprocess(net_out: torch.Tensor, up_h: int, up_w: int,
                params: DecodeParams, skeleton: Skeleton = COCO18
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference post-graph on a (H/8, W/8, C) network output: split ->
    area-upsample -> Gaussian smooth -> NMS. Returns (peaks_map, heat_up,
    paf_up), all (up_h, up_w, C) fp32."""
    _check_channels(net_out, skeleton)
    with span("decode.peaks"):
        net_out = net_out.float()
        heat_up = resize.resize_area(net_out[..., :skeleton.heat_ch], up_h,
                                     up_w)
        paf_up = resize.resize_area(net_out[..., skeleton.heat_ch:], up_h,
                                    up_w)
        peaks_map = smooth_nms(heat_up.contiguous(),
                               params.smooth_kernel_size, params.smooth_sigma)
    return peaks_map, heat_up, paf_up


def _integer_upsample(h8: int, w8: int, up_h: int, up_w: int) -> bool:
    """Area upsampling by an integer factor is replication, so the raw
    planes stand for the upsampled ones exactly."""
    return up_h % h8 == 0 and up_w % w8 == 0 and up_h >= h8 and up_w >= w8


def decode_batch(net_out: torch.Tensor, up_h: int, up_w: int,
                 params: DecodeParams,
                 skeleton: Skeleton = COCO18) -> Assembled:
    """Decode (N, H/8, W/8, C) network outputs; results have a leading
    N. The N x parts heat planes go through one top-K kernel call and the
    N x limbs pair planes through one PAF scoring call."""
    _check_channels(net_out, skeleton)
    parts = skeleton.num_parts
    with span("decode.peaks"):
        net_out = net_out.float()
        b, h8, w8 = net_out.shape[:3]
        heat = net_out[..., :skeleton.heat_ch]
        pafm = net_out[..., skeleton.heat_ch:]
        args = (params.max_peaks, params.thresh_heat,
                params.smooth_kernel_size, params.smooth_sigma)
        if can_use_phase_kernel(h8, w8, up_h, up_w,
                                params.smooth_kernel_size):
            hb = heat[..., :parts].permute(1, 2, 0, 3).reshape(h8, w8, -1)
            s, i = smooth_nms_topk_raw(hb, up_h // h8, up_w // w8, *args)
        else:
            # plane b*parts + p of the upsampled heat, channel-first: the
            # (up_h, up_w, B*parts) view reaches the kernel without a copy
            heat_up = resize.resize_area(heat, up_h, up_w)[..., :parts]
            planes = heat_up.permute(0, 3, 1, 2).reshape(-1, up_h, up_w)
            s, i = smooth_nms_topk(planes.permute(1, 2, 0), *args)
        scores = s.reshape(b, parts, -1)
        idx = i.reshape(b, parts, -1).clamp(min=0)
        pk = nms.Peaks(x=idx % up_w, y=idx // up_w, score=scores,
                       valid=scores > params.thresh_heat)
    with span("decode.candidates"):
        if _integer_upsample(h8, w8, up_h, up_w):
            cands = score_candidates_raw(pk, pafm, up_h, up_w, params,
                                         prefix_valid=True,
                                         skeleton=skeleton)
        else:
            cands = paf.score_candidates_batch(
                pk, resize.resize_area(pafm, up_h, up_w), params, skeleton)
    with span("decode.greedy"):
        conns = paf.greedy_connections(cands, params)
    with span("decode.assemble"):
        return assemble_dense(pk, conns, params, (up_w, up_h), skeleton)


def decode(net_out: torch.Tensor, up_h: int, up_w: int,
           params: DecodeParams, skeleton: Skeleton = COCO18) -> Assembled:
    """Full decode from one raw (H/8, W/8, C) network output."""
    out = decode_batch(net_out[None], up_h, up_w, params, skeleton)
    return Assembled(*(t[0] for t in out))


def decode_adaptive(net_out: torch.Tensor, up_h: int, up_w: int,
                    params: DecodeParams, skeleton: Skeleton = COCO18):
    """Decode with ``params``; when a part's peak cap saturated and
    ``params.escalate_on_saturation`` is set, decode again with
    ``params.escalated()`` (the reference's peak scan is unbounded).
    Returns ``(Assembled, escalated: bool)``."""
    out = decode(net_out, up_h, up_w, params, skeleton)
    esc = params.escalated()
    if (not params.escalate_on_saturation
            or esc.max_peaks == params.max_peaks
            or not bool(out.peak_saturated.any())):
        return out, False
    return decode(net_out, up_h, up_w, esc, skeleton), True
