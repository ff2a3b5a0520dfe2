"""``TfPoseEstimator`` — the reference-compatible public inference API,
ported from ``tfpose_tpu/estimator.py``.

The hot path — normalize -> backbone forward -> decode — runs on one
device, the card by default: ``device=None`` means ``"cuda"``, and the
constructor raises when no card is present rather than moving to the
CPU. ``device="cpu"`` runs every kernel's plain version (the tests do).
The backbone computes in fp32 (TF32 convolutions switched off around the
forward) or, with ``dtype="bfloat16"``, in bf16 with fp32 parameters,
rounding where flax rounds (``models/layers.py``); with ``quantize=True``
its convs compute in int8 (calibrated post-training quantisation,
``models/quantize.py``). Its maps are cast to fp32 and the decode stays
fp32 in every case.

Entry points: ``inference`` (one image, also sets ``heatMat`` /
``pafMat``), ``inference_batch``, and for frames larger than the network
``inference_windowed`` / ``inference_multiscale`` (all windows of a
scale in one backbone batch, maps merged on the device, one decode).
``PoseEstimator.estimate_paf`` is the reference's host-side decode of
given peaks and maps.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.compat import pafprocess
from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.types import BodyPart, Human, PoseArrays
from tfpose_tpu_torch.models import get_checkpoint_path, get_network
from tfpose_tpu_torch.models.layers import init_weights
from tfpose_tpu_torch.models.quantize import (
    default_calibration_images,
    quantize_network,
)
from tfpose_tpu_torch.ops.assemble import Assembled
from tfpose_tpu_torch.ops.decode import (
    decode,
    decode_batch,
    decode_maps,
    postprocess,
)
from tfpose_tpu_torch.pipeline.multiscale import (
    multiscale_forward,
    windowed_forward,
)
from tfpose_tpu_torch.pipeline.preprocess import (
    normalize,
    prepare,
    prepare_bilinear,
)
from tfpose_tpu_torch.utils.draw import draw_humans as _draw_humans

logger = logging.getLogger("TfPoseEstimator")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run_backbone(net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Normalized (N, H, W, 3) on the device -> ``net``'s concat_stage7
    (N, H/8, W/8, 57) as fp32, under inference mode with cuDNN's TF32
    off: an fp32 network computes in true fp32, a bf16 one casts its
    input to bf16 itself and its maps come back cast to fp32."""
    cudnn = torch.backends.cudnn
    with torch.inference_mode(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        return net(x)["concat_stage7"].float()


class PoseEstimator:
    """Reference ``PoseEstimator``: the static PAF decode bridge, through
    the ``compat.pafprocess`` shim (the port's NumPy decoder) on the
    host. The on-device decode (``ops/decode.py``) is the production
    path; this exists for API parity and host-side cross-checking."""

    @staticmethod
    def estimate_paf(peaks: np.ndarray, heat_mat: np.ndarray,
                     paf_mat: np.ndarray) -> List[Human]:
        pafprocess.process_paf(peaks, heat_mat, paf_mat)
        humans = []
        for human_id in range(pafprocess.get_num_humans()):
            human = Human()
            for part_idx in range(18):
                if pafprocess.get_part_cid(human_id, part_idx) < 0:
                    continue
                human.body_parts[part_idx] = BodyPart(
                    "%d-%d" % (human_id, part_idx), part_idx,
                    float(pafprocess.get_part_x(human_id, part_idx))
                    / heat_mat.shape[1],
                    float(pafprocess.get_part_y(human_id, part_idx))
                    / heat_mat.shape[0],
                    pafprocess.get_part_score(human_id, part_idx))
            if human.body_parts:
                human.score = pafprocess.get_score(human_id)
                humans.append(human)
        return humans


class TfPoseEstimator:
    """Drop-in equivalent of the reference estimator.

    Args:
      model: a registry name: 'mobilenet_thin', 'mobilenet',
        'mobilenet_v2_large', 'mobilenet_v2_small', 'cmu' (or 'vgg').
      target_size: (w, h) network input size.
      decode_params: static decode thresholds/caps.
      dtype: backbone compute type, ``"float32"`` or ``"bfloat16"``.
      params_path: flax msgpack checkpoint; without one the network runs
        with seeded random weights.
      warmup: run the reference's warm-up (full / half / quarter size).
      device_preprocess: ``inference`` resizes an image that is not at
        the target size by a half-pixel bilinear resize on the device,
        as the JAX estimator's option does, in place of the default
        resize equal to cv2's ``INTER_AREA``; ``inference_batch`` keeps
        the default, as in the JAX estimator.
      quantize: the int8 backbone, as the JAX estimator's: the network's
        fp32 forward calibrated on ``calibration_images`` on the device,
        then every conv in int8 (``models/quantize.py``); composes with
        ``dtype``, whose BatchNorm outputs stay in that type.
      calibration_images: (N, H, W, 3) uint8; by default 8 rendered
        scenes at ``target_size`` (``default_calibration_images``).
      device: torch device; ``None`` means ``"cuda"``.
    """

    def __init__(self, model: str = "mobilenet_thin",
                 target_size: Tuple[int, int] = (320, 240),
                 decode_params: DecodeParams = DecodeParams(),
                 dtype: str = "float32",
                 params_path: Optional[str] = None,
                 warmup: bool = False,
                 device_preprocess: bool = False,
                 quantize: bool = False,
                 calibration_images: Optional[np.ndarray] = None,
                 device: Optional[str] = None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TfPoseEstimator runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU")
        self.model_name = model
        self.device_preprocess = device_preprocess
        self.target_size = target_size
        self.decode_params = decode_params
        self.dtype = dtype
        self.net = get_network(model, _DTYPES[dtype])
        init_weights(self.net, torch.Generator().manual_seed(0))
        path = params_path or get_checkpoint_path(model)
        if os.path.exists(path):
            variables_from_numpy(self.net, load_flax_msgpack(path))
            logger.info("loaded params from %s", path)
        else:
            logger.warning(
                "no checkpoint at %s — running with random init", path)
        self.net.eval().to(self.device)
        self.quantized = quantize
        if quantize:
            if calibration_images is None:
                calibration_images = default_calibration_images(target_size)
            quantize_network(self.net, calibration_images)
            logger.info("int8 PTQ backbone enabled (calibrated on %d images)",
                        len(calibration_images))

        self.heatMat: Optional[np.ndarray] = None
        self.pafMat: Optional[np.ndarray] = None
        # (18,) or (B, 18) bool after each inference: parts whose top-K
        # peak cap filled up (the reference's peak scan is unbounded)
        self.last_peak_saturated: Optional[np.ndarray] = None
        self._warned_saturation = False

        if warmup:
            w, h = target_size
            for scale in (1.0, 0.5, 0.25):
                sw = max(int(w * scale) // 16 * 16, 16)
                sh = max(int(h * scale) // 16 * 16, 16)
                img = np.zeros((sh, sw, 3), np.uint8)
                self.inference(img, resize_to_default=False,
                               upsample_size=1.0)

    # ------------------------------------------------------------------
    def _forward(self, imgs: np.ndarray, net_h: int, net_w: int,
                 bilinear: bool = False) -> torch.Tensor:
        """uint8 (N, H, W, 3) -> concat_stage7 (N, H/8, W/8, 57) fp32;
        ``bilinear`` resizes as :func:`prepare_bilinear` does."""
        x = torch.as_tensor(np.ascontiguousarray(imgs), device=self.device)
        return self._forward_uint8(x, net_h, net_w, bilinear)

    def _forward_uint8(self, x: torch.Tensor, net_h: int, net_w: int,
                       bilinear: bool = False) -> torch.Tensor:
        """:meth:`_forward` of uint8 (N, H, W, 3) already on the device."""
        resize = prepare_bilinear if bilinear else prepare
        return run_backbone(self.net, resize(x, net_h, net_w))

    def _forward_windows(self, wins: torch.Tensor) -> torch.Tensor:
        """Windows (N, h, w, 3), uint8 or unrounded float, -> their
        concat_stage7 maps in one backbone batch."""
        return run_backbone(self.net, normalize(wins))

    def _decode_params(self, escalated: bool = False) -> DecodeParams:
        return (self.decode_params.escalated() if escalated
                else self.decode_params)

    def _should_escalate(self, sat: torch.Tensor) -> bool:
        """True when a decode saturated the peak cap and adaptive-K
        escalation should decode again with the larger-K parameters."""
        p = self.decode_params
        if not (p.escalate_on_saturation and bool(sat.any())):
            return False
        if p.escalated().max_peaks == p.max_peaks:
            return False
        logger.info("peak cap (max_peaks=%d) saturated — re-decoding "
                    "with K=%d", p.max_peaks, p.escalated().max_peaks)
        return True

    def _note_saturation(self, sat: np.ndarray) -> None:
        """Record + warn (once) on peak-cap saturation; ``sat`` is (18,)
        for single images or (B, 18) for batches."""
        self.last_peak_saturated = sat
        if sat.any() and not self._warned_saturation:
            parts = np.where(sat.reshape(-1, sat.shape[-1]).any(0))[0]
            logger.warning(
                "peak cap (max_peaks=%d) saturated for parts %s — "
                "crowded scene, low-score peaks may have been dropped; "
                "raise DecodeParams.max_peaks for unbounded-parity",
                self.decode_params.max_peaks, parts.tolist())
            self._warned_saturation = True

    def _decode_escalating(self, decode_fn: Callable[[DecodeParams],
                                                     Assembled]) -> Assembled:
        """``decode_fn(params)``, again with the escalated parameters when
        the peak cap saturated; returns numpy arrays and notes the
        saturation."""
        out = decode_fn(self.decode_params)
        if self._should_escalate(out.peak_saturated):
            out = decode_fn(self._decode_params(True))
        arrays = Assembled(*(t.cpu().numpy() for t in out))
        self._note_saturation(arrays.peak_saturated)
        return arrays

    def _decode_merged(self, merged: torch.Tensor,
                       upsample_size: float) -> List[Human]:
        """Decode a merged (H/8, W/8, 57) map at ``upsample_size``."""
        up_h = int(merged.shape[0] * float(upsample_size))
        up_w = int(merged.shape[1] * float(upsample_size))
        return self._humans(self._decode_escalating(
            lambda p: decode(merged, up_h, up_w, p)))

    @staticmethod
    def _humans(arrays: Assembled) -> List[Human]:
        return PoseArrays(
            coords=arrays.coords, scores=arrays.part_scores,
            part_valid=arrays.part_valid, human_scores=arrays.human_scores,
            human_valid=arrays.human_valid).to_humans()

    # ------------------------------------------------------------------
    # public API (reference signatures)
    # ------------------------------------------------------------------
    def inference(self, npimg: np.ndarray, resize_to_default: bool = True,
                  upsample_size: float = 1.0) -> List[Human]:
        """Run multi-person pose estimation on one image.

        ``upsample_size`` is the decode-resolution ratio relative to the
        stride-8 feature map (reference ``resize_out_ratio``). An image
        not at the target size is resized on the device when
        ``resize_to_default`` is set (see :func:`prepare`, or
        :func:`prepare_bilinear` with ``device_preprocess``).
        """
        if npimg is None:
            raise Exception(
                "The image is not valid. Please check your image exists.")
        if resize_to_default:
            net_w, net_h = self.target_size
        else:
            net_h, net_w = npimg.shape[:2]
        up_h = int(net_h / 8 * upsample_size)
        up_w = int(net_w / 8 * upsample_size)

        t = time.time()
        net_out = self._forward(npimg[None], net_h, net_w,
                                self.device_preprocess)[0]
        peaks_map, heat_up, paf_up = postprocess(
            net_out, up_h, up_w, self.decode_params)
        arrays = self._decode_escalating(
            lambda p: decode_maps(peaks_map, paf_up, p))
        self.heatMat = heat_up.cpu().numpy()
        self.pafMat = paf_up.cpu().numpy()
        logger.debug("inference in %.4f s", time.time() - t)
        return self._humans(arrays)

    def inference_batch(self, npimgs: Sequence[np.ndarray],
                        upsample_size: float = 1.0) -> List[List[Human]]:
        """Batched inference; each image is resized on the device to the
        target size if it is not at it (see :func:`prepare`)."""
        w, h = self.target_size
        up_h = int(h / 8 * upsample_size)
        up_w = int(w / 8 * upsample_size)
        if all(im.shape[:2] == (h, w) for im in npimgs):
            net_out = self._forward(np.stack(npimgs), h, w)
        else:  # images to resize: forward one by one
            net_out = torch.cat([self._forward(im[None], h, w)
                                 for im in npimgs])
        # on saturation the whole batch is decoded again: below-cap images
        # decode identically at larger K
        arrays = self._decode_escalating(
            lambda p: decode_batch(net_out, up_h, up_w, p))
        return [self._humans(Assembled(*(a[i] for a in arrays)))
                for i in range(len(npimgs))]

    def inference_windowed(self, npimg: np.ndarray,
                           upsample_size: float = 4.0,
                           overlap: float = 0.2) -> List[Human]:
        """Sliding-window inference for images larger than the network
        input: network-size windows at ``overlap``, one backbone batch,
        the maps merged on the device and decoded once at
        ``upsample_size`` times the merged stride-8 grid."""
        w, h = self.target_size
        img = torch.as_tensor(np.ascontiguousarray(npimg), device=self.device)
        with torch.inference_mode():
            merged = windowed_forward(self._forward_windows, img, h, w,
                                      overlap)
        return self._decode_merged(merged, upsample_size)

    def inference_multiscale(self, npimg: np.ndarray,
                             scales: Sequence[float] = (1.0, 1.5, 2.0),
                             upsample_size: float = 4.0,
                             overlap: float = 0.2) -> List[Human]:
        """Scale search: the image is evaluated at each scale with
        overlapping network-size windows (one backbone batch per scale),
        the stride-8 maps are merged across windows and averaged across
        scales on the device, and decoded once."""
        w, h = self.target_size
        img = torch.as_tensor(np.ascontiguousarray(npimg), device=self.device)
        with torch.inference_mode():
            merged = multiscale_forward(self._forward_windows, img, h, w,
                                        tuple(float(s) for s in scales),
                                        overlap)
        return self._decode_merged(merged, upsample_size)

    @staticmethod
    def draw_humans(npimg: np.ndarray, humans: List[Human],
                    imgcopy: bool = False) -> np.ndarray:
        return _draw_humans(npimg, humans, imgcopy)

    @staticmethod
    def _quantize_img(npimg: np.ndarray, bits: int = 8) -> np.ndarray:
        """Quantize an image to 2^bits levels (reference
        ``TfPoseEstimator._quantize_img``)."""
        levels = float(2 ** bits - 1)
        img = npimg.astype(np.float32) / 255.0
        return (np.round(img * levels) / levels * 255.0).astype(np.uint8)

    def get_flops(self) -> int:
        """FLOPs of one forward and decode at ``target_size`` (upsample
        4), as ``torch.utils.flop_counter.FlopCounterMode`` counts them:
        2 per multiply-add of each convolution and matmul. The decode at
        an integer ratio adds none (its work is elementwise, top-K and
        the decode kernels), so the figure is the backbone's convs; it
        runs on the estimator's device and is the same on every device.
        The JAX estimator's figure is XLA's cost analysis, which also
        counts elementwise work (reference: ``tf.profiler``)."""
        from torch.utils.flop_counter import FlopCounterMode

        w, h = self.target_size
        up_h, up_w = h // 8 * 4, w // 8 * 4
        img = np.zeros((1, h, w, 3), np.uint8)
        with FlopCounterMode(display=False) as counter:
            net_out = self._forward(img, h, w)[0]
            decode(net_out, up_h, up_w, self.decode_params)
        return int(counter.get_total_flops())
