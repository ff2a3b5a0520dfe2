#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfpose_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a flushed start and end line with elapsed seconds:
  0. device: the card's name and power limit; TF32 off for the parity
     phases (``cudnn.allow_tf32`` and ``cuda.matmul.allow_tf32``);
  1. build: compile the CUDA kernels under ``tfpose_tpu_torch/csrc/``;
  2. kernel parity: each kernel against its plain PyTorch version on the
     card, at the main path's shapes (B = 1 and 8, K = 32 and 128; the
     full-resolution top-K at 360x640x18 and 115x135x144, on noise and
     on a plateau with more peaks than its shared-memory list; both top-K
     kernels also through their radix-select path and at a blur length
     or factor that runs their run-time loops; the raw-grid top-K also
     bit for bit against its own phase arithmetic in PyTorch, on a
     plateau too; the smooth + NMS kernel bit for bit on the 4x, 2.5x
     and warm-up maps and at 13 taps; the candidate scorer bit for bit at
     B = 1 and 8, K = 32 and 128, on a 1280x720 frame's 90x160 grid, with
     a pair without valid peaks and without the row skip); and K1-K3 at
     the new backbones' grids on rendered maps: CMU's 46x82 (B = 1, 16;
     K2 at 184x328x19) and mobilenet_v2_small's 46x46 (B = 1, 8; K2 at
     184x184x19);
  3. main path: the mobilenet_thin estimator with the committed
     ``thin368_coco`` weights and 432x368 input, path by path, each with
     the launch counts set to 0 just before it and read just after:
     ``inference`` and ``inference_batch`` at upsample 4 on rendered
     432x368 scenes, ``inference_windowed`` on two rendered 1280x720
     frames and ``inference_multiscale`` (scales 1.0, 1.5) on one, at
     upsample 4, and ``inference_batch`` at upsample 2.5; every kernel
     must launch, the full-resolution top-K on each 720p and 2.5x path
     and the raw-grid one on no 720p path, and the humans must equal
     those of the same estimator on the CPU; its AP50 on 50 rendered
     432x368 scenes must reach 0.95 (``tests/test_coco_path.py``'s gate
     for ``thin368_coco``). The card's area downscale
     of a 1280x720 frame is held against the CPU's;
  4. backbones, path by path with the launch counts reset before each:
     ``mobilenet_v2_small`` at 368x368 (``inference`` x8 and
     ``inference_batch`` B=8) and ``mobilenet_v2_large`` at 432x368
     (``inference`` x4) with their committed checkpoints, humans equal to
     the CPU estimator's, and their AP50 on 50 / 25 rendered 160x160
     scenes at least 0.90 / 0.88 (``tests/test_coco_path.py``'s gates);
     ``cmu`` at 656x368 (``inference`` and ``inference_batch`` B=16) with
     seeded random weights (its 200 MB checkpoint is not read): its
     ``concat_stage7`` against the CPU forward of two frames (TF32 off),
     K1-K3 against their plain versions on the card's own CMU maps, and
     rendered 46x82 scene maps through ``decode_batch`` (B = 1, 16) and
     ``postprocess`` with humans equal to the CPU decode's;
  5. timing (CUDA events, after warm-up; device time per launch from
     ``torch.profiler``): each kernel (the two top-K kernels at both
     shapes of their paths: B = 1 and 8 at 4x; 360x640x18 and
     115x135x144; the candidate scorer at B = 1 and 8 and on the 90x160
     grid), ``inference``
     latency, ``inference_batch`` images per second at B = 1, 8, 16 and
     at upsample 2.5, and ``inference_windowed`` / ``inference_multiscale``
     latency on 1280x720 frames; ``torch.profiler`` breakdowns; and for
     the backbones of phase 4: latency (median, p90), images per second
     of the batches, and their profiles; K1-K3 at the new grids;
  6. serving, path by path with the launch counts reset before each:
     ``VideoPipeline`` (thin368_coco) on 24 rendered 640x480 frames at
     depths 1, 2 and 3 (forwards on their own CUDA stream), its humans
     bit for bit those of the serial loop (``video_serial``) and equal
     to the CPU's on the card's resized frames, with frames/s and the
     device's idle share; ``DynamicBatcher`` with 8 futures in one flush
     (histogram {8: 1}), humans equal to ``inference_batch``'s;
     ``PoseService`` on 127.0.0.1 at ``max_batch`` 1 and 8, raw frames
     through ``PoseClient.infer_raw``, replies equal to ``humans_to_msg``
     of the estimator's humans, round-trip median and p90;
     ``BatchedEvaluator`` with thin368_coco at batch 8 on 50 rendered
     432x368 scenes in fp32 and bf16, AP50 at least 0.95 each;
  7. bf16: thin368_coco and CMU (seeded) ``concat_stage7`` against fp32
     (thin: 99th percentile of |d| within 5 % and max within 35 % of the
     largest value; CMU: max within 5 %); thin ``inference`` x8 and
     ``inference_batch`` B=8 and CMU B=16 in bf16 through the kernels,
     the thin humans reported against fp32's; their times in turns with
     fp32's and one profile each;
  8. int8: thin368_coco calibrated on the card, its calibration against
     the CPU's (rtol 1e-5), ``inference`` x8 and ``inference_batch`` B=8
     through the kernels with the int8 maps equal to the CPU int8
     forward's bit for bit (the card's calibration in both) and the
     humans equal to the CPU int8 estimator's; AP50 on 50 rendered
     432x368 scenes at least 0.6 (``tests/test_quantize.py``'s int8 gate)
     beside fp32's; CMU (seeded) calibrated on the card, B=16 through
     the kernels and its int8 maps of two frames equal to the CPU's;
     the int8 accumulators of CMU's K = 9065 conv saturated at +-127
     equal to int64; times of thin ``inference`` and B=8 and CMU B=16,
     fp32 and int8 in turns, and a profile of each int8 call;
  9. train: ``tfpose-torch-train``'s ``main`` with mobilenet_thin at
     368x368, B=16, lr 3e-3, 30 steps on rendered scenes, in fp32, with
     ``--device-targets`` and in bf16: the mean loss of the last 3 steps
     below 0.85 of the first 3 (``tests/test_learning.py``'s bar), images
     per second and a profile of one step; one fp32 step's loss and
     gradients on the card against the CPU's (B=4); the exported
     ``params.msgpack`` loaded by
     ``TfPoseEstimator`` on the card, whose maps equal the trainer's
     network's;
 10. conversion and profiling, path by path with the launch counts
     reset before each: the Datum shard that the JAX writer wrote
     (``tests/fixtures/datum_jax.tpds``) re-serialized byte for byte, its
     raw records unpacked and written again byte for byte, and
     ``tfpose-torch-train --datum-shard`` on them (thin 64x80, B=4, 2
     steps); TensorFlow's GraphDef (``tests/fixtures/graphdef_tf.pb``)
     read bit for bit; ``thin368_coco`` written as a GraphDef, converted
     by ``convert_pb_file`` (msgpack bytes equal to ``save_flax_msgpack``
     of the variables) and loaded by an estimator whose ``inference`` x2
     (K2) and ``inference_batch`` B=8 (K1, K3) give the checkpoint's
     humans and maps bit for bit; ``trace`` of one ``inference`` naming
     K2's kernel and cuDNN's convs; ``device_p50_ms`` of the thin forward
     at most its CUDA-event median at B=1 (host-bound) and within a
     factor 1.5 of it at B=32 (device-bound); ``amortized_ms``,
     ``StageTimer``; ``get_flops`` equal on the card and the CPU;
 11. mesh (``parallel/``), ranks started by ``launch`` (``spawn``; the
     rank bodies are this script's top-level functions), each counting
     its kernels' launches per path (``launches_by_path`` keys
     ``mesh <leg> <path>/rank<r>``): NCCL with one rank on the card
     (``BatchedEvaluator(mesh=make_mesh())`` with thin368_coco on 16
     rendered 432x368 scenes, its humans and detections equal to the
     unsharded evaluator's exactly; two train steps of the seeded thin at
     368x368, B=16, the state equal to the unsharded steps' bit for bit,
     with cuDNN's deterministic algorithms in both); gloo with two ranks
     sharing the card (the thin368 forward of the 16 scenes on a (1 x 2)
     mesh, row halos exchanged, within atol 1e-4 of the unsharded
     forward; the evaluator on (2 x 1), every rank's humans equal to the
     unsharded ones: parts exact, coords 1e-6, scores 1e-4); gloo with
     four ranks sharing the card (one train step on (2 x 2) against the
     unsharded step: loss rtol 1e-5, BN statistics rtol 1e-5 with atol
     1e-7, parameters atol 2.1e-4, gradients through Adam's first moment
     within 0.15 of the largest, the four states equal bit for bit); the
     collectives' and one halo exchange's host times;
 12. parity sweep (``evaluation/parity_sweep.py``) on the card: the
     recipe scenes (as many rounds of the 8 recipes as ~30 s of the
     host's NumPy oracle allow, at least 2 scenes per recipe) and 8
     rendered 432x368 scenes through thin368_coco, decoded by
     ``decode_adaptive`` (K1 and K3; K1 again at K=128 where a scene
     escalates) against the NumPy oracle, and every other default scene
     against the C++ oracle where ``g++`` is present: 0 mismatches.
 13. tools, path by path with the launch counts reset before each: the
     broadcaster (``cli/broadcaster.py:build_service``, thin368_coco as
     the model's converted checkpoint, 432x368, upsample 4) on
     127.0.0.1 at ``--max-batch`` 1 and 8, 8 rendered 640x480 frames
     through ``cli/visualization.py:annotate``, the humans equal to
     ``inference``'s on the card (parts exact, coords 1e-6, scores
     1e-4), K2 launched 8 times at 1 and K1 and K3 once per flush at 8;
     BASELINE config 5 (``evaluation/backbone_sweep.py``, bf16, 50
     scenes each, with throughput) over thin368_coco, v2large160_coco,
     v2small160_coco and v1full160_coco, each AP50 at least its gate in
     ``tests/test_coco_path.py`` (0.95, 0.88, 0.90, 0.92; the CMU row's
     checkpoint stays off the card); through ``tfpose-torch-profile``'s
     ``main``, the decode's stages (``profiles/stages.py``) at B = 1 and
     16, the forward's device profile (``profiles/forward.py``) of thin
     at B = 1 and 16 and CMU at B = 1 and 8, and CMU's per-op table at
     B = 8 (``profiles/ops.py``), each printed as a JSON line of its
     own.

Any failed check raises, so the run exits non-zero and prints no result.
The last lines are the kernels driven, one JSON line per the kernels'
numbers, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. The script imports torch, numpy and
the port only, and writes nothing outside ``tfpose_tpu_torch/_build/``
(phase 9's checkpoints go to ``_build/chip_smoke_train/``, phase 10's
files to ``_build/chip_smoke_convert/``, phase 12's C++ oracle library
to ``_build/``, phase 13's model link and sweep document to
``_build/chip_smoke_models/`` and ``_build/chip_smoke_sweep.json``) but
phase 11's rendezvous files and the profiles' traces, in temporary
directories that are removed.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
CHECKPOINT = os.path.join(ROOT, "models", "trained", "thin368_coco",
                          "params.msgpack")
V2_CHECKPOINTS = {
    name: os.path.join(ROOT, "models", "trained", ckpt, "params.msgpack")
    for name, ckpt in (("mobilenet_v2_small", "v2small160_coco"),
                       ("mobilenet_v2_large", "v2large160_coco"))}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    log(f"phase {name}: start")
    try:
        yield
    except BaseException:
        log(f"phase {name}: FAILED after {time.perf_counter() - t:.2f} s")
        raise
    log(f"phase {name}: done in {time.perf_counter() - t:.2f} s")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_cuda(fn, reps: int = 30, inner: int = 10):
    """(median, p90) ms per call: CUDA events around ``inner`` calls,
    ``reps`` times, after two warm-up calls."""
    import numpy as np
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return float(np.median(per)), float(np.percentile(per, 90))


def time_host(fn, reps: int):
    """(median, p90) seconds per call of a function that synchronises."""
    import numpy as np

    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)), float(np.percentile(ts, 90))


def profile_calls(fn, n: int = 3):
    """Device time by kernel over ``n`` calls (torch.profiler, CUPTI):
    (wall ms per call, device-busy ms per call, kernels per call,
    [(kernel name, device ms per call, launches per call), ...] sorted by
    device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / n * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3 / n, e.count / n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return wall, busy, sum(r[2] for r in rows), rows


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / H100_BYTES_PER_S * 1e3
    t_f = flops / H100_FP32_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def k2_compare(got, want, what: str) -> None:
    """K2 against its plain version: bit for bit (both blur in tap order
    with every product and sum rounded, then the same 3x3 NMS), plateaus
    included."""
    import torch

    check(torch.equal(got, want), f"K2 differs from its plain version on "
          f"{what}: {int((got != want).sum())} values")


def k3_compare(got, want, what: str) -> None:
    """K3 against its plain version: ``ok`` and ``score`` bit for bit
    (the kernel rounds every step as the PyTorch ops do)."""
    import torch

    check(torch.equal(got.ok, want.ok), f"K3 ok differs on {what}: "
          f"{int((got.ok != want.ok).sum())} candidates")
    check(torch.equal(got.score, want.score), f"K3 score differs on {what}: "
          f"max |d| {(got.score - want.score).abs().max().item():.3g}")


def heat8_of(net_b):
    """(B, h8, w8, 57) -> the (h8, w8, B*18) part planes, as decode_batch
    flattens them for K1."""
    h8, w8 = net_b.shape[1:3]
    return net_b[..., :18].permute(1, 2, 0, 3).reshape(h8, w8, -1)


def peaks_of(s, i, b, up_w):
    """The top-K kernels' (scores, flat indices) of b * 18 planes as the
    Peaks (b, 18, K) that decode_batch scores."""
    from tfpose_tpu_torch.ops.nms import Peaks

    s, i = s.reshape(b, 18, -1), i.reshape(b, 18, -1).clamp(min=0)
    return Peaks(x=i % up_w, y=i // up_w, score=s, valid=s > 0.05)


def k4_compare(got, want):
    """K4 against its plain version: indices exact, scores within 1e-6
    (both sum the taps in one order with no fused multiply-add).
    Returns max |d| of the scores."""
    import torch

    (s, i), (s0, i0) = got, want
    check(torch.equal(i, i0), "K4 indices differ from the plain version's")
    d = (s - s0).abs().max().item() if s.numel() else 0.0
    check(d <= 1e-6, f"K4 scores max |d| {d:.3g} > 1e-6")
    return d


def k1_phase_reference(heat8, fy, fx, k_top, thresh, kernlen=25, nsig=3.0):
    """The raw-grid top-K's own arithmetic in PyTorch, one op at a time:
    the vertical phase sums V, then the smoothed values S, each summed in
    tap order with taps t > 0 of weight 0 skipped, then the plain
    version's 3x3 NMS, threshold and stable top-K. (h8, w8, C) ->
    (scores, idx). Unlike the plain version (a blur of the replicated
    plane), it rounds as the kernel does, so the kernel equals it bit for
    bit, on a plateau too, where the two summation orders pick other
    peaks among equal values."""
    import torch
    import torch.nn.functional as F

    from tfpose_tpu_torch.ops.gaussian import gauss_kernel_1d
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        _phase_weights, topk_of_smoothed)

    p = kernlen // 2
    kern = gauss_kernel_1d(kernlen, nsig)
    wv, dvmin, _ = _phase_weights(kern, fy, p)
    wh, dhmin, _ = _phase_weights(kern, fx, p)
    h8, w8, c = heat8.shape
    nv, nh = wv.shape[1], wh.shape[1]
    x = F.pad(heat8.permute(2, 0, 1).float(), (-dhmin, nh, -dvmin, nv))

    def taps_sum(w, view):
        acc = float(w[0]) * view(0)
        for t in range(1, len(w)):
            if w[t] != 0:
                acc = acc + float(w[t]) * view(t)
        return acc

    vw = w8 + nh - 1
    v = torch.stack([taps_sum(wv[a], lambda t: x[:, t:t + h8, :vw])
                     for a in range(fy)], 2).reshape(c, fy * h8, vw)
    sm = torch.stack([taps_sum(wh[b], lambda t: v[:, :, t:t + w8])
                      for b in range(fx)], 3).reshape(c, fy * h8, fx * w8)
    return topk_of_smoothed(sm, k_top, thresh)


WINDOWED = "inference_windowed 1280x720 x2 (4x)"
MULTISCALE = "inference_multiscale 1280x720 scales (1.0, 1.5) (4x)"
BATCH25 = "inference_batch B=8 (2.5x)"
V2S_INF = "mobilenet_v2_small inference x8 368x368 (4x)"
V2S_BATCH = "mobilenet_v2_small inference_batch B=8 368x368 (4x)"
V2L_INF = "mobilenet_v2_large inference x4 432x368 (4x)"
CMU_INF = "cmu inference 656x368 (4x)"
CMU_BATCH = "cmu inference_batch B=16 656x368 (4x)"
CMU_MAPS = "cmu rendered 46x82 maps: decode_batch B=1, B=16, postprocess"


def planes_up(net_b, up_h, up_w):
    """(B, h8, w8, 57) -> the (up_h, up_w, B*18) view of channel-first
    area-upsampled part planes that decode_batch gives K4."""
    from tfpose_tpu_torch.ops import resize

    heat = resize.resize_area(net_b[..., :19], up_h, up_w)[..., :18]
    return heat.permute(0, 3, 1, 2).reshape(-1, up_h, up_w).permute(1, 2, 0)


def scene_nets(seed, people, h8, w8):
    """Rendered (len(people), h8, w8, 57) net outputs of people[i]
    people each."""
    import numpy as np

    from tfpose_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    return np.stack([synthetic.render_scene(rng, n, h8, w8)[0]
                     for n in people])


def humans_of(out):
    """A batched decode result -> a list of human lists."""
    from tfpose_tpu_torch.estimator import TfPoseEstimator
    from tfpose_tpu_torch.ops.assemble import Assembled

    arrays = Assembled(*(t.cpu().numpy() for t in out))
    return [TfPoseEstimator._humans(Assembled(*(a[i] for a in arrays)))
            for i in range(arrays.coords.shape[0])]


def render_frames(rng, n, h, w):
    """``n`` rendered frames of 1-3 separated people at (h, w)."""
    from tfpose_tpu_torch.utils import synthetic

    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 4)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, h, w, rng))
    return out


def video_serial(est, frames, upsample_size: float = 4.0):
    """The serial loop that ``VideoPipeline`` must equal bit for bit:
    each frame's forward, then its decode without escalation, on the
    current stream, one frame after the other."""
    from tfpose_tpu_torch.ops.assemble import Assembled
    from tfpose_tpu_torch.ops.decode import decode

    w, h = est.target_size
    out = []
    for frame in frames:
        net = est._forward(frame[None], h, w)[0]
        res = decode(net, int(h / 8 * upsample_size),
                     int(w / 8 * upsample_size), est.decode_params)
        out.append(est._humans(Assembled(*(t.cpu().numpy() for t in res))))
    return out


def rendered_coco(n, w, h, seed=7):
    """``synthetic_e2e``'s scenes as ``BatchedEvaluator.evaluate`` takes
    them: ([(image_id, image, (w, h)), ...], COCO ground truth by id)."""
    import numpy as np

    from tfpose_tpu_torch.evaluation.coco_eval import person_to_gt
    from tfpose_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    items, gts = [], {}
    for idx in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 3)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        items.append((idx, synthetic.render_image(people, h, w, rng),
                      (w, h)))
        gts[idx] = [person_to_gt(p) for p in people]
    return items, gts


def same_persons(got, want, what: str) -> None:
    """Equal ``Persons`` except the stamp: part ids exact, x and y within
    1e-6, confidences within 1e-4."""
    check((got.image_w, got.image_h) == (want.image_w, want.image_h),
          f"{what}: image size")
    g = [[(b.part_id, b.x, b.y, b.confidence) for b in p.body_part]
         for p in got.persons]
    w = [[(b.part_id, b.x, b.y, b.confidence) for b in p.body_part]
         for p in want.persons]
    check([[b[0] for b in p] for p in g] == [[b[0] for b in p] for p in w],
          f"{what}: part ids differ")
    for pg, pw in zip(g, w):
        for bg, bw in zip(pg, pw):
            check(abs(bg[1] - bw[1]) <= 1e-6 and abs(bg[2] - bw[2]) <= 1e-6
                  and abs(bg[3] - bw[3]) <= 1e-4,
                  f"{what}: part {bg[0]} {bg[1:]} vs {bw[1:]}")


def humans_key(humans):
    return [(h.score, {p: (b.x, b.y, b.score) for p, b in
                       h.body_parts.items()}) for h in humans]


def same_humans(got, want, what: str) -> None:
    """Same humans, same part sets, coords within 1e-6, scores 1e-4."""
    g, w = humans_key(got), humans_key(want)
    check(len(g) == len(w), f"{what}: {len(g)} humans on the card, "
          f"{len(w)} on the CPU")
    for (s1, p1), (s2, p2) in zip(g, w):
        check(p1.keys() == p2.keys(), f"{what}: part sets differ")
        check(abs(s1 - s2) <= 1e-4, f"{what}: human score {s1} vs {s2}")
        for k in p1:
            check(abs(p1[k][0] - p2[k][0]) <= 1e-6
                  and abs(p1[k][1] - p2[k][1]) <= 1e-6,
                  f"{what}: part {k} coords {p1[k][:2]} vs {p2[k][:2]}")
            check(abs(p1[k][2] - p2[k][2]) <= 1e-4,
                  f"{what}: part {k} score {p1[k][2]} vs {p2[k][2]}")


# ---- phase 11's ranks. Spawned ranks import this script (not as
# __main__), so they are top-level functions; each resets the kernels'
# launch counts before its path and returns them with its results.

def kernel_wrappers():
    """The four kernels' wrappers, by name; each counts its launches."""
    from tfpose_tpu_torch.ops.kernels.paf_score import score_candidates_raw
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        smooth_nms, smooth_nms_topk, smooth_nms_topk_raw)

    return {"smooth_nms_topk_raw": smooth_nms_topk_raw,
            "smooth_nms": smooth_nms,
            "score_candidates_raw": score_candidates_raw,
            "smooth_nms_topk": smooth_nms_topk}


def counted(run):
    """``run()`` with every launch count set to 0 just before it and
    read just after: (its result, {kernel: launches})."""
    import torch

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in wrappers.items()}


def seeded_thin():
    """mobilenet_thin with seeded weights, on the CPU (the train legs)."""
    import torch

    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.models.layers import init_weights

    return init_weights(get_network("mobilenet_thin"),
                        torch.Generator().manual_seed(0))


def train_steps(batches, mesh=None, device=None):
    """``len(batches)`` train steps of the seeded thin at lr 1e-4 (on
    ``mesh``, or unsharded on ``device``): (losses, the state's tensors
    as numpy, one dict: parameters and buffers by name, then 'mu/...'
    and 'nu/...')."""
    from tfpose_tpu_torch.parallel.mesh import (
        assert_replicas_equal, replicated)
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step, replica_tensors)

    net = seeded_thin().to(mesh.device if mesh else device)
    if mesh is not None:
        replicated(mesh, net)
    state = TrainState.create(net, make_optimizer(1e-4))
    step = make_train_step(mesh=mesh)
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    if mesh is not None:
        assert_replicas_equal(mesh, replica_tensors(state))
    out = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    for which in ("mu", "nu"):
        out.update({f"{which}/{k}": v.cpu().numpy()
                    for k, v in getattr(state, which).items()})
    return losses, out


def evaluate_on(mesh, items, device=None, spatial=False):
    """thin368_coco's ``BatchedEvaluator`` (fp32, batch 8) on ``items``
    (on ``mesh``, its rows split too with ``spatial``, or unsharded on
    ``device``): (the human lists of each batch, their COCO
    detections)."""
    import numpy as np

    from tfpose_tpu_torch.evaluation.coco_eval import humans_to_detections
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator

    kw = (dict(mesh=mesh, spatial=spatial) if mesh is not None
          else dict(device=device))
    ev = BatchedEvaluator("mobilenet_thin", (432, 368), batch_size=8,
                          dtype="float32", **kw)
    ev.load_params(CHECKPOINT)
    humans = [ev.run_batch(np.stack([img for _, img, _ in items[i:i + 8]]))
              for i in range(0, len(items), 8)]
    dets = [d for hs, (image_id, _, (w, h)) in zip(
        [h for batch in humans for h in batch], items)
        for d in humans_to_detections(hs, image_id, w, h)]
    return humans, dets


def time_host_ms(fn, reps: int = 10):
    """Median host milliseconds of ``fn()`` ending in a synchronize."""
    import torch

    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(sorted(times[2:])[len(times[2:]) // 2])


def time_collectives(mesh, halo_shape):
    """Median ms of a gradient-sized ``all_reduce`` (mobilenet_thin's
    2,213,850 fp32 values) over the world and, on a spatial mesh, of one
    halo exchange of a ``halo_shape`` NCHW block's rows for a 3x3 conv."""
    import torch
    import torch.distributed as dist

    from tfpose_tpu_torch.parallel import halo
    from tfpose_tpu_torch.parallel.mesh import sharded

    grads = torch.ones(2213850, device=mesh.device)
    out = {"all_reduce_grads_ms": time_host_ms(
        lambda: dist.all_reduce(grads, group=mesh.world))}
    if mesh.n_spatial > 1:
        n, c, h, w = halo_shape
        rows = halo.row_bounds(h, mesh.n_spatial)
        x = torch.ones((n, c, rows[mesh.spatial_index + 1]
                        - rows[mesh.spatial_index], w), device=mesh.device)
        with sharded(mesh, image_hw=(h, w)):
            shard = halo.current_rows()
            out["halo_exchange_ms"] = time_host_ms(
                lambda: halo.window(x, shard, 2, h, 3, 1, 1, 0.0))
    return out


def rank_nccl(items, batches, devices=None):
    """Leg 1: NCCL, one rank on the card: the evaluator on
    ``make_mesh()`` (the visible cards) and two train steps on it."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=devices)
    t = time.perf_counter()
    (humans, dets), eval_counts = counted(lambda: evaluate_on(mesh, items))
    eval_s = time.perf_counter() - t
    t = time.perf_counter()
    (losses, state), train_counts = counted(lambda: train_steps(batches,
                                                                mesh))
    return {"shape": mesh.shape, "humans": humans, "dets": dets,
            "losses": losses, "state": state, "eval_s": eval_s,
            "train_s": time.perf_counter() - t,
            "launches": {"eval": eval_counts, "train": train_counts},
            "times": time_collectives(mesh, None)}


def rank_nccl_deterministic(items, batches, devices=None):
    """Leg 1 with cuDNN's deterministic algorithms, as the unsharded
    references take them (a bit-for-bit comparison)."""
    import torch

    torch.backends.cudnn.deterministic = True
    return rank_nccl(items, batches, devices)


def sharded_forward(mesh, imgs):
    """thin368_coco on ``mesh`` and a function that runs its forward of
    the uint8 ``imgs`` (rows and batch split as the mesh says) and
    gathers the whole (N, H/8, W/8, 57) maps on every rank."""
    import numpy as np
    import torch

    from tfpose_tpu_torch.convert.checkpoint import (
        load_flax_msgpack, variables_from_numpy)
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.parallel.halo import row_bounds
    from tfpose_tpu_torch.parallel.mesh import (
        gather_blocks, replicated, shard_batch, sharded)
    from tfpose_tpu_torch.pipeline.preprocess import normalize

    net = get_network("mobilenet_thin")
    variables_from_numpy(net, load_flax_msgpack(CHECKPOINT))
    replicated(mesh, net.eval().to(mesh.device))
    x = torch.as_tensor(np.stack(imgs), device=mesh.device)
    n, h, w = x.shape[:3]

    def forward():
        with sharded(mesh, image_hw=(h, w)):
            local = run_backbone(net, normalize(shard_batch(mesh, x)))
        local = gather_blocks(local, row_bounds(-(-h // 8), mesh.n_spatial),
                              mesh.spatial_index, mesh.spatial, dim=1)
        return gather_blocks(local, row_bounds(n, mesh.n_data),
                             mesh.data_index, mesh.data)

    return forward


def rank_gloo2(imgs, items, devices):
    """Legs 2 and 4: gloo, two ranks sharing the card. The thin368_coco
    forward of ``imgs`` on a (1 x 2) mesh, gathered; the evaluator on a
    (2 x 1) mesh."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    rows = make_mesh(1, 2, devices)
    data = make_mesh(2, 1, devices)
    forward = sharded_forward(rows, imgs)
    t = time.perf_counter()
    maps, fwd_counts = counted(forward)
    fwd_s = time.perf_counter() - t
    fwd_ms = time_host_ms(forward, reps=5)
    t = time.perf_counter()
    (humans, dets), eval_counts = counted(lambda: evaluate_on(data, items))
    return {"maps": maps.cpu().numpy(), "humans": humans, "dets": dets,
            "fwd_s": fwd_s, "fwd_ms": fwd_ms,
            "eval_s": time.perf_counter() - t,
            "launches": {"forward": fwd_counts, "eval": eval_counts},
            "times": time_collectives(rows, (8, 24, 184, 216))}


def rank_gloo4(batches, devices):
    """Leg 3: gloo, four ranks sharing the card: one train step of the
    seeded thin on a (2 x 2) mesh (its end checks the four states equal
    bit for bit)."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, devices)
    t = time.perf_counter()
    (losses, state), counts = counted(lambda: train_steps(batches, mesh))
    return {"losses": losses, "state": state if mesh.rank == 0 else None,
            "train_s": time.perf_counter() - t,
            "launches": {"train": counts},
            "times": time_collectives(mesh, (8, 24, 184, 184))}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "tfpose_tpu_torch", "csrc")):
        print("chip_smoke: tfpose_tpu_torch/ is not next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1

    from tfpose_tpu_torch.core.config import DecodeParams
    from tfpose_tpu_torch.estimator import TfPoseEstimator
    from tfpose_tpu_torch.evaluation.coco_eval import synthetic_e2e
    from tfpose_tpu_torch.models import get_checkpoint_path
    from tfpose_tpu_torch.ops.decode import (
        decode_batch, decode_maps, postprocess)
    from tfpose_tpu_torch.ops import resize
    from tfpose_tpu_torch.ops.kernels import build
    from tfpose_tpu_torch.core.topology import pairs_array
    from tfpose_tpu_torch.ops.kernels.paf_score import (
        candidate_geometry, score_candidates_raw, score_candidates_raw_plain)
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        LIST_CAP, _phase_tables, blur_in_tap_order, smooth_nms,
        smooth_nms_plain, smooth_nms_topk, smooth_nms_topk_plain,
        smooth_nms_topk_raw, smooth_nms_topk_raw_plain)
    from tfpose_tpu_torch.ops.nms import max3x3
    from tfpose_tpu_torch.pipeline.multiscale import windowed_forward
    from tfpose_tpu_torch.pipeline.preprocess import downscale_area
    from tfpose_tpu_torch.utils import synthetic
    from tfpose_tpu_torch.utils.profiling import card_name_and_power

    dev = torch.device("cuda")
    wrappers = {"smooth_nms_topk_raw": smooth_nms_topk_raw,
                "smooth_nms": smooth_nms,
                "score_candidates_raw": score_candidates_raw,
                "smooth_nms_topk": smooth_nms_topk}
    err = {name: 0.0 for name in wrappers}
    params = DecodeParams()

    with phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        smi = card_name_and_power()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__}"
            f" cuda {torch.version.cuda} | TF32 off for the parity phases")

    with phase("1 build"):
        secs = build.build_all()
        log(f"built {len(build.build_log)} kernel libraries in {secs:.2f} s "
            f"into {build.build_dir()}, one nvcc each, started together")
        for stem in ("smooth_nms_topk_raw", "smooth_nms", "paf_score",
                     "smooth_nms_topk"):
            t = build.build_seconds.get(stem)
            log(f"  build {stem}: " + (f"{t:.2f} s" if t is not None else
                                       "found built from these sources"))
        for stem, out in sorted(build.build_log.items()):
            for line in out.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    log(f"  ptxas {stem}: {line.strip()}")

    # ---- inputs at the main path's shapes: B = 8 rendered net outputs
    rng = np.random.default_rng(0)
    scenes = [synthetic.render_scene(rng, n, 46, 54)[0]
              for n in (3, 1, 5, 0, 2, 6, 4, 2)]
    nets = torch.from_numpy(np.stack(scenes)).to(dev)     # (8, 46, 54, 57)
    noise = torch.from_numpy(rng.normal(0, 0.3, (46, 54, 18)).astype(
        np.float32)).to(dev)

    def k1_pair(x, k, cap=None, f=4, plain=True):
        """K1 against its plain version (indices exact, scores rtol 1e-5)
        and bit for bit against its own phase arithmetic."""
        kw = {} if cap is None else {"cap": cap}
        s, i = smooth_nms_topk_raw(x.contiguous(), f, f, k, 0.05, **kw)
        s1, i1 = k1_phase_reference(x, f, f, k, 0.05)
        torch.cuda.synchronize()
        check(torch.equal(i, i1) and torch.equal(s, s1),
              f"K1 differs from its phase arithmetic (K={k}, cap={cap}, f={f})")
        if plain:
            s0, i0 = smooth_nms_topk_raw_plain(x, f, f, k, 0.05)
            check(torch.equal(i, i0), f"K1 indices differ (K={k}, cap={cap})")
            rel = ((s - s0).abs() / s0.abs().clamp(min=1e-30)).max().item()
            check(rel <= 1e-5, f"K1 scores rel err {rel:.3g} > 1e-5")
            err["smooth_nms_topk_raw"] = max(err["smooth_nms_topk_raw"],
                                             (s - s0).abs().max().item())
        return s, i

    with phase("2 kernel parity"):
        for b in (1, 8):
            for k in (32, 128):
                s, i = k1_pair(heat8_of(nets[:b]), k)
                log(f"K1 smooth_nms_topk_raw B={b} K={k}: "
                    f"{int((i >= 0).sum())} peaks, indices equal")
        for k in (32, 128):
            s, i = k1_pair(noise, k)
            log(f"K1 noise K={k}: {int((i >= 0).sum())} peaks"
                f"{' (saturated)' if bool((i >= 0).all()) else ''}")
        for k in (32, 128):
            k1_pair(noise, k, cap=16)  # more peaks than the list: radix path
        log("K1 radix select (cap=16) equals the plain version")
        s, i = k1_pair(heat8_of(nets), 32, f=2)
        log(f"K1 at 2x (run-time loops) B=8: {int((i >= 0).sum())} peaks, "
            f"indices equal")
        flat = torch.full((46, 54, 2), 0.5, device=dev)
        flat[..., 1] = 0.01  # a plane with no peak above 0.05
        for cap in (LIST_CAP, 16):
            s, i = k1_pair(flat, 128, cap=cap, plain=False)
        check(bool((i[1] == -1).all()), "K1 found a peak below thresh")
        log(f"K1 plateau K=128: {int((i[0] >= 0).sum())} peaks, bit for bit "
            f"equal to its phase arithmetic (cap {LIST_CAP} and 16)")

        # K2 on the maps inference() gives it: 4x and 2.5x of the 46x54
        # grid, and the warm-up's 1x maps of 432x368, 208x176 and 96x80
        for shape, kernlen in (((184, 216), 25), ((46, 54), 25),
                               ((115, 135), 25), ((10, 12), 25),
                               ((22, 26), 25), ((184, 216), 13)):
            heat_up = resize.resize_area(nets[0, ..., :19], *shape).contiguous()
            got = smooth_nms(heat_up, kernlen)
            k2_compare(got, smooth_nms_plain(heat_up, kernlen),
                       f"{tuple(heat_up.shape)}, {kernlen} taps")
            log(f"K2 smooth_nms {tuple(heat_up.shape)} {kernlen} taps: bit for "
                f"bit, {int((got > 0.05).sum())} values above 0.05 kept")

        pairs = pairs_array()

        def k3_pair(pk, paf8, up_h, up_w, what, prefix_valid=True):
            kw = dict(prefix_valid=prefix_valid)
            got = score_candidates_raw(pk, paf8, up_h, up_w, params, **kw)
            want = score_candidates_raw_plain(pk, paf8, up_h, up_w, params,
                                              **kw)
            k3_compare(got, want, what)
            log(f"K3 score_candidates_raw {what} {tuple(got.ok.shape)}"
                f"{'' if prefix_valid else ' without the row skip'}: ok and "
                f"score bit for bit, {int(got.ok.sum())} candidates ok")
            return got

        for b in (1, 8):
            for k in (32, 128):
                pk = peaks_of(*smooth_nms_topk_raw(
                    heat8_of(nets[:b]).contiguous(), 4, 4, k, 0.05), b, 216)
                # no valid peak of pair 0's first part in image 0: nrows 0
                valid = pk.valid.clone()
                valid[0, pairs[0, 0]] = False
                got = k3_pair(pk._replace(valid=valid), nets[:b, ..., 19:],
                              184, 216, f"B={b} K={k}")
                check(not bool(got.ok[0, 0].any()), "K3 ok on a dead pair")
        k3_pair(pk, nets[..., 19:], 184, 216, "B=8 K=128", prefix_valid=False)

        # K4 on (up_h, up_w, C) views of channel-first planes, as
        # decode_batch hands them over
        def k4_pair(x, k, what, cap=LIST_CAP):
            got = smooth_nms_topk(x, k, 0.05, cap=cap)
            d = k4_compare(got, smooth_nms_topk_plain(x, k, 0.05))
            err["smooth_nms_topk"] = max(err["smooth_nms_topk"], d)
            log(f"K4 smooth_nms_topk {what} {tuple(x.shape)} K={k} "
                f"cap={cap}: {int((got[1] >= 0).sum())} peaks kept, "
                f"indices equal, scores max |d| {d:.3g}")

        rng4 = np.random.default_rng(4)
        net720 = torch.from_numpy(
            synthetic.render_scene(rng4, 3, 90, 160)[0]).to(dev)
        x720 = planes_up(net720[None], 360, 640)
        for k in (32, 128):
            k4_pair(x720, k, "720p scene at 4x")
        k4_pair(x720, 32, "720p scene, radix select", cap=32)
        noise720 = torch.from_numpy(rng4.normal(
            0.1, 0.3, (360, 640, 18)).astype(np.float32)).to(dev)
        for k in (32, 128):
            k4_pair(noise720, k, "noise")
        k4_pair(planes_up(nets, 115, 135), 32, "B=8 at 2.5x")
        got = smooth_nms_topk(x720, 32, 0.05, kernlen=13)
        d = k4_compare(got, smooth_nms_topk_plain(x720, 32, 0.05, 13))
        log(f"K4 13 taps (run-time loops) {tuple(x720.shape)}: "
            f"{int((got[1] >= 0).sum())} peaks, indices equal, |d| {d:.3g}")
        plateau = torch.full((360, 640, 2), 0.5, device=dev)
        plateau[..., 1] = 0.01  # a plane with no peak above 0.05
        sm = blur_in_tap_order(plateau.permute(2, 0, 1))
        n_peaks = int(((sm >= max3x3(sm)) & (sm > 0.05))[0].sum())
        check(n_peaks > LIST_CAP, "the plateau fits the shared list")
        k4_pair(plateau, 128, f"plateau of {n_peaks} peaks")
        # K3 on the windowed path's merged 90x160 grid at 4x
        for k in (32, 128):
            k3_pair(peaks_of(*smooth_nms_topk(x720, k, 0.05), 1, 640),
                    net720[None, ..., 19:], 360, 640, f"90x160 grid K={k}")

        # the new backbones' grids at 4x: CMU at 656x368 (46x82, B = 16)
        # and mobilenet_v2_small at 368x368 (46x46, B = 8)
        grid_nets = {
            (46, 82): torch.from_numpy(scene_nets(
                82, [3, 1, 5, 0, 2, 6, 4, 2] * 2, 46, 82)).to(dev),
            (46, 46): torch.from_numpy(scene_nets(
                46, [2, 1, 3, 0, 2, 4, 1, 2], 46, 46)).to(dev)}
        for (h8, w8), net_g in grid_nets.items():
            up_h, up_w = 4 * h8, 4 * w8
            for b in (1, len(net_g)):
                for k in (32, 128):
                    s, i = k1_pair(heat8_of(net_g[:b]), k)
                    log(f"K1 at {h8}x{w8} B={b} K={k} "
                        f"{tuple(heat8_of(net_g[:b]).shape)}: "
                        f"{int((i >= 0).sum())} peaks, indices equal")
                pk = peaks_of(*smooth_nms_topk_raw(
                    heat8_of(net_g[:b]).contiguous(), 4, 4, 32, 0.05), b,
                    up_w)
                got = k3_pair(pk, net_g[:b, ..., 19:], up_h, up_w,
                              f"{h8}x{w8} B={b} K=32")
                check(bool(got.ok.any()), f"K3 at {h8}x{w8}: nothing ok")
            heat_up = resize.resize_area(net_g[0, ..., :19], up_h,
                                         up_w).contiguous()
            got = smooth_nms(heat_up)
            k2_compare(got, smooth_nms_plain(heat_up),
                       f"{tuple(heat_up.shape)}")
            log(f"K2 smooth_nms {tuple(heat_up.shape)}: bit for bit, "
                f"{int((got > 0.05).sum())} values above 0.05 kept")

    with phase("3 main path"):
        imgs = render_frames(np.random.default_rng(7), 8, 368, 432)
        frames = render_frames(np.random.default_rng(720), 2, 720, 1280)
        t = time.perf_counter()
        est = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                              params_path=CHECKPOINT)
        log(f"estimator on {est.device} with {CHECKPOINT} (read by "
            f"load_flax_msgpack) in {time.perf_counter() - t:.2f} s")
        check(next(est.net.parameters()).is_cuda, "estimator not on the card")
        est_cpu = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                                  params_path=CHECKPOINT, device="cpu")

        # each path returns a list of per-image human lists
        paths = {
            "inference x8 (4x)": lambda e: [
                e.inference(img, upsample_size=4.0) for img in imgs],
            "inference_batch B=8 (4x)": lambda e: e.inference_batch(
                imgs, upsample_size=4.0),
            WINDOWED: lambda e: [e.inference_windowed(f, upsample_size=4.0)
                                 for f in frames],
            MULTISCALE: lambda e: [e.inference_multiscale(
                frames[0], scales=(1.0, 1.5), upsample_size=4.0)],
            BATCH25: lambda e: e.inference_batch(imgs, upsample_size=2.5),
        }
        path_launches, results = {}, {}
        for path, run in paths.items():
            for fn in wrappers.values():
                fn.launches = 0
            results[path] = run(est)
            torch.cuda.synchronize()
            path_launches[path] = {name: fn.launches
                                   for name, fn in wrappers.items()}
            log(f"launches on {path}: {path_launches[path]}")
        launches = {name: sum(n[name] for n in path_launches.values())
                    for name in wrappers}
        log(f"launch counts on the main path: {launches}")
        for name, n in launches.items():
            check(n > 0, f"the main path never launched {name}")
        for path in (WINDOWED, MULTISCALE, BATCH25):
            check(path_launches[path]["smooth_nms_topk"] > 0,
                  f"{path} never launched smooth_nms_topk")
        for path in (WINDOWED, MULTISCALE):
            check(path_launches[path]["smooth_nms_topk_raw"] == 0,
                  f"{path} launched smooth_nms_topk_raw")

        for path, run in paths.items():
            got = results[path]
            log(f"humans per image, {path}: {[len(h) for h in got]}")
            check(sum(len(h) for h in got) > 0, f"{path}: no humans found")
            for i, (g, w) in enumerate(zip(got, run(est_cpu))):
                same_humans(g, w, f"{path} image {i}")
        log("humans equal the CPU estimator's (coords 1e-6, scores 1e-4)")
        stats, _ = synthetic_e2e(est, 50, 432, 368)
        thin_ap50 = stats["AP50"]
        log(f"AP on the card, mobilenet_thin (thin368_coco), 50 rendered "
            f"432x368 scenes: AP50 {stats['AP50']:.4f} (gate 0.95), AP "
            f"{stats['AP']:.4f}, mean deviation "
            f"{stats['mean_px_deviation']:.3f} px")
        check(stats["AP50"] >= 0.95, f"thin AP50 {stats['AP50']} < 0.95")

        frame = torch.from_numpy(frames[0])
        d = (downscale_area(frame.to(dev), 368, 432).cpu().int()
             - downscale_area(frame, 368, 432).int()).abs()
        check(int(d.max()) <= 1, "area downscale differs by more than 1")
        log(f"area downscale 1280x720 -> 432x368 on the card vs the CPU: "
            f"{int((d > 0).sum())} of {d.numel()} values differ "
            f"({float((d > 0).float().mean()):.3g}), max |d| {int(d.max())}")

    def drive(path, run):
        """Run one path with every launch count set to 0 just before it
        and read just after; returns what the path returned."""
        for fn in wrappers.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        path_launches[path] = {name: fn.launches
                               for name, fn in wrappers.items()}
        log(f"launches on {path}: {path_launches[path]}")
        return out

    def launched(path, *names):
        for name in names:
            check(path_launches[path][name] > 0,
                  f"{path} never launched {name}")

    with phase("4 backbones"):
        v2 = {}
        for name, wh in (("mobilenet_v2_small", (368, 368)),
                         ("mobilenet_v2_large", (432, 368))):
            kw = dict(target_size=wh, params_path=V2_CHECKPOINTS[name])
            v2[name] = (TfPoseEstimator(name, **kw),
                        TfPoseEstimator(name, device="cpu", **kw))
        imgs368 = render_frames(np.random.default_rng(368), 8, 368, 368)
        v2_paths = {
            V2S_INF: ("mobilenet_v2_small", lambda e: [
                e.inference(im, upsample_size=4.0) for im in imgs368],
                ("smooth_nms",)),
            V2S_BATCH: ("mobilenet_v2_small", lambda e: e.inference_batch(
                imgs368, upsample_size=4.0),
                ("smooth_nms_topk_raw", "score_candidates_raw")),
            V2L_INF: ("mobilenet_v2_large", lambda e: [
                e.inference(im, upsample_size=4.0) for im in imgs[:4]],
                ("smooth_nms",)),
        }
        for path, (name, run, kernels_needed) in v2_paths.items():
            card, cpu = v2[name]
            got = drive(path, lambda: run(card))
            launched(path, *kernels_needed)
            log(f"humans per image, {path}: {[len(h) for h in got]}")
            check(sum(len(h) for h in got) > 0, f"{path}: no humans found")
            for i, (g, w) in enumerate(zip(got, run(cpu))):
                same_humans(g, w, f"{path} image {i}")
        log("v2 humans equal the CPU estimator's (coords 1e-6, scores 1e-4)")
        for name, n, gate in (("mobilenet_v2_small", 50, 0.90),
                              ("mobilenet_v2_large", 25, 0.88)):
            stats, _ = synthetic_e2e(v2[name][0], n, 160, 160)
            ckpt = os.path.basename(os.path.dirname(V2_CHECKPOINTS[name]))
            log(f"AP on the card, {name} ({ckpt}), {n} rendered 160x160 "
                f"scenes: AP50 {stats['AP50']:.4f} "
                f"(gate {gate}), AP {stats['AP']:.4f}, mean deviation "
                f"{stats['mean_px_deviation']:.3f} px")
            check(stats["AP50"] >= gate, f"{name} AP50 {stats['AP50']} < "
                  f"{gate}")

        check(not os.path.exists(get_checkpoint_path("cmu")),
              "a cmu checkpoint would replace the seeded random weights")
        frames656 = render_frames(np.random.default_rng(656), 16, 368, 656)
        t = time.perf_counter()
        est_cmu = TfPoseEstimator("cmu", target_size=(656, 368))
        cpu_cmu = TfPoseEstimator("cmu", target_size=(656, 368),
                                  device="cpu")
        log(f"cmu estimators (seeded random weights) in "
            f"{time.perf_counter() - t:.2f} s")
        got1 = drive(CMU_INF, lambda: est_cmu.inference(
            frames656[0], upsample_size=4.0))
        launched(CMU_INF, "smooth_nms")
        got16 = drive(CMU_BATCH, lambda: est_cmu.inference_batch(
            frames656, upsample_size=4.0))
        launched(CMU_BATCH, "smooth_nms_topk_raw", "score_candidates_raw")
        log(f"humans with random weights: {len(got1)} ({CMU_INF}), "
            f"{[len(h) for h in got16]} ({CMU_BATCH})")

        cmu_w, cmu_h = est_cmu.target_size
        with torch.inference_mode():
            maps = est_cmu._forward(np.stack(frames656), cmu_h, cmu_w)
            t = time.perf_counter()
            maps_cpu = cpu_cmu._forward(np.stack(frames656[:2]), cmu_h, cmu_w)
        scale = maps_cpu.abs().max().item()
        d = (maps[:2].cpu() - maps_cpu).abs().max().item()
        log(f"cmu concat_stage7 {tuple(maps.shape)} on the card vs the CPU "
            f"forward ({time.perf_counter() - t:.2f} s) of 2 frames: max "
            f"|d| {d:.3g}, {d / scale:.3g} of max |map| {scale:.3g} "
            f"(tolerance 1e-4 of it)")
        check(scale > 0 and d <= 1e-4 * scale, "cmu maps differ")
        x = heat8_of(maps).contiguous()
        for k in (32, 128):
            s, i = k1_pair(x, k)
        log(f"K1 on the card's cmu maps {tuple(x.shape)}: "
            f"{int((i >= 0).sum())} peaks at K=128, equal to the plain "
            f"version and bit for bit to its phase arithmetic")
        b, up_h, up_w = len(maps), 4 * maps.shape[1], 4 * maps.shape[2]
        heat_up = resize.resize_area(maps[0, ..., :19], up_h,
                                     up_w).contiguous()
        k2_compare(smooth_nms(heat_up), smooth_nms_plain(heat_up),
                   "the card's cmu map")
        log(f"K2 on the card's cmu map {tuple(heat_up.shape)}: bit for bit")
        k3_pair(peaks_of(*smooth_nms_topk_raw(x, 4, 4, 32, 0.05), b, up_w),
                maps[..., 19:], up_h, up_w, f"the card's cmu maps B={b} K=32")

        def decode_rendered(net_g):
            up = (184, 328)
            peaks_map, _, paf_up = postprocess(net_g[0], *up, params)
            one = decode_maps(peaks_map, paf_up, params)
            return (humans_of(decode_batch(net_g[:1], *up, params))
                    + humans_of(decode_batch(net_g, *up, params))
                    + humans_of(type(one)(*(t[None] for t in one))))

        net82 = grid_nets[(46, 82)]
        got = drive(CMU_MAPS, lambda: decode_rendered(net82))
        launched(CMU_MAPS, "smooth_nms_topk_raw", "smooth_nms",
                 "score_candidates_raw")
        log(f"humans per map, {CMU_MAPS}: {[len(h) for h in got]}")
        check(sum(len(h) for h in got) > 0, f"{CMU_MAPS}: no humans found")
        for i, (g, w) in enumerate(zip(got, decode_rendered(net82.cpu()))):
            same_humans(g, w, f"{CMU_MAPS} result {i}")
        log("cmu-grid humans equal the CPU decode's (coords 1e-6, scores "
            "1e-4)")
        launches = {name: sum(n[name] for n in path_launches.values())
                    for name in wrappers}
        log(f"launch counts over every path: {launches}")

    with phase("5 timing"):
        tag = f"[{smi}]"
        heat_up = resize.resize_area(nets[0, ..., :19], 184, 216).contiguous()
        # bytes and operations of this run's inputs
        wv, _, wh = _phase_tables(4, 4, 25, 3.0, str(dev))[:3]
        nv, nh = wv.shape[1], wh.shape[1]

        def k1_cost(x):
            h8, w8, c1 = x.shape
            up_h, up_w = 4 * h8, 4 * w8
            return (x.numel() * 4 + (wv.numel() + wh.numel()) * 4
                    + c1 * 32 * 8,
                    c1 * (up_h * (w8 + nh - 1) * 2 * nv + up_h * up_w * 2 * nh
                          + up_h * up_w * 8))

        def k4_cost(x):
            return (x.numel() * 4 + x.shape[2] * 32 * 8,
                    x.numel() * (2 * (2 * 25 - 1) + 9))

        def k2_cost(x):
            return 2 * x.numel() * 4, x.numel() * (2 * (2 * 25 - 1) + 9)

        pair_parts = torch.as_tensor(pairs, dtype=torch.long, device=dev)

        def k3_cost(pk, paf8, up_h, up_w):
            """Bytes: the peaks, 5 B of result per candidate, and each PAF
            cell (both channels of its pair) that a live candidate (outside
            the row skip) samples, once; a dead candidate reads no PAF.
            Operations: about 16 per candidate (geometry, criteria) and 13
            per sample of a live one."""
            b, _, k = pk.x.shape
            h8, w8 = paf8.shape[1:3]
            va = pk.valid[:, pair_parts[:, 0]].sum(-1)
            nrows = torch.where(pk.valid[:, pair_parts[:, 1]].any(-1),
                                (va * k + 127) // 128, 0)
            rows = torch.arange(k * k, device=dev).reshape(k, k) // 128
            live = rows < nrows[..., None, None]            # (B, 19, K, K)
            iy, ix = candidate_geometry(pk, up_h, up_w, params)[-2:]
            cell = (iy // (up_h // h8)) * w8 + ix // (up_w // w8)
            plane = torch.arange(b * len(pairs), device=dev) * (h8 * w8)
            cell = cell + plane.reshape(b, len(pairs), 1, 1, 1)
            cells = torch.unique(cell[live]).numel()
            n = b * len(pairs) * k * k
            return (cells * 8 + pk.x.numel() * 9 + n * 5,
                    16 * n + (13 * params.step_paf + 1) * int(live.sum()))

        # K4 at the windowed path's own input: the merged map of the
        # first 1280x720 frame, upsampled 4x; and at B=8 at 2.5x
        with torch.inference_mode():
            merged = windowed_forward(
                est._forward_windows, torch.from_numpy(frames[0]).to(dev),
                368, 432)
        x4 = planes_up(merged[None], 360, 640)
        x25 = planes_up(nets, 115, 135)
        x1b8 = heat8_of(nets).contiguous()
        x1b1 = heat8_of(nets[:1]).contiguous()
        pk1 = peaks_of(*smooth_nms_topk_raw(x1b1, 4, 4, 32, 0.05), 1, 216)
        pk8 = peaks_of(*smooth_nms_topk_raw(x1b8, 4, 4, 32, 0.05), 8, 216)
        pk4 = peaks_of(*smooth_nms_topk(x4, 32, 0.05), 1, 640)
        paf1, paf8, paf4 = (nets[:1, ..., 19:], nets[..., 19:],
                            merged[None, ..., 19:])

        def k3(pk, paf, up_h, up_w, fn):
            return lambda: fn(pk, paf, up_h, up_w, params)

        # the new grids: rendered CMU (46x82, B=16) and v2small (46x46,
        # B=8) maps
        new_cases = []
        for (h8, w8), net_g in grid_nets.items():
            b, up_h, up_w = len(net_g), 4 * h8, 4 * w8
            what = {82: "cmu", 46: "v2small"}[w8]
            xg = heat8_of(net_g).contiguous()
            hg = resize.resize_area(net_g[0, ..., :19], up_h,
                                    up_w).contiguous()
            pkg = peaks_of(*smooth_nms_topk_raw(xg, 4, 4, 32, 0.05), b, up_w)
            pafg = net_g[..., 19:]
            new_cases += [
                ("smooth_nms_topk_raw", f"{what} B={b} {tuple(xg.shape)} 4x "
                 "K=32",
                 lambda xg=xg: smooth_nms_topk_raw(xg, 4, 4, 32, 0.05),
                 lambda xg=xg: smooth_nms_topk_raw_plain(xg, 4, 4, 32, 0.05),
                 k1_cost(xg)),
                ("smooth_nms", f"{what} {tuple(hg.shape)}",
                 lambda hg=hg: smooth_nms(hg),
                 lambda hg=hg: smooth_nms_plain(hg), k2_cost(hg)),
                ("score_candidates_raw", f"{what} B={b} ({h8}, {w8}) 4x K=32",
                 k3(pkg, pafg, up_h, up_w, score_candidates_raw),
                 k3(pkg, pafg, up_h, up_w, score_candidates_raw_plain),
                 k3_cost(pkg, pafg, up_h, up_w)),
            ]

        # (kernel, shape, kernel call, plain call, (bytes, ops)); a
        # kernel's first case is the one its JSON entry reports
        cases = [
            ("smooth_nms_topk_raw", "B=8 (46, 54, 144) 4x K=32",
             lambda: smooth_nms_topk_raw(x1b8, 4, 4, 32, 0.05),
             lambda: smooth_nms_topk_raw_plain(x1b8, 4, 4, 32, 0.05),
             k1_cost(x1b8)),
            ("smooth_nms_topk_raw", "B=1 (46, 54, 18) 4x K=32",
             lambda: smooth_nms_topk_raw(x1b1, 4, 4, 32, 0.05),
             lambda: smooth_nms_topk_raw_plain(x1b1, 4, 4, 32, 0.05),
             k1_cost(x1b1)),
            ("smooth_nms", f"{tuple(heat_up.shape)}",
             lambda: smooth_nms(heat_up), lambda: smooth_nms_plain(heat_up),
             k2_cost(heat_up)),
            ("score_candidates_raw", "B=1 (46, 54) 4x K=32",
             k3(pk1, paf1, 184, 216, score_candidates_raw),
             k3(pk1, paf1, 184, 216, score_candidates_raw_plain),
             k3_cost(pk1, paf1, 184, 216)),
            ("score_candidates_raw", "B=8 (46, 54) 4x K=32",
             k3(pk8, paf8, 184, 216, score_candidates_raw),
             k3(pk8, paf8, 184, 216, score_candidates_raw_plain),
             k3_cost(pk8, paf8, 184, 216)),
            ("score_candidates_raw", "windowed (90, 160) 4x K=32",
             k3(pk4, paf4, 360, 640, score_candidates_raw),
             k3(pk4, paf4, 360, 640, score_candidates_raw_plain),
             k3_cost(pk4, paf4, 360, 640)),
            ("smooth_nms_topk", f"{tuple(x4.shape)} K=32",
             lambda: smooth_nms_topk(x4, 32, 0.05),
             lambda: smooth_nms_topk_plain(x4, 32, 0.05), k4_cost(x4)),
            ("smooth_nms_topk", f"{tuple(x25.shape)} K=32",
             lambda: smooth_nms_topk(x25, 32, 0.05),
             lambda: smooth_nms_topk_plain(x25, 32, 0.05), k4_cost(x25)),
        ] + new_cases
        sources = {
            "smooth_nms_topk_raw": ("tfpose_tpu_torch/csrc/smooth_nms_topk_raw.cu",
                                    "tfpose_tpu/ops/pallas/smooth_nms.py:371"),
            "smooth_nms": ("tfpose_tpu_torch/csrc/smooth_nms.cu",
                           "tfpose_tpu/ops/pallas/smooth_nms.py:227"),
            "score_candidates_raw": ("tfpose_tpu_torch/csrc/paf_score.cu",
                                     "tfpose_tpu/ops/pallas/paf_score.py:104"),
            "smooth_nms_topk": ("tfpose_tpu_torch/csrc/smooth_nms_topk.cu",
                                "tfpose_tpu/ops/pallas/smooth_nms.py:180"),
        }
        ours = {"smooth_nms_topk_raw": ("phase_peaks_kernel", "select_kernel"),
                "smooth_nms": ("smooth_nms_kernel",),
                "score_candidates_raw": ("score_candidates_kernel",),
                "smooth_nms_topk": ("blur_peaks_kernel", "select_kernel")}

        def device_ms(name, rows):
            """Device ms per launch of ``name``'s own kernels in a
            profile, or None where one of them is missing."""
            hits = [[r for r in rows if sym in r[0]] for sym in ours[name]]
            if not all(hits):
                return None, []
            per = [h[0][1] / h[0][2] for h in hits]
            return sum(per), per

        kernels = {}
        for name, shape, fn, plain, (nbytes, ops) in cases:
            med, p90 = time_cuda(fn)
            pmed, pp90 = time_cuda(plain)
            # the profiler now and then loses a kernel's records, several
            # attempts in a row: retry with a pause
            for attempt in range(8):
                dms, per = device_ms(name, profile_calls(fn, n=20)[3])
                if dms is not None:
                    break
                log(f"  no device time for {name} {shape} in profile "
                    f"{attempt + 1}; again")
                time.sleep(0.5)
            check(dms is not None, f"no device time for {name} {shape}")
            bms, by = bound_ms(nbytes, ops)
            log(f"time {name} {shape}: kernel median {med:.5f} ms p90 "
                f"{p90:.5f} ms | device {dms:.5f} ms per launch "
                f"({' + '.join(f'{t:.5f}' for t in per)}) | plain median "
                f"{pmed:.5f} ms p90 {pp90:.5f} ms | bound {bms:.6f} ms "
                f"({by}: {nbytes} B, {ops} op) {tag}")
            case = {"shape": shape, "ms": med, "p90_ms": p90,
                    "device_ms": dms, "plain_ms": pmed, "bound_ms": bms,
                    "bound_by": by}
            if name not in kernels:
                kernels[name] = {
                    "name": name, "route": "cuda", "source": sources[name][0],
                    "replaces": sources[name][1], "launches": launches[name],
                    "launches_by_path": {path: n[name] for path, n in
                                         path_launches.items()},
                    "max_abs_err": err[name], "ms": med, "plain_ms": pmed,
                    "bound_ms": bms, "bound_by": by, "library_ms": None,
                    "cases": []}
            kernels[name]["cases"].append(case)
        kernels = list(kernels.values())

        v2s, v2l = v2["mobilenet_v2_small"][0], v2["mobilenet_v2_large"][0]
        # (what, call, images per call) of the backbones of phase 4
        backbone_calls = [
            ("mobilenet_v2_small inference (1 image, 368x368, upsample 4)",
             lambda: v2s.inference(imgs368[0], upsample_size=4.0), 1),
            ("mobilenet_v2_small inference_batch B=8 (368x368, upsample 4)",
             lambda: v2s.inference_batch(imgs368, upsample_size=4.0), 8),
            ("mobilenet_v2_large inference (1 image, 432x368, upsample 4)",
             lambda: v2l.inference(imgs[0], upsample_size=4.0), 1),
            ("cmu inference (1 image, 656x368, upsample 4)",
             lambda: est_cmu.inference(frames656[0], upsample_size=4.0), 1),
            ("cmu inference_batch B=16 (656x368, upsample 4)",
             lambda: est_cmu.inference_batch(frames656, upsample_size=4.0),
             16)]
        for what, fn in [
                ("inference", lambda: est.inference(imgs[0],
                                                    upsample_size=4.0)),
                ("inference_batch B=8", lambda: est.inference_batch(
                    imgs, upsample_size=4.0)),
                ("inference_windowed 1280x720", lambda: est.inference_windowed(
                    frames[0], upsample_size=4.0)),
                ("inference_batch B=8 at 2.5x", lambda: est.inference_batch(
                    imgs, upsample_size=2.5))] + [
                    c[:2] for c in backbone_calls]:
            wall, busy, nk, rows = profile_calls(fn)
            log(f"profile {what}: wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms (idle {100 * (1 - busy / wall):.1f} %), "
                f"{nk:.0f} kernel launches per call {tag}")
            for key, ms, cnt in rows[:8]:
                log(f"  {ms:.4f} ms  x{cnt:.0f}  {key[:90]}")
            for name in ours:
                dms, per = device_ms(name, rows)
                if dms is not None:
                    log(f"  device time of {name}: {dms:.5f} ms per "
                        f"launch ({' + '.join(f'{t:.5f}' for t in per)})")

        med, p90 = time_host(lambda: est.inference(imgs[0],
                                                   upsample_size=4.0), 20)
        log(f"time inference (1 image, 432x368, upsample 4): median "
            f"{med * 1e3:.3f} ms p90 {p90 * 1e3:.3f} ms {tag}")
        for b in (1, 8, 16):
            batch_imgs = (imgs * 2)[:b]
            med, p90 = time_host(lambda: est.inference_batch(
                batch_imgs, upsample_size=4.0), 10)
            log(f"time inference_batch B={b}: median {med * 1e3:.3f} ms "
                f"p90 {p90 * 1e3:.3f} ms = {b / med:.2f} img/s (median), "
                f"{b / p90:.2f} img/s (p90) {tag}")
        med, p90 = time_host(lambda: est.inference_batch(
            imgs, upsample_size=2.5), 10)
        log(f"time inference_batch B=8 at upsample 2.5: median "
            f"{med * 1e3:.3f} ms p90 {p90 * 1e3:.3f} ms = {8 / med:.2f} img/s"
            f" (median), {8 / p90:.2f} img/s (p90) {tag}")
        med, p90 = time_host(lambda: est.inference_windowed(
            frames[0], upsample_size=4.0), 20)
        log(f"time inference_windowed (1280x720, 12 windows, upsample 4): "
            f"median {med * 1e3:.3f} ms p90 {p90 * 1e3:.3f} ms {tag}")
        for what, fn, b in backbone_calls:
            med, p90 = time_host(fn, 20 if b == 1 else 10)
            rate = (f" = {b / med:.2f} img/s (median), {b / p90:.2f} img/s "
                    f"(p90)" if b > 1 else "")
            log(f"time {what}: median {med * 1e3:.3f} ms p90 "
                f"{p90 * 1e3:.3f} ms{rate} {tag}")
        med, p90 = time_host(lambda: est.inference_multiscale(
            frames[0], scales=(1.0, 1.5), upsample_size=4.0), 10)
        log(f"time inference_multiscale (1280x720, scales 1.0 and 1.5: 12 + "
            f"24 windows, upsample 4): median {med * 1e3:.3f} ms p90 "
            f"{p90 * 1e3:.3f} ms {tag}")

    from tfpose_tpu_torch.evaluation.coco_eval import evaluate_oks_ap
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.pipeline.preprocess import resize_u8
    from tfpose_tpu_torch.pipeline.video import VideoPipeline
    from tfpose_tpu_torch.serving import (
        DynamicBatcher, PoseClient, PoseService, humans_to_msg)

    with phase("6 serving"):
        # VideoPipeline: thin368_coco on 24 rendered 640x480 frames
        vframes = render_frames(np.random.default_rng(640), 24, 480, 640)
        want = [humans_key(h) for h in video_serial(est, vframes)]
        # the CPU decodes the card's resized frames: the card's area
        # downscale may differ from the CPU's by a grey level (held in
        # phase 3), which moves a score by more than the 1e-4 of the
        # forward and decode
        resized = [resize_u8(torch.from_numpy(f).to(dev), 368, 432).cpu()
                   for f in vframes]
        n_diff = sum(int((r != resize_u8(torch.from_numpy(f), 368, 432))
                         .sum()) for r, f in zip(resized, vframes))
        log(f"video frames resized 640x480 -> 432x368 on the card: {n_diff} "
            f"of {24 * 368 * 432 * 3} values differ from the CPU's by a grey "
            f"level")
        cpu_want = video_serial(est_cpu, [r.numpy() for r in resized])
        check(sum(len(h) for h in cpu_want) > 0, "video: no humans")
        for depth in (1, 2, 3):
            path = f"video_d{depth}"
            pipe = VideoPipeline(est, upsample_size=4.0, depth=depth)
            got = drive(path, lambda: [h for _, h in pipe.run(vframes)])
            launched(path, "smooth_nms_topk_raw", "score_candidates_raw")
            check([humans_key(h) for h in got] == want,
                  f"{path}: humans differ from the serial loop's")
            for i, (g, w) in enumerate(zip(got, cpu_want)):
                same_humans(g, w, f"{path} frame {i}")
            t = time.perf_counter()
            for _ in pipe.run(vframes):
                pass
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            wall, busy, nk, rows = profile_calls(
                lambda: [None for _ in pipe.run(vframes[:8])], n=1)
            log(f"time VideoPipeline depth {depth}: 24 frames of 640x480 in "
                f"{secs * 1e3:.3f} ms = {24 / secs:.2f} frames/s | profile of "
                f"8 frames: wall {wall:.3f} ms, device busy {busy:.3f} ms "
                f"(idle {100 * (1 - busy / wall):.1f} %, kernel time summed "
                f"over both streams), {nk:.0f} kernels [{smi}]")
        log("video humans equal the serial loop's bit for bit at depths "
            "1-3, and the CPU's on the card's resized frames (coords 1e-6, "
            "scores 1e-4)")

        # DynamicBatcher: 8 futures submitted before the first flush
        batcher = DynamicBatcher(est, max_batch=8, max_wait_ms=2000.0,
                                 upsample_size=4.0)
        try:
            got = drive("batcher", lambda: [
                f.result(timeout=60) for f in
                [batcher.submit(img) for img in imgs]])
        finally:
            batcher.stop()
        launched("batcher", "smooth_nms_topk_raw", "score_candidates_raw")
        check(batcher.batch_sizes == {8: 1},
              f"batcher histogram {batcher.batch_sizes}, want {{8: 1}}")
        for i, (g, w) in enumerate(zip(
                got, results["inference_batch B=8 (4x)"])):
            same_humans(g, w, f"batcher image {i}")
        log(f"batcher: histogram {batcher.batch_sizes}, humans equal "
            f"inference_batch's")

        # PoseService on 127.0.0.1, raw frames at max_batch 1 and 8
        for max_batch, ref in ((1, "inference x8 (4x)"),
                               (8, "inference_batch B=8 (4x)")):
            path = f"service_b{max_batch}"
            svc = PoseService(est, port=0, upsample_size=4.0,
                              max_batch=max_batch)
            client = None
            try:
                client = PoseClient(*svc.start())
                got = drive(path, lambda: [client.infer_raw(img)
                                           for img in imgs])
                ms = []
                for img in imgs * 3:
                    t = time.perf_counter()
                    client.infer_raw(img)
                    ms.append((time.perf_counter() - t) * 1e3)
            finally:
                if client is not None:
                    client.close()
                svc.stop()
            launched(path, *(("smooth_nms",) if max_batch == 1 else
                             ("smooth_nms_topk_raw", "score_candidates_raw")))
            for i, (g, h) in enumerate(zip(got, results[ref])):
                same_persons(g, humans_to_msg(h, 432, 368), f"{path} {i}")
            log(f"time PoseService round trip, max_batch {max_batch} (432x368"
                f" raw frames, one client, {len(ms)} requests): median "
                f"{np.median(ms):.3f} ms p90 {np.percentile(ms, 90):.3f} ms "
                f"[{smi}]; replies equal humans_to_msg of {ref}")

        # BatchedEvaluator: thin368_coco, batch 8, 50 rendered scenes
        items, gts = rendered_coco(50, 432, 368)
        for dtype in ("float32", "bfloat16"):
            path = f"sweep_{'fp32' if dtype == 'float32' else 'bf16'}"
            ev = BatchedEvaluator("mobilenet_thin", (432, 368), batch_size=8,
                                  dtype=dtype)
            ev.load_params(CHECKPOINT)
            t = time.perf_counter()
            dets = drive(path, lambda: ev.evaluate(iter(items)))
            secs = time.perf_counter() - t
            launched(path, "smooth_nms_topk_raw", "score_candidates_raw")
            stats = evaluate_oks_ap(gts, dets)
            log(f"BatchedEvaluator {dtype} thin368_coco, 50 rendered 432x368 "
                f"scenes in batches of 8: AP50 {stats['AP50']:.4f} (gate "
                f"0.95), AP {stats['AP']:.4f}; {secs * 1e3:.1f} ms [{smi}]")
            check(stats["AP50"] >= 0.95, f"{path} AP50 {stats['AP50']}")

    with phase("7 bf16"):
        est16 = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                                params_path=CHECKPOINT, dtype="bfloat16")
        cmu16 = TfPoseEstimator("cmu", target_size=(656, 368),
                                dtype="bfloat16")
        # maps against the fp32 maps of the same frames
        with torch.inference_mode():
            for what, e32, e16, frames_, h_, w_ in (
                    ("thin (thin368_coco)", est, est16, imgs, 368, 432),
                    ("cmu (seeded weights)", est_cmu, cmu16, frames656,
                     368, 656)):
                m32 = e32._forward(np.stack(frames_), h_, w_)
                m16 = e16._forward(np.stack(frames_), h_, w_)
                d = (m16 - m32).abs()
                scale = m32.abs().max().item()
                p99 = torch.quantile(d.flatten()[::7], 0.99).item()
                log(f"bf16 {what} concat_stage7 {tuple(m16.shape)} vs fp32: "
                    f"max |d| {d.max().item():.4g} = "
                    f"{d.max().item() / scale:.4g} of max |map| "
                    f"{scale:.4g}, 99th percentile {p99 / scale:.4g} of it")
                if what.startswith("thin"):
                    check(p99 <= 0.05 * scale and d.max() <= 0.35 * scale,
                          "bf16 thin maps beyond 5 % (p99) / 35 % (max)")
                else:
                    check(d.max() <= 0.05 * scale, "bf16 cmu maps beyond 5 %")
        bf16_paths = {
            "bf16_thin_inference": (lambda: [
                est16.inference(img, upsample_size=4.0) for img in imgs],
                ("smooth_nms",)),
            "bf16_thin_batch": (lambda: est16.inference_batch(
                imgs, upsample_size=4.0),
                ("smooth_nms_topk_raw", "score_candidates_raw")),
            "bf16_cmu_batch": (lambda: cmu16.inference_batch(
                frames656, upsample_size=4.0),
                ("smooth_nms_topk_raw", "score_candidates_raw")),
        }
        got16 = {}
        for path, (run, needed) in bf16_paths.items():
            got16[path] = drive(path, run)
            launched(path, *needed)
        for path, ref in (("bf16_thin_inference", "inference x8 (4x)"),
                          ("bf16_thin_batch", "inference_batch B=8 (4x)")):
            pairs = list(zip(got16[path], results[ref]))
            n_same = sum(humans_key(g) == humans_key(w) for g, w in pairs)
            n_parts = sum(len(g) == len(w) and all(
                a.body_parts.keys() == b.body_parts.keys()
                for a, b in zip(g, w)) for g, w in pairs)
            log(f"{path}: humans {[len(h) for h in got16[path]]} (fp32 "
                f"{[len(h) for h in results[ref]]}); {n_same} of "
                f"{len(pairs)} scenes equal to fp32's, {n_parts} with the "
                f"same part sets")
        for what, f32, f16, b in (
                ("thin inference (1 image, 432x368, upsample 4)",
                 lambda: est.inference(imgs[0], upsample_size=4.0),
                 lambda: est16.inference(imgs[0], upsample_size=4.0), 1),
                ("thin inference_batch B=8 (432x368, upsample 4)",
                 lambda: est.inference_batch(imgs, upsample_size=4.0),
                 lambda: est16.inference_batch(imgs, upsample_size=4.0), 8),
                ("cmu inference_batch B=16 (656x368, upsample 4)",
                 lambda: est_cmu.inference_batch(frames656,
                                                 upsample_size=4.0),
                 lambda: cmu16.inference_batch(frames656, upsample_size=4.0),
                 16)):
            line = []
            for dt, fn in (("fp32", f32), ("bf16", f16), ("fp32", f32),
                           ("bf16", f16)):
                med, p90 = time_host(fn, 10)
                line.append(f"{dt} median {med * 1e3:.3f} ms p90 "
                            f"{p90 * 1e3:.3f} ms ({b / med:.2f} img/s)")
            log(f"time {what}, in turns: {' | '.join(line)} [{smi}]")
            wall, busy, nk, rows = profile_calls(f16)
            log(f"profile bf16 {what}: wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms (idle {100 * (1 - busy / wall):.1f} %), "
                f"{nk:.0f} kernel launches per call [{smi}]")
            for key, ms, cnt in rows[:6]:
                log(f"  {ms:.4f} ms  x{cnt:.0f}  {key[:90]}")

    from tfpose_tpu_torch.cli import train as train_cli
    from tfpose_tpu_torch.convert.checkpoint import (
        variables_from_numpy, variables_to_numpy)
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.models.layers import (
        init_weights, int_conv2d, set_quant_mode)
    from tfpose_tpu_torch.train.state import (
        TrainState, batch_loss, make_optimizer, make_train_step)

    def copy_calibration(src, dst):
        """The card network's in_absmax into ``dst`` (a CPU network)."""
        variables_from_numpy(dst, variables_to_numpy(src))

    with phase("8 int8"):
        t = time.perf_counter()
        est8 = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                               params_path=CHECKPOINT, quantize=True)
        torch.cuda.synchronize()
        log(f"int8 thin368_coco estimator, calibrated on the card on 8 "
            f"rendered 432x368 scenes, in {time.perf_counter() - t:.2f} s")
        cpu8 = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                               params_path=CHECKPOINT, quantize=True,
                               device="cpu")
        qa = variables_to_numpy(est8.net)["quant"]
        qb = variables_to_numpy(cpu8.net)["quant"]

        def leaves(t, out):
            for v in t.values():
                if isinstance(v, dict):
                    leaves(v, out)
                else:
                    out.append(float(v))
            return out

        flat_a, flat_b = leaves(qa, []), leaves(qb, [])
        rel = max(abs(a - b) / b for a, b in zip(flat_a, flat_b))
        log(f"calibration on the card vs the CPU: {len(flat_a)} convs, "
            f"max rel diff {rel:.3g} (tolerance 1e-5), "
            f"{sum(a == b for a, b in zip(flat_a, flat_b))} equal")
        check(len(flat_a) == 143 and rel <= 1e-5, "int8 calibration differs")
        copy_calibration(est8.net, cpu8.net)
        with torch.inference_mode():
            m8 = est8._forward(np.stack(imgs), 368, 432).cpu()
            m8c = cpu8._forward(np.stack(imgs), 368, 432)
            m32 = est._forward(np.stack(imgs), 368, 432).cpu()
        d = (m8 - m8c).abs().max().item()
        scale = m32.abs().max().item()
        log(f"int8 thin concat_stage7 {tuple(m8.shape)} on the card vs the "
            f"CPU int8 forward (the card's calibration): max |d| {d:.3g} "
            f"(tolerance 0: bit for bit); int8 vs fp32 max |d| "
            f"{(m8 - m32).abs().max().item() / scale:.4g} of max |map| "
            f"{scale:.4g}")
        check(torch.equal(m8, m8c), "int8 maps differ from the CPU's")
        int8_paths = {
            "int8_thin_inference": (lambda e: [
                e.inference(img, upsample_size=4.0) for img in imgs],
                ("smooth_nms",)),
            "int8_thin_batch": (lambda e: e.inference_batch(
                imgs, upsample_size=4.0),
                ("smooth_nms_topk_raw", "score_candidates_raw")),
        }
        for path, (run, needed) in int8_paths.items():
            got = drive(path, lambda: run(est8))
            launched(path, *needed)
            log(f"humans per image, {path}: {[len(h) for h in got]}")
            check(sum(len(h) for h in got) > 0, f"{path}: no humans found")
            for i, (g, w) in enumerate(zip(got, run(cpu8))):
                same_humans(g, w, f"{path} image {i}")
        log("int8 humans equal the CPU int8 estimator's (coords 1e-6, "
            "scores 1e-4)")
        stats8, _ = synthetic_e2e(est8, 50, 432, 368)
        log(f"AP on the card, int8 mobilenet_thin (thin368_coco), 50 "
            f"rendered 432x368 scenes: AP50 {stats8['AP50']:.4f} (gate 0.6; "
            f"fp32 in phase 3: {thin_ap50:.4f}), AP {stats8['AP']:.4f}, "
            f"mean deviation {stats8['mean_px_deviation']:.3f} px")
        check(stats8["AP50"] >= 0.6, f"int8 AP50 {stats8['AP50']} < 0.6")

        t = time.perf_counter()
        cmu8 = TfPoseEstimator("cmu", target_size=(656, 368), quantize=True)
        torch.cuda.synchronize()
        log(f"int8 cmu estimator (seeded weights) calibrated on the card in "
            f"{time.perf_counter() - t:.2f} s")
        got16 = drive("int8_cmu_batch", lambda: cmu8.inference_batch(
            frames656, upsample_size=4.0))
        launched("int8_cmu_batch", "smooth_nms_topk_raw",
                 "score_candidates_raw")
        log(f"humans with random weights, int8_cmu_batch: "
            f"{[len(h) for h in got16]}")
        cmu_cpu8 = cpu_cmu.net
        set_quant_mode(cmu_cpu8, "int8")
        copy_calibration(cmu8.net, cmu_cpu8)
        with torch.inference_mode():
            c8 = cmu8._forward(np.stack(frames656), 368, 656)
            t = time.perf_counter()
            c8c = cpu_cmu._forward(np.stack(frames656[:2]), 368, 656)
            secs = time.perf_counter() - t
        set_quant_mode(cmu_cpu8, "none")
        scale = maps.abs().max().item()  # phase 4's fp32 cmu maps
        log(f"int8 cmu concat_stage7 {tuple(c8.shape)} on the card vs the CPU"
            f" int8 forward ({secs:.2f} s) of 2 frames: max |d| "
            f"{(c8[:2].cpu() - c8c).abs().max().item():.3g} (tolerance 0); "
            f"int8 vs fp32 max |d| {(c8 - maps).abs().max().item() / scale:.4g}"
            f" of max |map| {scale:.4g}")
        check(torch.equal(c8[:2].cpu(), c8c), "int8 cmu maps differ")

        xs = torch.full((2, 185, 52, 88), 127, dtype=torch.int8)
        ws = torch.full((128, 185, 7, 7), 127, dtype=torch.int8)
        acc = int_conv2d(xs.to(dev), ws.to(dev), (1, 1)).cpu().long()
        cols = torch.nn.functional.unfold(xs.double(), (7, 7)).long()
        want = torch.einsum("ok,nkl->nol", ws.reshape(128, -1).long(),
                            cols).reshape(acc.shape)
        check(torch.equal(acc, want) and int(acc.max()) == 9065 * 127 * 127,
              "saturated K=9065 accumulators differ from int64")
        log(f"int8 accumulators of a 7x7x185 conv (K = 9065) saturated at "
            f"+127 on the card: {int(acc.max())} = 9065 * 127^2 > 2^24, "
            f"equal to int64 at all {acc.numel()} outputs")
        for what, f32, f8, b in (
                ("thin inference (1 image, 432x368, upsample 4)",
                 lambda: est.inference(imgs[0], upsample_size=4.0),
                 lambda: est8.inference(imgs[0], upsample_size=4.0), 1),
                ("thin inference_batch B=8 (432x368, upsample 4)",
                 lambda: est.inference_batch(imgs, upsample_size=4.0),
                 lambda: est8.inference_batch(imgs, upsample_size=4.0), 8),
                ("cmu inference_batch B=16 (656x368, upsample 4)",
                 lambda: est_cmu.inference_batch(frames656,
                                                 upsample_size=4.0),
                 lambda: cmu8.inference_batch(frames656, upsample_size=4.0),
                 16)):
            line = []
            for dt, fn in (("fp32", f32), ("int8", f8), ("fp32", f32),
                           ("int8", f8)):
                med, p90 = time_host(fn, 5)
                line.append(f"{dt} median {med * 1e3:.3f} ms p90 "
                            f"{p90 * 1e3:.3f} ms ({b / med:.2f} img/s)")
            log(f"time {what}, in turns: {' | '.join(line)} [{smi}]")
            wall, busy, nk, rows = profile_calls(f8, n=1)
            log(f"profile int8 {what}: wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms (idle {100 * (1 - busy / wall):.1f} %), "
                f"{nk:.0f} kernel launches per call [{smi}]")
            for key, ms, cnt in rows[:6]:
                log(f"  {ms:.4f} ms  x{cnt:.0f}  {key[:90]}")

    with phase("9 train"):
        ckdir = os.path.join(ROOT, "tfpose_tpu_torch", "_build",
                             "chip_smoke_train")
        if os.path.isdir(ckdir):
            for name in os.listdir(ckdir):
                if name.endswith((".pt", ".msgpack")):
                    os.remove(os.path.join(ckdir, name))
        base = ["--synthetic", "--model", "mobilenet_thin", "--input-size",
                "368x368", "--batchsize", "16", "--lr", "3e-3",
                "--max-steps", "30", "--log-every", "1"]
        runs = {"fp32": ["--checkpoint-dir", ckdir, "--save-every", "1000"],
                "fp32 --device-targets": ["--device-targets"],
                "bf16": ["--bf16"]}
        states = drive("train", lambda: {what: train_cli.main(base + extra)
                                         for what, extra in runs.items()})
        check(not any(path_launches["train"].values()),
              "the training path launched a decode kernel")
        for what, st in states.items():
            loss = [h["loss"] for h in st.history]
            check(st.step == 30 and len(loss) == 30, f"train {what}: steps")
            first, last = np.mean(loss[:3]), np.mean(loss[-3:])
            h5, hl = st.history[4], st.history[-1]
            rate = (hl["step"] - h5["step"]) * 16 / (hl["time"] - h5["time"])
            log(f"train {what}: thin 368x368 B=16 lr 3e-3, 30 steps on the "
                f"card: loss {first:.1f} (first 3) -> {last:.1f} (last 3), "
                f"{last / first:.4f} of the start (bar 0.85); {rate:.2f} "
                f"images/s over steps 6-30, {hl['images_per_sec']:.2f} over "
                f"all with the first [{smi}]")
            check(last < 0.85 * first, f"train {what}: loss {first} -> {last}")
            check(all(p.dtype == torch.float32 and p.is_cuda
                      for p in st.net.parameters()), f"train {what}: params")

        # a profile of the fp32 step, on a network of its own
        pnet = init_weights(get_network("mobilenet_thin"),
                            torch.Generator().manual_seed(0)).to(dev)
        pstate = TrainState.create(pnet, make_optimizer(3e-3))
        step = make_train_step()
        tbatch = next(train_cli.synthetic_batches(
            16, (368, 368), np.random.default_rng(4)))
        wall, busy, nk, rows = profile_calls(
            lambda: step(pstate, tbatch)[1]["loss"].item())
        log(f"profile of one fp32 train step (B=16, 368x368, host batch "
            f"included): wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"(idle {100 * (1 - busy / wall):.1f} %), {nk:.0f} kernels [{smi}]")
        for key, ms, cnt in rows[:8]:
            log(f"  {ms:.4f} ms  x{cnt:.0f}  {key[:90]}")

        # the exported weights, loaded by the estimator on the card
        trained = states["fp32"].net
        est_t = TfPoseEstimator("mobilenet_thin", target_size=(368, 368),
                                params_path=os.path.join(
                                    ckdir, "params.msgpack"))
        timgs = render_frames(np.random.default_rng(9), 4, 368, 368)
        heat = train_cli.predict_heat(trained, np.stack(timgs))
        with torch.inference_mode():
            emaps = est_t._forward(np.stack(timgs), 368, 368).cpu().numpy()
        check(np.array_equal(emaps[..., :19], heat),
              "the exported params.msgpack gives other maps")
        log(f"exported params.msgpack ({os.path.getsize(os.path.join(ckdir, 'params.msgpack'))} B) "
            f"loaded by TfPoseEstimator on the card: heat maps of 4 frames "
            f"equal the trainer's predict_heat bit for bit")

        # one fp32 step's loss and gradients, card against CPU
        batch = next(train_cli.synthetic_batches(
            4, (368, 368), np.random.default_rng(3)))
        net_g = init_weights(get_network("mobilenet_thin"),
                             torch.Generator().manual_seed(0))
        net_c = get_network("mobilenet_thin")
        net_c.load_state_dict(net_g.state_dict())
        net_g.to(dev)
        losses, grads = [], []
        t = time.perf_counter()
        for m in (net_g, net_c):
            loss, _ = batch_loss(m, batch)
            loss.backward()
            losses.append(loss.item())
            grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
        top = max(g.abs().max().item() for g in grads[1].values())
        worst = max((grads[0][k] - g).abs().max().item() / top
                    for k, g in grads[1].items())
        rel = abs(losses[0] - losses[1]) / losses[1]
        log(f"one fp32 step, thin 368x368 B=4, card vs CPU "
            f"({time.perf_counter() - t:.2f} s): loss {losses[0]:.6g} vs "
            f"{losses[1]:.6g} (rel {rel:.3g}, tolerance 1e-5); gradients "
            f"max |d| {worst:.3g} of the largest (tolerance 0.15) over "
            f"{len(grads[1])} leaves")
        check(rel <= 1e-5 and worst <= 0.15, "train step differs from CPU")

    from tfpose_tpu_torch.convert import graphdef
    from tfpose_tpu_torch.convert.checkpoint import (
        load_flax_msgpack, save_flax_msgpack)
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.ops.decode import decode
    from tfpose_tpu_torch.pipeline.preprocess import prepare
    from tfpose_tpu_torch.train import lmdb_dataset
    from tfpose_tpu_torch.utils import profiling

    with phase("10 conversion and profiling"):
        work = os.path.join(ROOT, "tfpose_tpu_torch", "_build",
                            "chip_smoke_convert")
        trace_dir = os.path.join(work, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        for name in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, name))
        fixtures = os.path.join(ROOT, "tests", "fixtures")

        # Datum records that the JAX writer wrote: 4 raw, then 4 PNG
        shard = os.path.join(fixtures, "datum_jax.tpds")
        with open(shard, "rb") as f:
            raw = f.read()
        payloads, pos = [], 4
        while pos < len(raw):
            n = int.from_bytes(raw[pos:pos + 4], "little")
            payloads.append(raw[pos + 4:pos + 4 + n])
            pos += 4 + n
        records = list(lmdb_dataset.DatumShardReader(shard))
        check(len(records) == 8 and [d.encoded for d in records]
              == [False] * 4 + [True] * 4, "datum fixture: records")
        for d, payload in zip(records, payloads):
            check(d.SerializeToString() == payload,
                  "a Datum record re-serializes to other bytes")
        samples = [lmdb_dataset.unpack_datum(d) for d in records[:4]]
        raw_shard = os.path.join(work, "raw.tpds")
        lmdb_dataset.write_datum_shard(raw_shard, samples, encoded=False)
        with open(raw_shard, "rb") as f:
            check(f.read() == raw[:4 + sum(4 + len(p) for p in payloads[:4])],
                  "the port's shard of the raw records differs")
        log(f"datum: {len(records)} records of {shard} re-serialize byte for "
            f"byte; the 4 raw ones unpack ({samples[0][0].shape} BGR, people "
            f"{[len(j) for _, j in samples]}) and write the fixture's raw "
            f"shard again ({os.path.getsize(raw_shard)} B); the PNG ones are "
            f"not decoded (no cv2 here)")
        t = time.perf_counter()
        st = drive("train_datum", lambda: train_cli.main([
            "--datum-shard", raw_shard, "--no-augment", "--model",
            "mobilenet_thin", "--input-size", "64x80", "--batchsize", "4",
            "--max-steps", "2", "--log-every", "1"]))
        loss = [h["loss"] for h in st.history]
        check(st.step == 2 and len(loss) == 2
              and all(np.isfinite(v) for v in loss)
              and all(p.is_cuda for p in st.net.parameters()),
              "train --datum-shard")
        log(f"train --datum-shard: thin 64x80 B=4, 2 steps on the card in "
            f"{time.perf_counter() - t:.2f} s, loss {loss}")

        # a GraphDef that TensorFlow wrote
        consts = graphdef.extract_consts(graphdef.load_graphdef(
            os.path.join(fixtures, "graphdef_tf.pb")))
        expected = np.load(os.path.join(fixtures, "graphdef_tf.npz"))
        names = [str(n) for n in expected["names"]]
        check(sorted(consts) == sorted(names), "graphdef fixture: names")
        for i, name in enumerate(names):
            want = expected[f"a{i}"]
            check(consts[name].dtype == want.dtype
                  and consts[name].shape == want.shape
                  and consts[name].tobytes() == want.tobytes(),
                  f"graphdef fixture: {name} differs")
        log(f"graphdef: {len(consts)} consts of TensorFlow's graph equal "
            f"MakeNdarray's bit for bit ({', '.join(names)})")

        # thin368_coco -> flat GraphDef -> convert_pb_file -> estimator
        t = time.perf_counter()
        variables = load_flax_msgpack(CHECKPOINT)
        pb_path = os.path.join(work, "thin368_graph_opt.pb")
        with open(pb_path, "wb") as f:
            f.write(graphdef.variables_to_graphdef(
                variables, scope="Openpose",
                read_nodes=True).SerializeToString())
        converted = os.path.join(work, "thin368_converted.msgpack")
        reference = os.path.join(work, "thin368_reference.msgpack")
        graphdef.convert_pb_file(pb_path, "mobilenet_thin", converted)
        save_flax_msgpack(reference, variables)
        with open(converted, "rb") as f, open(reference, "rb") as g, \
                open(CHECKPOINT, "rb") as h:
            out = f.read()
            check(out == g.read(), "converted msgpack differs")
            check(out == h.read(), "converted msgpack is not the checkpoint")
        log(f"thin368_coco as a GraphDef ({os.path.getsize(pb_path)} B, "
            f"Openpose scope, /read nodes) -> convert_pb_file -> msgpack "
            f"equal to save_flax_msgpack of the variables and to the "
            f"checkpoint file ({os.path.getsize(converted)} B) in "
            f"{time.perf_counter() - t:.2f} s")
        est_conv = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                                   params_path=converted)
        maps = []

        def conv_inference():
            out = []
            for img in imgs[:2]:
                out.append(est_conv.inference(img, upsample_size=4.0))
                maps.append((est_conv.heatMat, est_conv.pafMat))
            return out

        got = drive("convert_inference x2", conv_inference)
        launched("convert_inference x2", "smooth_nms")
        for i, img in enumerate(imgs[:2]):
            same_humans(got[i], est.inference(img, upsample_size=4.0),
                        f"converted inference image {i}")
            check(np.array_equal(maps[i][0], est.heatMat)
                  and np.array_equal(maps[i][1], est.pafMat),
                  "converted heatMat/pafMat differ")
        got = drive("convert_batch B=8", lambda: est_conv.inference_batch(
            imgs, upsample_size=4.0))
        launched("convert_batch B=8", "smooth_nms_topk_raw",
                 "score_candidates_raw")
        for i, (g, w) in enumerate(zip(got, est.inference_batch(
                imgs, upsample_size=4.0))):
            same_humans(g, w, f"converted inference_batch image {i}")
        with torch.inference_mode():
            check(torch.equal(est_conv._forward(np.stack(imgs), 368, 432),
                              est._forward(np.stack(imgs), 368, 432)),
                  "converted maps differ")
        log(f"converted estimator: humans of inference x2 and "
            f"inference_batch B=8 equal the checkpoint's "
            f"({sum(len(h) for h in got)} humans in the batch), maps bit "
            f"for bit")

        # profiling (a trace that lost K2's records is taken again, as
        # phase 5 does)
        for attempt in range(4):
            with profiling.trace(trace_dir):
                est.inference(imgs[0], upsample_size=4.0)
            durs = profiling.device_event_durations_ms(trace_dir)
            if any("smooth_nms_kernel" in k for k in durs):
                break
            log(f"  trace {attempt + 1} lists no smooth_nms_kernel; again")
            time.sleep(0.5)
        top = sorted(durs.items(), key=lambda kv: -sum(kv[1]))
        for name, ds in top[:6]:
            log(f"  trace: {sum(ds):.4f} ms x{len(ds)}  {name[:90]}")
        check(any("smooth_nms_kernel" in k for k in durs),
              "the trace lists no smooth_nms_kernel")
        convs = [k for k in durs if any(w in k.lower() for w in (
            "conv", "fprop", "implicit_gemm", "cudnn"))]
        check(bool(convs), "the trace lists no cuDNN conv kernel")
        log(f"trace of one thin inference: {len(durs)} device event names, "
            f"{sum(len(v) for v in durs.values())} events, "
            f"{sum(sum(v) for v in durs.values()):.3f} ms on the device; "
            f"smooth_nms_kernel {durs[next(k for k in durs if 'smooth_nms_kernel' in k)]} "
            f"ms; {len(convs)} conv kernel names, e.g. {convs[0][:70]} "
            f"[{smi}]")
        x = prepare(torch.from_numpy(imgs[0][None]).to(dev), 368, 432)

        def forward(t):
            return run_backbone(est.net, t)

        p50 = profiling.device_p50_ms(forward, (x,))
        med, p90 = time_cuda(lambda: forward(x))
        log(f"thin forward 432x368 B=1: device_p50_ms {p50:.4f} ms (each "
            f"call's device-busy time, traced) vs CUDA events median "
            f"{med:.4f} ms (p90 {p90:.4f}): {p50 / med:.3f}, host-bound "
            f"[{smi}]")
        check(p50 <= 1.1 * med, "device time above the call's own time")
        # at B=32 the forward is device-bound, so the events time the
        # device too and the two must agree
        x32 = prepare(torch.from_numpy(np.stack(imgs * 4)).to(dev), 368, 432)
        p50 = profiling.device_p50_ms(forward, (x32,), n_runs=10)
        med, p90 = time_cuda(lambda: forward(x32), reps=10, inner=2)
        ratio = p50 / med
        log(f"thin forward 432x368 B=32: device_p50_ms {p50:.4f} ms vs "
            f"CUDA events median {med:.4f} ms (p90 {p90:.4f}), ratio "
            f"{ratio:.3f} (bound 1/1.5 to 1.5) [{smi}]")
        check(1 / 1.5 <= ratio <= 1.5, f"device_p50_ms / events {ratio}")
        xs = prepare(torch.from_numpy(np.stack(imgs)).to(dev), 368, 432)
        am = profiling.amortized_ms(
            lambda t: forward(t[None])[..., :19].amax(), xs)
        log(f"amortized_ms of the thin forward over 8 frames (slope 8 vs "
            f"2): {am:.4f} ms per frame [{smi}]")
        timer = profiling.StageTimer()
        for img in imgs:
            with timer.section("forward"):
                out = est._forward(img[None], 368, 432)[0]
                torch.cuda.synchronize()
            with timer.section("decode"):
                decode(out, 184, 216, params).coords.cpu()
        log(f"StageTimer, thin 432x368 x8 [{smi}]:\n{timer.report()}")
        t = time.perf_counter()
        flops = est.get_flops()
        flops_cpu = est_cpu.get_flops()
        check(flops == flops_cpu, f"get_flops {flops} on the card, "
              f"{flops_cpu} on the CPU")
        log(f"get_flops thin 432x368: {flops} on the card and on the CPU "
            f"({flops / 1e9:.3f} GFLOP, convolutions; "
            f"{time.perf_counter() - t:.2f} s)")

    from tfpose_tpu_torch.evaluation import parity_sweep
    from tfpose_tpu_torch.parallel.mesh import launch
    from tfpose_tpu_torch.pipeline.preprocess import normalize

    with phase("11 mesh"):
        items, _ = rendered_coco(16, 432, 368, seed=11)
        imgs16 = [img for _, img, _ in items]
        gen = train_cli.synthetic_batches(16, (368, 368),
                                          np.random.default_rng(12))
        batches = [next(gen) for _ in range(2)]

        def record(leg, ranks):
            for r, out in enumerate(ranks):
                for what, counts in out["launches"].items():
                    path_launches[f"mesh {leg} {what}/rank{r}"] = counts
                    log(f"launches on mesh {leg} {what}, rank {r}: {counts}")
                log(f"mesh {leg} rank {r} collectives (host ms, median): "
                    f"{out['times']} [{smi}]")

        def batch_keys(batches):
            return [[humans_key(h) for h in b] for b in batches]

        def state_diff(got, want):
            """(max |d| of parameters; the BN statistics' worst |d| over
            1e-7 + 1e-5 |want| (rtol 1e-5, as allclose) and max |d|;
            max |d| of mu over the largest |mu|)."""
            par = [k for k in want if not k.startswith(("mu/", "nu/"))
                   and "running" not in k and "num_batches" not in k]
            bn = [k for k in want if "running" in k]
            mu = [k for k in want if k.startswith("mu/")]
            top = max(np.abs(want[k]).max() for k in mu)
            return (max(np.abs(got[k] - want[k]).max() for k in par),
                    max((np.abs(got[k] - want[k])
                         / (1e-7 + 1e-5 * np.abs(want[k]))).max()
                        for k in bn),
                    max(np.abs(got[k] - want[k]).max() for k in bn),
                    max(np.abs(got[k] - want[k]).max() for k in mu) / top)

        # the unsharded references on the card, with cuDNN's
        # deterministic algorithms for leg 1's bit-for-bit comparisons
        t = time.perf_counter()
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                         allow_tf32=False):
            want_humans, want_dets = evaluate_on(None, items, device=dev)
            want2 = train_steps(batches, device=dev)
            want1 = train_steps(batches[:1], device=dev)
        net_u = get_network("mobilenet_thin")
        net_u.load_state_dict(est.net.state_dict())
        net_u.eval().to(dev)
        with torch.inference_mode():
            want_maps = run_backbone(net_u, normalize(torch.as_tensor(
                np.stack(imgs16), device=dev))).cpu().numpy()
        log(f"unsharded references on the card: evaluator on 16 scenes, 2 + "
            f"1 train steps (B=16, 368x368), thin forward B=16 "
            f"({time.perf_counter() - t:.2f} s)")

        # leg 1: NCCL, one rank on the card
        t = time.perf_counter()
        (nccl,) = launch(rank_nccl_deterministic, 1, ["cuda:0"], "nccl",
                         items, batches, timeout=120)
        record("nccl 1x1", [nccl])
        check(nccl["shape"] == {"data": 1, "spatial": 1}, "make_mesh()")
        check(batch_keys(nccl["humans"]) == batch_keys(want_humans)
              and nccl["dets"] == want_dets,
              "NCCL 1x1 evaluator differs from the unsharded one")
        for k, v in want2[1].items():
            check(np.array_equal(nccl["state"][k], v),
                  f"NCCL 1x1 train state {k} differs from the unsharded "
                  f"step's")
        check(nccl["losses"] == want2[0], "NCCL 1x1 losses")
        launched_rank = nccl["launches"]["eval"]
        check(launched_rank["smooth_nms_topk_raw"] > 0
              and launched_rank["score_candidates_raw"] > 0,
              "NCCL 1x1 evaluator launched no K1 or K3")
        log(f"leg 1, NCCL 1x1 on the card ({time.perf_counter() - t:.2f} s "
            f"with the process; evaluator {nccl['eval_s']:.2f} s, 2 train "
            f"steps {nccl['train_s']:.2f} s): {len(want_dets)} detections "
            f"and the humans of 16 scenes equal the unsharded evaluator's "
            f"exactly; the train state after 2 steps equals the unsharded "
            f"one bit for bit ({len(want2[1])} tensors), losses "
            f"{nccl['losses']}")

        # legs 2 and 4: gloo, two ranks sharing the card
        t = time.perf_counter()
        two = launch(rank_gloo2, 2, ["cuda:0"] * 2, "gloo", imgs16, items,
                     ["cuda:0"] * 2, timeout=120)
        record("gloo", two)
        d = float(np.abs(two[0]["maps"] - want_maps).max())
        check(np.array_equal(two[0]["maps"], two[1]["maps"]),
              "gloo 1x2: the ranks' gathered maps differ")
        check(d <= 1e-4, f"gloo 1x2 thin forward differs by {d}")
        for r, out in enumerate(two):
            check(not any(out["launches"]["forward"].values()),
                  "the sharded forward launched a decode kernel")
            check(out["launches"]["eval"]["smooth_nms_topk_raw"] > 0
                  and out["launches"]["eval"]["score_candidates_raw"] > 0,
                  f"gloo 2x1 rank {r} launched no K1 or K3")
            for g, w in zip(out["humans"], want_humans):
                for i, (gh, wh) in enumerate(zip(g, w)):
                    same_humans(gh, wh, f"gloo 2x1 rank {r} image {i}")
            check([x["image_id"] for x in out["dets"]]
                  == [x["image_id"] for x in want_dets],
                  f"gloo 2x1 rank {r}: detections")
        exact = all(batch_keys(out["humans"]) == batch_keys(want_humans)
                    for out in two)
        log(f"legs 2 and 4, gloo on two ranks sharing the card "
            f"({time.perf_counter() - t:.2f} s with the processes): thin368 "
            f"forward 432x368 B=16 on (1 x 2) in {two[0]['fwd_s']:.2f} s "
            f"(then {two[0]['fwd_ms']:.2f} ms per call), gathered maps max "
            f"|d| {d:.3g} from the unsharded forward (atol 1e-4); evaluator "
            f"on (2 x 1) in {two[0]['eval_s']:.2f} s: every rank's humans "
            f"equal the unsharded ones (parts exact, coords 1e-6, scores "
            f"1e-4; exactly: {exact}) [{smi}]")

        # leg 3: gloo, four ranks sharing the card
        t = time.perf_counter()
        four = launch(rank_gloo4, 4, ["cuda:0"] * 4, "gloo", batches[:1],
                      ["cuda:0"] * 4, timeout=180)
        record("gloo 2x2 train", four)
        got = four[0]["state"]
        dl = abs(four[0]["losses"][0] - want1[0][0]) / want1[0][0]
        dp, dbn, dbn_abs, dmu = state_diff(got, want1[1])
        check(dl <= 1e-5, f"gloo 2x2 loss rel {dl}")
        check(dbn <= 1, f"gloo 2x2 BN statistics {dbn_abs} (allclose "
              f"ratio {dbn})")
        check(dp <= 2.1e-4, f"gloo 2x2 parameters {dp}")
        check(dmu <= 0.15, f"gloo 2x2 gradients {dmu} of the largest")
        log(f"leg 3, gloo (2 x 2) on four ranks sharing the card "
            f"({time.perf_counter() - t:.2f} s with the processes; the step "
            f"{four[0]['train_s']:.2f} s): one step of thin 368x368 B=16 "
            f"against the unsharded step: loss rel {dl:.3g} (rtol 1e-5), "
            f"BN statistics max |d| {dbn_abs:.3g} ({dbn:.3g} of rtol 1e-5 "
            f"with atol 1e-7), parameters max |d| "
            f"{dp:.3g} (2.1e-4), gradients (mu) {dmu:.3g} of the largest "
            f"(0.15); the four ranks' states equal bit for bit "
            f"(assert_replicas_equal in the ranks) [{smi}]")

    with phase("12 parity sweep"):
        scene, sparams = parity_sweep._scene(np.random.default_rng(0),
                                             "crowd")
        parity_sweep._oracle_humans(scene, sparams)     # warm-up
        t = time.perf_counter()
        parity_sweep._oracle_humans(scene, sparams)
        per = time.perf_counter() - t
        # as many whole rounds of the 8 recipes as ~30 s of the oracle
        # on the host allow, at least 2 scenes per recipe
        n = 8 * max(2, min(8, int(30.0 / (8 * per))))
        gxx = any(os.access(os.path.join(d, "g++"), os.X_OK)
                  for d in os.environ.get("PATH", "").split(os.pathsep))
        cpp_every = 2 if gxx else 0
        t = time.perf_counter()
        stats = drive("parity_sweep", lambda: parity_sweep.run_sweep(
            n, seed0=3000, cpp_every=cpp_every))
        launched("parity_sweep", "smooth_nms_topk_raw",
                 "score_candidates_raw")
        check(stats.mismatch_total == 0,
              f"parity sweep: {stats.mismatch_total} mismatches: "
              f"{stats.examples}")
        check(stats.cpp_mismatch == 0, f"C++ oracle: {stats.examples}")
        check(stats.escalated >= n // 8, "no scene escalated to K=128")
        log(f"parity sweep on the card ({time.perf_counter() - t:.2f} s; the "
            f"oracle {per:.2f} s per scene on the host): {stats.total} "
            f"scenes, {len(stats.per_recipe)} recipes, 0 mismatches, "
            f"{stats.escalated} escalated to K=128, mean deviation "
            f"{stats.mean_px_deviation:.3g} px over {stats.dev_px_n} "
            f"keypoints; C++ oracle {stats.cpp_mismatch}/{stats.cpp_total}"
            f"{'' if gxx else ' (no g++)'}")
        t = time.perf_counter()
        ck = drive("parity_ckpt_sweep", lambda: parity_sweep.run_ckpt_sweep(
            8, CHECKPOINT, (432, 368), seed0=3000, cpp_every=cpp_every))
        launched("parity_ckpt_sweep", "smooth_nms_topk_raw",
                 "score_candidates_raw")
        check(ck.total == 8 and ck.mismatch_total == 0,
              f"checkpoint sweep: {ck.examples}")
        check(ck.cpp_mismatch == 0, f"C++ oracle: {ck.examples}")
        log(f"checkpoint sweep on the card ({time.perf_counter() - t:.2f} s): "
            f"8 rendered 432x368 scenes through thin368_coco, 0 mismatches, "
            f"{ck.dev_px_n} keypoints, C++ oracle "
            f"{ck.cpp_mismatch}/{ck.cpp_total}")

    from tfpose_tpu_torch import profiles
    from tfpose_tpu_torch.cli import broadcaster, visualization
    from tfpose_tpu_torch.evaluation import backbone_sweep
    from tfpose_tpu_torch.profiles import stages as stage_profile

    with phase("13 tools"):
        # the broadcaster loads the model's converted checkpoint from
        # $TFPOSE_TPU_MODEL_DIR/jax/<model>/: thin368_coco, linked there
        model_dir = os.path.join(ROOT, "tfpose_tpu_torch", "_build",
                                 "chip_smoke_models")
        link = os.path.join(model_dir, "jax", "mobilenet_thin",
                            "params.msgpack")
        os.makedirs(os.path.dirname(link), exist_ok=True)
        if not os.path.lexists(link):
            os.symlink(CHECKPOINT, link)
        old_dir = os.environ.get("TFPOSE_TPU_MODEL_DIR")
        os.environ["TFPOSE_TPU_MODEL_DIR"] = model_dir
        bframes = render_frames(np.random.default_rng(1313), 8, 480, 640)
        want = [humans_to_msg(est.inference(f, upsample_size=4.0), 640, 480)
                for f in bframes]
        check(sum(len(m.persons) for m in want) > 0, "broadcaster: no humans")
        for max_batch in (1, 8):
            path = f"broadcaster_b{max_batch}"
            svc = broadcaster.build_service(broadcaster.parse_args(
                ["--port", "0", "--max-batch", str(max_batch)]))
            client = None
            try:
                check(svc.estimator.device.type == "cuda",
                      "broadcaster not on the card")
                client = PoseClient(*svc.start())
                t = time.perf_counter()
                got = drive(path, lambda: [visualization.annotate(client, f)
                                           for f in bframes])
                secs = time.perf_counter() - t
                flushes = (sum(svc._batcher.batch_sizes.values())
                           if max_batch > 1 else 0)
            finally:
                if client is not None:
                    client.close()
                svc.stop()
            n = path_launches[path]
            if max_batch == 1:
                check(n == {"smooth_nms_topk_raw": 0, "smooth_nms": 8,
                            "score_candidates_raw": 0, "smooth_nms_topk": 0},
                      f"{path}: launches {n}, want K2 8 only")
            else:
                check(flushes >= 1 and n == {
                    "smooth_nms_topk_raw": flushes, "smooth_nms": 0,
                    "score_candidates_raw": flushes, "smooth_nms_topk": 0},
                    f"{path}: launches {n}, want K1 and K3 once per flush "
                    f"({flushes})")
            for i, ((humans, img), w) in enumerate(zip(got, want)):
                same_persons(humans_to_msg(humans, 640, 480), w,
                             f"{path} frame {i}")
                check(img.shape == bframes[i].shape
                      and (not humans or (img != bframes[i]).any()),
                      f"{path} frame {i}: no skeleton drawn")
            log(f"broadcaster (thin368_coco, 432x368, max_batch {max_batch}"
                f"): 8 rendered 640x480 frames through visualization."
                f"annotate in {secs * 1e3:.1f} ms, humans equal inference's "
                f"on the card (parts exact, coords 1e-6, scores 1e-4); "
                f"launches {n} [{smi}]")
        if old_dir is None:
            del os.environ["TFPOSE_TPU_MODEL_DIR"]
        else:
            os.environ["TFPOSE_TPU_MODEL_DIR"] = old_dir

        # BASELINE config 5: the bf16 sweep over the checkpoints on the card
        log("sweep: the cmu row is not run: its checkpoint cmu160_coco "
            "(200 MB) is not copied to the card")
        gates = {"mobilenet_thin": 0.95, "mobilenet_v2_large": 0.88,
                 "mobilenet_v2_small": 0.90, "mobilenet": 0.92}
        t = time.perf_counter()
        doc = drive("backbone_sweep", lambda: backbone_sweep.main([
            "--models", ",".join(gates), "--scenes", "50", "--out",
            os.path.join(ROOT, "tfpose_tpu_torch", "_build",
                         "chip_smoke_sweep.json")]))
        launched("backbone_sweep", "smooth_nms_topk_raw",
                 "score_candidates_raw")
        check(set(doc["backbones"]) == set(gates),
              f"sweep rows {sorted(doc['backbones'])}")
        for model, gate in gates.items():
            row = doc["backbones"][model]
            check(row["AP50"] >= gate and row["img_per_s"] > 0,
                  f"sweep {model}: AP50 {row['AP50']} (gate {gate})")
        log(f"backbone sweep, 50 scenes each, bf16, in "
            f"{time.perf_counter() - t:.2f} s; every AP50 gate held [{smi}]")

        # the decode's stages, the forward and the per-op table, each
        # through tfpose-torch-profile's main, which prints its JSON lines
        for b in (1, 16):
            path = f"profile_stages_b{b}"
            sdoc = drive(path, lambda: profiles.main(
                ["stages", "--batch", str(b), "--json"]))
            launched(path, "smooth_nms_topk", "score_candidates_raw",
                     "smooth_nms_topk_raw")
            check(all(np.isfinite(r["ms_per_img"]) and r["busy_ms_per_img"] > 0
                      and r["kernels_per_call"] > 0 for r in sdoc["stages"]),
                  f"{path}: {sdoc}")
            log(stage_profile.report(sdoc))
        thin_flops = est.get_flops()
        fdocs = drive("profile_forward", lambda: profiles.main(["forward"]))
        check(not any(path_launches["profile_forward"].values()),
              "profile_forward launched a decode kernel")
        check([(r["model"], r["batch"]) for r in fdocs] == [
            ("mobilenet_thin", 1), ("mobilenet_thin", 16), ("cmu", 1),
            ("cmu", 8)], f"profile_forward configs {fdocs}")
        for r in fdocs:
            check(0 < r["tensor_peak_pct"] < 100 and r["top_ops"],
                  f"profile_forward: {r}")
            if r["model"] == "mobilenet_thin":
                check(abs(r["gflops"] - thin_flops * r["batch"] / 1e9)
                      <= 0.01, f"profile_forward: {r['gflops']} GFLOP, "
                      f"get_flops {thin_flops * r['batch'] / 1e9}")
            log(f"forward {r['model']} {r['hw']} B={r['batch']} bf16: device "
                f"p50 {r['device_p50_ms']} ms, {r['gflops']} GFLOP, "
                f"{r['achieved_tflops']} TFLOP/s = {r['tensor_peak_pct']} % "
                f"of {r['peak']} [{smi}]")
        odoc = drive("profile_ops cmu B=8",
                     lambda: profiles.main(["ops", "--json"]))
        check(odoc["model"] == "cmu" and odoc["batch"] == 8
              and odoc["buckets_ms"].get("conv", 0.0) > 0
              and abs(sum(odoc["buckets_ms"].values())
                      - odoc["op_total_ms"]) <= 1e-6 * odoc["op_total_ms"],
              f"profile_ops: {odoc['buckets_ms']}")
        log(f"per-op table cmu 656x368 B=8 bf16: {odoc['op_total_ms']:.3f} ms "
            f"of device time per forward, buckets "
            f"{ {k: round(v, 3) for k, v in odoc['buckets_ms'].items()} } "
            f"[{smi}]")

    # every path's launches, the serving and bf16 paths included
    for entry in kernels:
        name = entry["name"]
        entry["launches_by_path"] = {path: n[name] for path, n in
                                     path_launches.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())

    print("kernels: " + ", ".join(wrappers), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
