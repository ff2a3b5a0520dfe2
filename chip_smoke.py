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
     of the batches, and their profiles; K1-K3 at the new grids.

Any failed check raises, so the run exits non-zero and prints no result.
The last lines are the kernels driven, one JSON line per the kernels'
numbers, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. The script imports torch, numpy and
the port only, and writes nothing outside ``tfpose_tpu_torch/_build/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
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


def smi_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True)
    return out.stdout.strip().splitlines()[0]


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

    dev = torch.device("cuda")
    wrappers = {"smooth_nms_topk_raw": smooth_nms_topk_raw,
                "smooth_nms": smooth_nms,
                "score_candidates_raw": score_candidates_raw,
                "smooth_nms_topk": smooth_nms_topk}
    err = {name: 0.0 for name in wrappers}
    params = DecodeParams()

    with phase("0 device"):
        kind = torch.cuda.get_device_name(0)
        smi = smi_name_and_power()
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
            for _ in range(3):  # the profiler now and then loses records
                dms, per = device_ms(name, profile_calls(fn, n=20)[3])
                if dms is not None:
                    break
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

    print("kernels: " + ", ".join(wrappers), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
