#!/usr/bin/env python3
"""Drive the port's main paths once on one CUDA card, hold each hand
kernel (K1-K6) against its plain version on the inputs those paths hand
it, and time each beside its bound.

    python3 chip_smoke.py

The card's pass/fail checks are the ``cuda``-marked tests (README.md,
"PyTorch / CUDA port"); this script is the per-kernel yardstick beside
them. It

1. prints the card's name and power limit and turns TF32 off;
2. builds the kernels (``ops/kernels/build.py``);
3. runs each benchmark cell's entry point once at the cell's shape, with
   the kernels' launch counts set to 0 just before and read just after
   (``torch_cases.counted``): thin368_coco ``inference`` of one 432x368
   scene (thin432-single), ``inference_batch`` B=16 (thin432-batch16)
   and ``BatchedEvaluator.run_batch`` of 16 (one card's share of
   thin432-mesh4-eval, unsharded); CMU and BODY_25 (seeded weights) in
   bf16, ``inference_batch`` B=16 at 656x368 (cmu656-bf16-batch16,
   body25-656-bf16-batch16); and ``inference_windowed`` of one 1280x720
   frame, K4's path. Each path must launch its kernels and no others;
   the thin paths must find people;
4. records the inputs of each kernel's first call of each shape on those
   paths and holds the kernel against its plain version on copies of
   them: K1 bit for bit against its own phase arithmetic
   (``torch_cases.k1_phase_reference``) and with the plain version's
   peaks (scores rtol 1e-5), K2, K3, K5 and K6 bit for bit (K6 on every
   value of the buffers it writes into), K4 with indices exact and
   scores within 1e-6;
5. times each case: ``device_ms`` the device time of the kernel's own
   launches a call (``torch.profiler`` over 20 calls), ``ms`` a call of
   its wrapper and ``library_ms`` one of its plain PyTorch version on
   the card (CUDA events, median of 20 runs of 10 calls after warm-up;
   below ~0.1 ms the wrapper's host time sets ``ms``), ``bound_ms`` the
   least time of the bytes and operations its inputs need at the H100
   SXM data sheet's HBM bandwidth and float32 rate (each input byte read
   once, each output byte written once), and ``roofline_pct`` the bound
   over ``device_ms``.

Any failed check raises, so the run exits non-zero and prints no
result; without a card it exits 1. The last lines are one JSON line
``{"kernels": [...]}`` (each kernel's launches by path and its cases) and
``{"ok": true, "device": {...}}``. It imports the standard library,
numpy, torch, the port and ``tests/torch_cases.py`` only, and writes
nothing but the kernels' build directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
T0 = time.perf_counter()
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
K1, K2, K3, K4, K5, K6 = ("smooth_nms_topk_raw", "smooth_nms",
                          "score_candidates_raw", "smooth_nms_topk",
                          "assemble_dense", "bias_prelu")
SOURCES = {K1: "csrc/smooth_nms_topk_raw.cu", K2: "csrc/smooth_nms.cu",
           K3: "csrc/paf_score.cu", K4: "csrc/smooth_nms_topk.cu",
           K5: "csrc/assemble.cu", K6: "csrc/bias_prelu.cu"}
# each wrapper's own kernels, by the names a profiler gives them
OWN = {K1: ("phase_peaks_kernel", "select_kernel"),
       K2: ("smooth_nms_kernel",), K3: ("score_candidates_kernel",),
       K4: ("blur_peaks_kernel", "select_kernel"), K5: ("assemble_kernel",),
       K6: ("bias_prelu_vec",)}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_cuda(fn, reps: int = 20, inner: int = 10) -> float:
    """Median ms per call: CUDA events around ``inner`` calls, ``reps``
    times, after two warm-up calls."""
    import numpy as np
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return float(np.median(per))


def device_ms(name, fn, n: int = 20):
    """Device ms a call of ``name``'s own kernels over ``n`` calls
    (``torch.profiler``, CUPTI), or None where one of them left no
    record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    hits = [[e.self_device_time_total for e in rows if sym in e.key]
            for sym in OWN[name]]
    return sum(map(sum, hits)) / n / 1e3 if all(hits) else None


# ---- recording each kernel's inputs on the paths

def copy_args(x, memo):
    """A copy of a call's arguments on the same device that keeps their
    layout and aliasing: tensors that share memory (a tensor passed
    twice, a slice of a concat buffer) share the copy of it, at their own
    offsets and strides. (Views made in inference mode, as the forward's
    are, know no base, so the copy goes by storage.)"""
    import torch

    if isinstance(x, torch.Tensor):
        st = x.untyped_storage()
        if st.data_ptr() not in memo:
            memo[st.data_ptr()] = st.clone()
        return torch.empty(0, dtype=x.dtype, device=x.device).set_(
            memo[st.data_ptr()], x.storage_offset(), x.size(), x.stride())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(copy_args(v, memo) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(copy_args(v, memo) for v in x)
    return x


def describe(args) -> str:
    """A call's shape: its tensors' sizes (and types other than
    float32), its numbers, K, and how many outputs it writes."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append("x".join(map(str, a.shape))
                       + ("" if a.dtype == torch.float32 else
                          f" {str(a.dtype)[6:]}"))
        elif isinstance(a, tuple) and hasattr(a, "_fields"):
            out.append(describe(a[:1]))
        elif isinstance(a, (list, tuple)) and all(
                isinstance(t, torch.Tensor) for t in a):
            out.append(f"{len(a)} out{'s' * (len(a) > 1)}" + (
                ", a slice" if any(t.untyped_storage().nbytes() > t.numel()
                                   * t.element_size() for t in a) else ""))
        elif isinstance(a, tuple):
            out.append("x".join(map(str, a)))
        elif hasattr(a, "max_peaks"):
            out.append(f"K={a.max_peaks}")
        elif isinstance(a, (int, float)):
            out.append(str(a))
    return " ".join(out)


def recording(cases, path):
    """Replace each kernel in the modules that call it by a shim that
    keeps a copy of the inputs of its first call of each shape (in
    ``cases``, by (kernel, shape)), then calls it. Returns the undo."""
    from tfpose_tpu_torch.models import layers
    from tfpose_tpu_torch.ops import decode

    holders = {K1: decode, K2: decode, K3: decode, K4: decode, K5: decode,
               K6: layers}
    saved = {name: getattr(mod, name) for name, mod in holders.items()}

    def shim(name, fn):
        def call(*args, **kw):
            shape = describe(args)
            if (name, shape) not in cases:
                cases[(name, shape)] = (path, copy_args((args, kw), {}))
            return fn(*args, **kw)
        return call

    for name, mod in holders.items():
        setattr(mod, name, shim(name, saved[name]))
    return lambda: [setattr(holders[n], n, f) for n, f in saved.items()]


# ---- each kernel's plain version, comparison and bound

def plain_call(name, args, kw):
    from tfpose_tpu_torch.ops.assemble import (
        assemble_dense_plain, normalise_coords)
    from tfpose_tpu_torch.ops.kernels.bias_prelu import bias_prelu_plain
    from tfpose_tpu_torch.ops.kernels.paf_score import (
        score_candidates_raw_plain)
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        smooth_nms_plain, smooth_nms_topk_plain, smooth_nms_topk_raw_plain)

    kw = {k: v for k, v in kw.items() if k != "cap"}
    if name == K5:
        # the plain version takes a batch; the wrapper also one image
        pk, conns, params, size = args[:4]
        one = pk.x.dim() == 2
        if one:
            pk, conns = (type(t)(*(v[None] for v in t)) for t in (pk, conns))
        out = assemble_dense_plain(pk, conns, params, *args[4:], **kw)
        out = out if size is None else normalise_coords(out, *size)
        return type(out)(*(v[0] for v in out)) if one else out
    return {K1: smooth_nms_topk_raw_plain, K2: smooth_nms_plain,
            K3: score_candidates_raw_plain, K4: smooth_nms_topk_plain,
            K6: bias_prelu_plain}[name](*args, **kw)


def written(args):
    """K6's outputs: the whole memory of ``y`` and of every output (the
    concat buffer of a slice), as bytes."""
    import torch

    return [torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        t.untyped_storage()) for t in [args[0], *args[3]]]


def compare(name, args, got, want, got_args, want_args, what):
    import torch

    from torch_cases import (
        k1_phase_reference, k2_compare, k3_compare, k4_compare, k5_compare)

    if name == K1:
        s1, i1 = k1_phase_reference(*args[:7])
        check(torch.equal(got[0], s1) and torch.equal(got[1], i1),
              f"K1 differs from its phase arithmetic on {what}")
        (s, i), (s0, i0) = got, want
        i_sorted, order = i.sort(1)
        i0_sorted, order0 = i0.sort(1)
        check(torch.equal(i_sorted, i0_sorted),
              f"K1 peaks differ from its plain version's on {what}")
        torch.testing.assert_close(s.gather(1, order), s0.gather(1, order0),
                                   rtol=1e-5, atol=0)
    elif name == K2:
        k2_compare(got, want, what)
    elif name == K3:
        k3_compare(got, want, what)
    elif name == K4:
        k4_compare(got, want)
    elif name == K5:
        k5_compare(got, want, what)
    else:
        check(all(torch.equal(a, b) for a, b in zip(written(got_args),
                                                     written(want_args))),
              f"K6 differs from its plain version on {what}")


def work(name, args, kw):
    """(bytes, operations) that a call's inputs need."""
    import torch

    from tfpose_tpu_torch.core.topology import COCO18
    from tfpose_tpu_torch.ops.kernels.paf_score import candidate_geometry
    from tfpose_tpu_torch.ops.kernels.smooth_nms import _phase_tables

    if name == K1:
        hb, fy, fx, k, _, kernlen, nsig = args[:7]
        h8, w8, c = hb.shape
        wv, _, wh = _phase_tables(fy, fx, kernlen, float(nsig),
                                  str(hb.device))[:3]
        nv, nh = wv.shape[1], wh.shape[1]
        up_h, up_w = fy * h8, fx * w8
        return (hb.numel() * 4 + (wv.numel() + wh.numel()) * 4 + c * k * 8,
                c * (up_h * (w8 + nh - 1) * 2 * nv + up_h * up_w * 2 * nh
                     + up_h * up_w * 8))
    if name in (K2, K4):
        # a separable blur (a multiply and an add a tap, both passes) and
        # the 3x3 NMS a value; K2 writes the map, K4 K peaks a plane
        heat, at = args[0], 1 if name == K2 else 3
        kernlen = args[at] if len(args) > at else 25
        n = heat.numel()
        out = n * 4 if name == K2 else heat.shape[2] * args[1] * 8
        return n * 4 + out, n * (2 * (2 * kernlen - 1) + 9)
    if name == K3:
        # each PAF cell (both channels of its limb) that a candidate with
        # two valid ends samples, read once; 9 B of peak a slot, 5 B of
        # result a candidate; 16 operations a candidate, 13 a sample
        pk, paf8, up_h, up_w, params = args[:5]
        skeleton = kw.get("skeleton", COCO18)
        b, _, k = pk.x.shape
        h8, w8 = paf8.shape[1:3]
        pairs = torch.as_tensor(skeleton.pairs_array(), dtype=torch.long,
                                device=pk.x.device)
        live = (pk.valid[:, pairs[:, 0], :, None]
                & pk.valid[:, pairs[:, 1], None, :])
        iy, ix = candidate_geometry(pk, up_h, up_w, params, skeleton)[-2:]
        cell = ((iy.long() // (up_h // h8)) * w8
                + ix.long() // (up_w // w8))
        plane = torch.arange(b * len(pairs), device=cell.device) * (h8 * w8)
        cell = cell + plane.reshape(b, len(pairs), 1, 1, 1)
        n = b * len(pairs) * k * k
        return (torch.unique(cell[live]).numel() * 8 + pk.x.numel() * 9
                + n * 5, 16 * n + (13 * params.step_paf + 1)
                * int(live.sum()))
    if name == K5:
        # the peaks and connections (13 B a slot) read, the humans
        # written; its dependent walk, not its operations, bounds it
        pk, conns, params = args[:3]
        parts, k = pk.x.shape[-2:]
        b, limbs = pk.x[..., 0, 0].numel(), conns.valid.shape[-2]
        return (b * (parts + limbs) * k * 13
                + b * params.max_humans * (parts * 13 + 5) + b * parts, 0)
    y, outs = args[0], args[3]
    return (y.numel() * y.element_size() * (1 + len(outs))
            + 2 * y.shape[1] * 4, 2 * y.numel())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: nothing to drive")
        return 1
    from torch_cases import CHECKPOINT, counted, render_frames
    from tfpose_tpu_torch.estimator import TfPoseEstimator
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.ops.kernels import build, wrappers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    device = {"name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "nvidia_smi": smi.stdout.strip().splitlines()[:1]}
    log(f"device {device}")
    log(f"built the kernels in {build.build_all():.1f} s")

    rng = np.random.default_rng(0)
    imgs = render_frames(rng, 16, 368, 432)
    frames656 = render_frames(rng, 16, 368, 656)
    frame720 = render_frames(rng, 1, 720, 1280)[0]
    thin = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                           params_path=CHECKPOINT, device="cuda")
    ev = BatchedEvaluator("mobilenet_thin", (432, 368), batch_size=16,
                          dtype="float32", device="cuda")
    ev.load_params(CHECKPOINT)
    seeded = {m: TfPoseEstimator(m, target_size=(656, 368),
                                 dtype="bfloat16", device="cuda")
              for m in ("cmu", "body25")}
    decode_k = {K1: None, K3: None, K5: None}
    # path -> (call, {kernel: the launches it must make, None for at
    # least one; every other kernel must not launch}, whether it must
    # find people)
    paths = {
        "thin432-single: inference 432x368": (
            lambda: thin.inference(imgs[0], upsample_size=4.0),
            {K2: None, K5: None}, True),
        "thin432-batch16: inference_batch B=16 432x368": (
            lambda: thin.inference_batch(imgs, upsample_size=4.0),
            decode_k, True),
        "thin432-mesh4-eval: BatchedEvaluator.run_batch 16 (one card)": (
            lambda: ev.run_batch(np.stack(imgs)), decode_k, True),
        "cmu656-bf16-batch16: cmu inference_batch B=16 656x368 bf16": (
            lambda: seeded["cmu"].inference_batch(frames656,
                                                  upsample_size=4.0),
            decode_k, False),
        "body25-656-bf16-batch16: body25 inference_batch B=16 656x368 "
        "bf16": (
            lambda: seeded["body25"].inference_batch(frames656,
                                                     upsample_size=4.0),
            {K1: 1, K3: 1, K5: 1, K6: 99}, False),
        "inference_windowed 1280x720 (K4's path)": (
            lambda: thin.inference_windowed(frame720, upsample_size=4.0),
            {K4: None, K3: None, K5: None}, True),
    }
    cases, by_path = {}, {}
    for path, (run, want, people) in paths.items():
        undo = recording(cases, path)
        try:
            out, n = counted(run)
        finally:
            undo()
        by_path[path] = n
        log(f"path {path}: launches {n}")
        for name in wrappers():
            expect = want.get(name, 0)
            check(n[name] > 0 if expect is None else n[name] == expect,
                  f"{path}: {name} launched {n[name]} times, not "
                  f"{'some' if expect is None else expect}")
        humans = out if out and isinstance(out[0], list) else [out]
        check(not people or sum(map(len, humans)) > 0,
              f"{path}: no people found")

    kernels = {}
    for (name, shape), (path, (args, kw)) in cases.items():
        what = f"{name} {shape} ({path.split(':')[0]})"
        ka, kk = copy_args((args, kw), {})
        pa, pk = copy_args((args, kw), {})
        fn = wrappers()[name]
        got = fn(*ka, **kk)
        want = plain_call(name, pa, pk)
        torch.cuda.synchronize()
        compare(name, args, got, want, ka, pa, what)
        nbytes, ops = work(name, args, kw)
        t_b, t_f = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_FLOPS * 1e3
        # the profiler now and then loses a kernel's records: again
        for _ in range(4):
            dms = device_ms(name, lambda: fn(*ka, **kk))
            if dms is not None:
                break
        check(dms is not None, f"no device time for {what}")
        case = {"path": path, "shape": shape, "device_ms": dms,
                "ms": time_cuda(lambda: fn(*ka, **kk)),
                "library_ms": time_cuda(lambda: plain_call(name, pa, pk)),
                "bound_ms": max(t_b, t_f),
                "bound_by": "bytes" if t_b >= t_f else "operations",
                "bytes": nbytes, "operations": ops}
        case["roofline_pct"] = 100 * case["bound_ms"] / dms
        log(f"{what}: equal to its plain version; device {dms:.5f} ms, "
            f"call {case['ms']:.5f} ms, plain {case['library_ms']:.5f} ms, "
            f"bound {case['bound_ms']:.6f} ms ({case['bound_by']}, "
            f"{case['roofline_pct']:.2f} %)")
        kernels.setdefault(name, {
            "name": name, "source": f"tfpose_tpu_torch/{SOURCES[name]}",
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "cases": []})["cases"].append(case)
    check(set(kernels) == set(SOURCES), f"kernels held: {sorted(kernels)}")
    for k in kernels.values():
        k.update({f: k["cases"][0][f] for f in (
            "device_ms", "ms", "library_ms", "bound_ms", "bound_by",
            "roofline_pct")})
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
