#!/usr/bin/env python3
"""Time the port's decode kernels on one CUDA card, at the shapes of the
paths that run them, and optionally save or compare their outputs.

    python3 scripts/torch_topk_times.py [--root DIR] [--label NAME]
        [--save OUT.npz] [--compare REF.npz] [--json OUT.json]

``--root`` is the checkout whose ``tfpose_tpu_torch`` is imported (the
default: this script's repository), so two trees can be timed on the
same card in turns. Cases, each on seeded rendered scenes:

* K1 ``smooth_nms_topk_raw`` at 4x on (46, 54, 18) (B=1) and
  (46, 54, 144) (B=8), K=32: the ``inference_batch`` path;
* K4 ``smooth_nms_topk`` on (360, 640, 18) (a 1280x720 frame's merged
  map at 4x, the windowed and multi-scale paths) and (115, 135, 144)
  (B=8 at 2.5x), K=32;
* K2 ``smooth_nms`` on (184, 216, 19) (the ``inference`` path at 4x);
* K3 through the tree's raw-grid candidate scoring call,
  ``ops/kernels/paf_score.py:score_candidates_raw`` or, in a tree without
  it, ``ops/paf.py:score_candidates_raw_batch`` (the batch, windowed and
  multi-scale paths' scoring, whatever kernels and glue the tree runs for
  it) at B = 1 and 8 on 46x54 raw planes at 4x and on a 1280x720 frame's
  merged 90x160 grid at 4x, K=32.

For each: the median and p90 ms per call by CUDA events, and from
``torch.profiler`` the device ms per launch of the tree's own CUDA
kernels (everything but PyTorch's kernels, copies and fills), the device
ms and the number of all CUDA kernels per call, and the least time the
card could take (bytes over 3.35 TB/s or operations over 67 TFLOP/s
fp32, whichever is larger). ``--save`` writes every output of a fixed
corpus (the cases above at K = 32 and 128, noise, plateaus, the warm-up
maps) to an ``.npz``; ``--compare`` checks them bit for bit against such
a file. One JSON line per case, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--save")
    ap.add_argument("--compare")
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_topk_times: no CUDA card available", file=sys.stderr)
        return 1
    from tfpose_tpu_torch.core.config import DecodeParams
    from tfpose_tpu_torch.core.topology import pairs_array
    from tfpose_tpu_torch.ops import nms, paf, resize
    from tfpose_tpu_torch.ops.kernels import build
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        _phase_tables, smooth_nms, smooth_nms_topk, smooth_nms_topk_raw)
    from tfpose_tpu_torch.utils import synthetic

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    build.build_all()
    for stem in ("smooth_nms_topk_raw", "smooth_nms_topk", "smooth_nms",
                 "paf_score"):
        for line in build.build_log.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {stem}: {line.strip()}", flush=True)

    rng = np.random.default_rng(0)
    nets = torch.from_numpy(np.stack(
        [synthetic.render_scene(rng, n, 46, 54)[0]
         for n in (3, 1, 5, 0, 2, 6, 4, 2)])).to(dev)
    net720 = torch.from_numpy(synthetic.render_scene(
        np.random.default_rng(4), 3, 90, 160)[0]).to(dev)

    def heat8(b):
        return nets[:b, ..., :18].permute(1, 2, 0, 3).reshape(
            46, 54, -1).contiguous()

    def planes_up(net_b, up_h, up_w):
        heat = resize.resize_area(net_b[..., :19], up_h, up_w)[..., :18]
        return heat.permute(0, 3, 1, 2).reshape(-1, up_h, up_w).permute(
            1, 2, 0)

    wv, _, wh = _phase_tables(4, 4, 25, 3.0, str(dev))[:3]
    nv, nh = wv.shape[1], wh.shape[1]

    def k1_cost(x):
        c = x.shape[2]
        nbytes = x.numel() * 4 + (wv.numel() + wh.numel()) * 4 + c * 32 * 8
        ops = c * (184 * (54 + nh - 1) * 2 * nv + 184 * 216 * 2 * nh
                   + 184 * 216 * 8)
        return nbytes, ops

    def k4_cost(x):
        return (x.numel() * 4 + x.shape[2] * 32 * 8,
                x.numel() * (2 * (2 * 25 - 1) + 9))

    def k2_cost(x):
        return 2 * x.numel() * 4, x.numel() * (2 * (2 * 25 - 1) + 9)

    params = DecodeParams()
    pair_parts = torch.as_tensor(pairs_array(), dtype=torch.long, device=dev)

    def peaks(s, i, b, up_w):
        s, i = s.reshape(b, 18, -1), i.reshape(b, 18, -1).clamp(min=0)
        return nms.Peaks(x=i % up_w, y=i // up_w, score=s, valid=s > 0.05)

    steps = (torch.arange(params.step_paf, dtype=torch.float32)
             / params.step_paf).to(dev)

    def k3_cost(pk, paf8, up_h, up_w):
        """Bytes: the peaks, 5 B of result per candidate, and each PAF
        cell (both channels of its pair) that a live candidate (outside the
        row skip) samples, once; a dead candidate reads no PAF. Operations:
        about 16 per candidate and 13 per sample of a live one."""
        b, _, k = pk.x.shape
        h8, w8 = paf8.shape[1:3]
        va = pk.valid[:, pair_parts[:, 0]].sum(-1)
        nrows = torch.where(pk.valid[:, pair_parts[:, 1]].any(-1),
                            (va * k + 127) // 128, 0)
        rows = torch.arange(k * k, device=dev).reshape(k, k) // 128
        live = rows < nrows[..., None, None]                # (B, 19, K, K)
        ax, ay = (t[:, pair_parts[:, 0], :, None, None].float()
                  for t in (pk.x, pk.y))
        bx, by = (t[:, pair_parts[:, 1], None, :, None].float()
                  for t in (pk.x, pk.y))
        iy = torch.floor(ay + (by - ay) * steps + 0.5).clamp(0, up_h - 1)
        ix = torch.floor(ax + (bx - ax) * steps + 0.5).clamp(0, up_w - 1)
        plane = torch.arange(b * 19, device=dev).reshape(b, 19, 1, 1, 1)
        cell = ((plane * h8 + iy.long() // (up_h // h8)) * w8
                + ix.long() // (up_w // w8))
        cells = torch.unique(cell[live]).numel()
        n = b * 19 * k * k
        return (cells * 8 + pk.x.numel() * 9 + n * 5,
                16 * n + (13 * params.step_paf + 1) * int(live.sum()))

    try:
        from tfpose_tpu_torch.ops.kernels.paf_score import (
            score_candidates_raw as score_raw)
    except ImportError:  # a tree that scores through its ops/paf.py glue
        score_raw = paf.score_candidates_raw_batch

    def k3(pk, paf8, up_h, up_w):
        return lambda: score_raw(pk, paf8, up_h, up_w, params)

    x1, x8 = heat8(1), heat8(8)
    x720, x25 = planes_up(net720[None], 360, 640), planes_up(nets, 115, 135)
    heat_up = resize.resize_area(nets[0, ..., :19], 184, 216).contiguous()
    pk1 = peaks(*smooth_nms_topk_raw(x1, 4, 4, 32, 0.05), 1, 216)
    pk8 = peaks(*smooth_nms_topk_raw(x8, 4, 4, 32, 0.05), 8, 216)
    pk720 = peaks(*smooth_nms_topk(x720, 32, 0.05), 1, 640)
    paf1, paf8, paf720 = (nets[:1, ..., 19:], nets[..., 19:],
                          net720[None, ..., 19:])
    cases = [
        ("smooth_nms_topk_raw", "B=1 (46, 54, 18) 4x K=32",
         lambda: smooth_nms_topk_raw(x1, 4, 4, 32, 0.05), k1_cost(x1)),
        ("smooth_nms_topk_raw", "B=8 (46, 54, 144) 4x K=32",
         lambda: smooth_nms_topk_raw(x8, 4, 4, 32, 0.05), k1_cost(x8)),
        ("smooth_nms_topk", "(360, 640, 18) K=32",
         lambda: smooth_nms_topk(x720, 32, 0.05), k4_cost(x720)),
        ("smooth_nms_topk", "(115, 135, 144) K=32",
         lambda: smooth_nms_topk(x25, 32, 0.05), k4_cost(x25)),
        ("smooth_nms", "(184, 216, 19)", lambda: smooth_nms(heat_up),
         k2_cost(heat_up)),
        ("score_candidates_raw", "B=1 (46, 54) 4x K=32",
         k3(pk1, paf1, 184, 216), k3_cost(pk1, paf1, 184, 216)),
        ("score_candidates_raw", "B=8 (46, 54) 4x K=32",
         k3(pk8, paf8, 184, 216), k3_cost(pk8, paf8, 184, 216)),
        ("score_candidates_raw", "windowed (90, 160) 4x K=32",
         k3(pk720, paf720, 360, 640), k3_cost(pk720, paf720, 360, 640)),
    ]

    def events(fn, reps=30, inner=10):
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

    def device(fn, n=20, tries=5):
        """Device time of ``n`` calls; the profile is taken again (up to
        ``tries`` times) when it lost kernel records, which shows as no
        kernel or a count that is no whole multiple of ``n``."""
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            count = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
            if count and count % n == 0:
                break
        rows, all_ms, all_n = {}, 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            all_ms += us / 1e3 / n
            all_n += e.count
            if "at::native" in e.key or e.key.startswith(("Memcpy", "Memset")):
                continue
            key = e.key.replace("(anonymous namespace)::", "")
            rows[key.split("(")[0].split("::")[-1]] = us / 1e3 / n
        return sum(rows.values()), rows, all_ms, all_n / n

    out = []
    for name, what, fn, (nbytes, ops) in cases:
        med, p90 = events(fn)
        dev_ms, parts, all_ms, per_call = device(fn)
        t_b, t_f = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_FLOPS * 1e3
        row = {"label": args.label, "kernel": name, "case": what,
               "event_ms_median": med, "event_ms_p90": p90,
               "device_ms_per_launch": dev_ms, "device_parts": parts,
               "device_ms_all_kernels": all_ms,
               "cuda_kernels_per_call": per_call,
               "bound_ms": max(t_b, t_f),
               "bound_by": "bytes" if t_b >= t_f else "operations",
               "bytes": nbytes, "operations": ops, "card": smi}
        out.append(row)
        print(json.dumps(row), flush=True)

    noise = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.3, (46, 54, 18)).astype(np.float32)).to(dev)
    noise720 = torch.from_numpy(np.random.default_rng(2).normal(
        0.1, 0.3, (360, 640, 18)).astype(np.float32)).to(dev)
    plateau = torch.full((360, 640, 2), 0.5, device=dev)
    plateau[..., 1] = 0.01
    corpus = {}
    for k in (32, 128):
        for tag, x in (("b1", x1), ("b8", x8), ("noise", noise)):
            corpus[f"k1_{tag}_k{k}"] = smooth_nms_topk_raw(x, 4, 4, k, 0.05)
        corpus[f"k1_noise_k{k}_cap16"] = smooth_nms_topk_raw(
            noise, 4, 4, k, 0.05, cap=16)
        for tag, x in (("720", x720), ("25", x25), ("noise720", noise720),
                       ("plateau", plateau)):
            corpus[f"k4_{tag}_k{k}"] = smooth_nms_topk(x, k, 0.05)
        for b in (1, 8):
            pk = peaks(*smooth_nms_topk_raw(heat8(b), 4, 4, k, 0.05), b, 216)
            corpus[f"k3_b{b}_k{k}"] = score_raw(
                pk, nets[:b, ..., 19:], 184, 216, params)
        pk = peaks(*smooth_nms_topk(x720, k, 0.05), 1, 640)
        corpus[f"k3_720_k{k}"] = score_raw(
            pk, paf720, 360, 640, params)
    for shape in ((184, 216), (115, 135), (46, 54), (22, 26), (10, 12)):
        x = resize.resize_area(nets[0, ..., :19], *shape).contiguous()
        corpus[f"k2_{shape[0]}x{shape[1]}"] = (smooth_nms(x),)
    corpus["k2_plateau"] = (smooth_nms(plateau.contiguous()),)
    arrays = {}
    for key, outs in corpus.items():
        for n_out, t in enumerate(outs):
            arrays[f"{key}_{n_out}"] = t.cpu().numpy()
    if args.save:
        np.savez(args.save, **arrays)
    same = None
    if args.compare:
        ref = np.load(args.compare)
        diff = sorted(k for k in arrays
                      if not np.array_equal(arrays[k], ref[k]))
        same = not diff
        print(json.dumps({"compare": args.compare, "bit_identical": same,
                          "differ": diff}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "label": args.label, "card": smi,
                      "bit_identical": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
