"""Per-op device table of a backbone forward on the card — counterpart
of ``scripts/profile_cmu_ops.py``.

``--runs`` bf16 forwards (seeded random weights, CMU at 656x368 B=8 by
default) are traced by ``utils/profiling.device_p50_ms`` (one call
between synchronisations at a time; a trace that holds the records of
fewer than half the calls is taken again), whose median device-busy ms
per forward the table carries. Every device event of the traced calls
(CUDA kernels, copies, memsets; ``call_event_durations_ms``, without
the warm-up) is summed by name, per call whose records the trace holds,
and grouped into buckets by the kernel's name alone (:func:`bucket`):
``conv``, ``data-movement``, ``fusion`` (elementwise work and
BatchNorm), ``matmul`` and ``other``. The JAX script's ``program_ms``
(XLA's whole-program events) has no counterpart: PyTorch launches op by
op.

    tfpose-torch-profile ops [--model cmu] [--batch 8] [--runs 8] [--json]

Every number needs the card: on the CPU the forward is refused.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Dict, List

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import add_device_flag
from tfpose_tpu_torch.estimator import run_backbone
from tfpose_tpu_torch.pipeline.preprocess import normalize
from tfpose_tpu_torch.profiles.forward import seeded_network
from tfpose_tpu_torch.utils.profiling import (
    call_event_durations_ms,
    card_name_and_power,
    device_p50_ms,
)

# substrings of kernel names, lower case, tried in this order: JAX's
# rules on XLA's op names, then cuDNN's and CUTLASS's convolution
# kernels (implicit GEMM, FFT, Winograd, xmma, Hopper's sm90_*), the
# copies and cuDNN's layout and padding kernels, PyTorch's elementwise
# and BatchNorm kernels, and the GEMMs (cuBLAS's nvjet_* on Hopper)
_BUCKETS = (
    ("conv", ("convolution", "conv", "implicit_gemm", "implicit_convolve",
              "fft", "winograd", "xmma", "sm90_", "fprop")),
    ("data-movement", ("memcpy", "memset", "copy", "im2col", "transpose",
                       "reshape", "nchwtonhwc", "nhwctonchw", "padding")),
    ("fusion", ("fusion", "elementwise", "batch_norm", "batchnorm", "bn_fw",
                "bn_bw")),
    ("matmul", ("dot", "gemm", "matmul", "nvjet")),
)


def bucket(name: str) -> str:
    """The bucket of one device op, from its kernel name alone."""
    low = name.lower().replace("convert", "")
    for label, keys in _BUCKETS:
        if any(k in low for k in keys):
            return label
    return "other"


def op_table(durations: Dict[str, List[float]], runs: int,
             top: int = 40) -> dict:
    """Device durations by name (``call_event_durations_ms``) of ``runs``
    forwards -> the device ms per forward of every op and bucket, the
    ops sorted by time (the first ``top`` kept)."""
    rows = sorted(((name, sum(ds) / runs, len(ds), bucket(name))
                   for name, ds in durations.items()), key=lambda r: -r[1])
    buckets: Dict[str, float] = {}
    for _, ms, _, bk in rows:
        buckets[bk] = buckets.get(bk, 0.0) + ms
    return {"op_total_ms": sum(ms for _, ms, _, _ in rows),
            "buckets_ms": dict(sorted(buckets.items(),
                                      key=lambda kv: -kv[1])),
            "ops": [{"name": name, "ms": ms, "count": n, "bucket": bk}
                    for name, ms, n, bk in rows[:top]]}


def profile_ops(model: str = "cmu", w: int = 656, h: int = 368,
                batch: int = 8, runs: int = 8, top: int = 40,
                device=None) -> dict:
    device = torch.device(device or "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ValueError("the per-op table needs a CUDA card: a CPU run "
                         "has no device lane")
    net = seeded_network(model, "bfloat16", device)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, h, w, 3), np.uint8)).to(device)
    with tempfile.TemporaryDirectory() as log_dir:
        p50 = device_p50_ms(lambda t: run_backbone(net, normalize(t)), (x,),
                            n_runs=runs, log_dir=log_dir)
        durations, calls = call_event_durations_ms(log_dir)
    return {"model": model, "batch": batch, "hw": f"{w}x{h}",
            "dtype": "bfloat16", "runs": runs, "traced_calls": calls,
            "device": card_name_and_power(device), "device_p50_ms": p50,
            **op_table(durations, calls, top)}


def report(doc: dict) -> str:
    total = doc["op_total_ms"]
    lines = [f"== {doc['model']} {doc['hw']} b={doc['batch']}: device time "
             f"per forward [{doc['device']}] ==",
             f"op-event total: {total:.3f} ms (device-busy p50 "
             f"{doc['device_p50_ms']:.3f} ms)", "", "-- buckets --"]
    for bk, ms in doc["buckets_ms"].items():
        lines.append(f"{bk:15s} {ms:9.3f} ms  {ms / total * 100:5.1f}%")
    lines += ["", f"-- top {len(doc['ops'])} ops --"]
    for op in doc["ops"]:
        lines.append(f"{op['ms']:8.3f} ms {op['ms'] / total * 100:5.1f}%  "
                     f"x{op['count']:<4d} [{op['bucket']}] {op['name']}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="per-op device table of a bf16 forward on the card")
    p.add_argument("--model", default="cmu")
    p.add_argument("--width", type=int, default=656)
    p.add_argument("--height", type=int, default=368)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--json", action="store_true",
                   help="print the full table as JSON instead of text")
    add_device_flag(p)
    args = p.parse_args(argv)
    doc = profile_ops(args.model, args.width, args.height, args.batch,
                      args.runs, args.top, args.device)
    print(json.dumps(doc) if args.json else report(doc), flush=True)
    return doc
