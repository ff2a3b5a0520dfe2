"""Device profile of the backbone forward on the card — counterpart of
``scripts/profile_forward.py``.

For each configuration (mobilenet_thin 432x368 at B = 1 and 16, and
without ``--quick`` CMU 656x368 at B = 1 and 8; seeded random weights,
bf16 by default): the forward's median device-busy ms per call
(``utils/profiling.device_p50_ms``) and per image, its GFLOP (the
counter behind ``TfPoseEstimator.get_flops``:
``torch.utils.flop_counter``, 2 per multiply-add of every conv and
matmul, padded taps included; XLA's count in the JAX script also takes
in elementwise work and leaves out padded taps), the achieved TFLOP/s,
their share of the card's dense peak for the dtype
(:data:`PEAK_TFLOPS`), and the 15 device ops with the most time over
the traced calls (``call_event_durations_ms``).

The JAX script's ``cost_analysis_bytes_gb`` was XLA's bytes-accessed
estimate and has no counterpart here.

    tfpose-torch-profile forward [--quick] [--dtype float32]

Every number needs the card: on the CPU the timers raise.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import add_device_flag
from tfpose_tpu_torch.estimator import _DTYPES, run_backbone
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.models.layers import init_weights
from tfpose_tpu_torch.pipeline.preprocess import normalize
from tfpose_tpu_torch.utils.profiling import (
    call_event_durations_ms,
    card_name_and_power,
    device_p50_ms,
)

# dense peaks of an NVIDIA H100 SXM5 at its 700 W limit (NVIDIA's data
# sheet): bf16 on the tensor cores, fp32 outside them (the fp32 forward
# runs with TF32 off)
PEAK_TFLOPS = {"bfloat16": 989.4, "float32": 66.9}
PEAK_CARD = "NVIDIA H100 SXM5, 700 W"

CONFIGS = [("mobilenet_thin", 432, 368, 1), ("mobilenet_thin", 432, 368, 16)]
FULL_CONFIGS = CONFIGS + [("cmu", 656, 368, 1), ("cmu", 656, 368, 8)]


def seeded_network(model: str, dtype: str = "bfloat16", device="cuda"):
    """``model`` with the port's seeded random weights, in eval mode on
    ``device``."""
    net = get_network(model, _DTYPES[dtype])
    init_weights(net, torch.Generator().manual_seed(0))
    return net.eval().to(device)


def forward_flops(net, x: torch.Tensor) -> int:
    """FLOPs of one forward of ``net`` on the uint8 batch ``x``, as
    ``TfPoseEstimator.get_flops`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run_backbone(net, normalize(x))
    return int(counter.get_total_flops())


def top_ops(durations, n: int = 15):
    """The ``n`` device ops with the most total time in durations
    grouped by name (``call_event_durations_ms``): name, total ms, count
    and share of the device time; and that total."""
    ops = sorted(((sum(ds), len(ds), name) for name, ds in durations.items()),
                 reverse=True)
    total = sum(t for t, _, _ in ops)
    return [{"name": name[:90], "total_ms": round(t, 3), "n": c,
             "pct": round(t / total * 100, 1)}
            for t, c, name in ops[:n]], total


def profile_forward(model: str, w: int, h: int, batch: int,
                    dtype: str = "bfloat16", device=None,
                    n_runs: int = 30) -> dict:
    device = torch.device(device or "cuda")
    net = seeded_network(model, dtype, device)
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (batch, h, w, 3), np.uint8)).to(device)

    def fwd(x):
        return run_backbone(net, normalize(x))

    flops = forward_flops(net, img)
    with tempfile.TemporaryDirectory() as log_dir:
        p50 = device_p50_ms(fwd, (img,), n_runs=n_runs, log_dir=log_dir)
        durations, calls = call_event_durations_ms(log_dir)
        ops, total = top_ops(durations)
    tflops = flops / (p50 / 1e3) / 1e12
    return {"model": model, "batch": batch, "hw": f"{w}x{h}",
            "dtype": dtype, "device": card_name_and_power(device),
            "device_p50_ms": round(p50, 4),
            "per_image_ms": round(p50 / batch, 4),
            "gflops": round(flops / 1e9, 2),
            "achieved_tflops": round(tflops, 2),
            "tensor_peak_pct": round(tflops / PEAK_TFLOPS[dtype] * 100, 2),
            "peak": f"{PEAK_TFLOPS[dtype]} TFLOP/s {dtype}, {PEAK_CARD}",
            "top_ops": ops, "trace_total_ms": round(total, 2),
            "traced_calls": calls}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        description="the backbone forward's device profile on the card")
    parser.add_argument("--quick", action="store_true",
                        help="mobilenet_thin only (no CMU)")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(PEAK_TFLOPS))
    add_device_flag(parser)
    args = parser.parse_args(argv)
    out = []
    for model, w, h, b in CONFIGS if args.quick else FULL_CONFIGS:
        r = profile_forward(model, w, h, b, args.dtype, args.device)
        out.append(r)
        print(json.dumps(r), flush=True)
    return out
