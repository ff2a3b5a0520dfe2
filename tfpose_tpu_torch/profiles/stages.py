"""Stage-level profile of the decode on the card — counterpart of
``scripts/profile_stages.py``.

The headline setting: mobilenet_thin at 432x368, so a 46x54 stride-8
grid decoded at 4x (184x216), ``DecodeParams()``, and network outputs
drawn from N(0, 0.3) (numpy seed 0). Five cumulative stages, each a
function of one (B, 46, 54, 57) output that returns the tensors that its
last step made (the timed loop carries their sum, :func:`total`, as
JAX's stages return it):

* ``resize_heat``: the area upsample of the 19 heat channels;
* ``+smooth_nms_topk``: then K4 (``smooth_nms_topk``) on the 18 part
  planes, blur, NMS, threshold and top-K at 184x216;
* ``+paf_sampling``: then K3 (``score_candidates_raw``) scores every
  limb candidate on the raw PAF;
* ``+greedy``: then ``greedy_connections``;
* ``full_decode``: ``decode_batch`` (K1 on the raw grid, K3, greedy,
  assembly).

Per stage: its cumulative ms per image by ``amortized_ms`` (CUDA events
over ``scans`` distinct outputs, the slope between N and N // 4 calls)
and the delta to the stage before, as the JAX script prints; and from
the ``torch.profiler`` trace that ``device_p50_ms`` takes of the stage,
call by call: the device-busy ms per image, the CUDA kernels per call
and the host-device syncs per call. Wall minus busy is the host's share
of each stage.

    tfpose-torch-profile stages [--batch 1] [--json]

Every number needs the card: on the CPU the timers raise.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import add_device_flag
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import NUM_HEATMAP_CH, NUM_PARTS
from tfpose_tpu_torch.ops import paf, resize
from tfpose_tpu_torch.ops.decode import decode_batch
from tfpose_tpu_torch.ops.kernels.paf_score import score_candidates_raw
from tfpose_tpu_torch.ops.kernels.smooth_nms import smooth_nms_topk
from tfpose_tpu_torch.ops.nms import Peaks
from tfpose_tpu_torch.utils.profiling import (
    amortized_ms,
    call_device_events,
    call_ranges,
    card_name_and_power,
    device_p50_ms,
)

# thin 432x368: the stride-8 grid and its 4x decode size
H8, W8 = 368 // 8, 432 // 8
UP_H, UP_W = H8 * 4, W8 * 4
CONFIG = "thin 432x368 up4x"
# host-device syncs in a trace: the runtime calls that wait for the card
# (``cudaDeviceSynchronize`` ends each traced call, so it is not one of
# the stage's) and the copies to the host that block
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize")
BLOCKING_COPIES = ("cudaMemcpy", "cudaMemcpy2D")


def net_outputs(batch: int, scans: int, device="cpu") -> torch.Tensor:
    """(scans, batch, 46, 54, 57) fp32 from N(0, 0.3), numpy seed 0."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.3, (scans, batch, H8, W8, 57)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def total(out) -> torch.Tensor:
    """The scalar a stage's tensors give the timed loop: their sums,
    added (the sum forces every tensor)."""
    out = out if isinstance(out, tuple) else (out,)
    return sum(t.sum() for t in out)


def stages(params: DecodeParams = DecodeParams()
           ) -> List[Tuple[str, Callable[[torch.Tensor], tuple]]]:
    """The five cumulative stages, each (B, 46, 54, 57) -> the tensors
    its last step made: the upsampled heat; the top-K scores and flat
    indices; the candidates' scores; the connections' scores; the
    humans' scores."""
    def heat_up(t):
        return resize.resize_area(t[..., :NUM_HEATMAP_CH], UP_H, UP_W)

    def topk(t):
        # the B * 18 part planes in one call, channel-first (b * 18 + p)
        planes = heat_up(t)[..., :NUM_PARTS].permute(0, 3, 1, 2)
        return smooth_nms_topk(
            planes.reshape(-1, UP_H, UP_W).permute(1, 2, 0),
            params.max_peaks, params.thresh_heat, params.smooth_kernel_size,
            params.smooth_sigma)

    def candidates(t):
        s, i = topk(t)
        s = s.reshape(t.shape[0], NUM_PARTS, -1)
        i = i.reshape(t.shape[0], NUM_PARTS, -1).clamp(min=0)
        pk = Peaks(x=i % UP_W, y=i // UP_W, score=s,
                   valid=s > params.thresh_heat)
        return score_candidates_raw(pk, t[..., NUM_HEATMAP_CH:], UP_H,
                                    UP_W, params, prefix_valid=False)

    return [
        ("resize_heat", heat_up),
        ("+smooth_nms_topk", lambda t: tuple(topk(t))),
        ("+paf_sampling", lambda t: candidates(t).score),
        ("+greedy", lambda t: paf.greedy_connections(
            candidates(t), params).score),
        ("full_decode", lambda t: decode_batch(
            t, UP_H, UP_W, params).human_scores),
    ]


def call_counts(events: List[dict]) -> List[Dict[str, int]]:
    """Per traced call of ``device_p50_ms`` (its ``device_p50_ms#i``
    ranges, which end after a synchronisation): the CUDA kernels that
    ran (``call_device_events``: device events of category ``kernel``
    launched in the range) and the host-device syncs (runtime calls in
    the range that wait for the card: :data:`SYNC_CALLS`, and a
    blocking copy to the host)."""
    dtoh = {e["args"]["correlation"] for e in events
            if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")
            and "correlation" in e.get("args", {})}
    out = []
    for (lo, hi), dev in zip(call_ranges(events),
                             call_device_events(events)):
        syncs = sum(
            1 for e in events if e.get("cat") == "cuda_runtime"
            and lo <= e["ts"] <= hi
            and (e["name"] in SYNC_CALLS
                 or (e["name"] in BLOCKING_COPIES
                     and e.get("args", {}).get("correlation") in dtoh)))
        kernels = sum(1 for e in dev if e.get("cat") == "kernel")
        out.append({"kernels": kernels, "syncs": syncs})
    return out


def _median(counts: List[Dict[str, int]], key: str) -> float:
    """The median of ``key`` over the calls whose device events the
    trace holds (CUPTI now and then loses a call's records)."""
    return float(np.median([c[key] for c in counts if c["kernels"]]))


def profile_stages(batch: int = 1, n_trace: int = 10, device=None) -> dict:
    """The five stages at ``batch`` on the card (``scans`` = 32 at B=1,
    else 8, as in JAX): per stage its cumulative ms per image, the delta,
    the device-busy ms per image and the median kernels and syncs per
    call over ``n_trace`` traced calls."""
    device = torch.device(device or "cuda")
    scans = 32 if batch == 1 else 8
    xs = net_outputs(batch, scans, device)
    rows, prev = [], 0.0
    for name, stage in stages():
        def fn(t):
            return total(stage(t))

        ms = amortized_ms(fn, xs) / batch
        with tempfile.TemporaryDirectory() as log_dir:
            busy = device_p50_ms(fn, (xs[0],), n_runs=n_trace,
                                 log_dir=log_dir)
            paths = [p for p in os.listdir(log_dir)
                     if p.endswith(".pt.trace.json")]
            with open(os.path.join(log_dir, paths[0])) as f:
                counts = call_counts(json.load(f)["traceEvents"])
        rows.append({"stage": name, "ms_per_img": ms,
                     "delta_ms": ms - prev,
                     "busy_ms_per_img": busy / batch,
                     "kernels_per_call": _median(counts, "kernels"),
                     "syncs_per_call": _median(counts, "syncs")})
        prev = ms
    return {"batch": batch, "config": CONFIG, "scans": scans,
            "device": card_name_and_power(device), "stages": rows}


def report(doc: dict) -> str:
    """The JAX script's lines (cumulative | delta ms per image) and the
    trace's columns."""
    lines = [f"batch={doc['batch']} {doc['config']}  (cumulative | delta) "
             f"per img | busy per img, kernels, syncs per call "
             f"[{doc['device']}]"]
    for r in doc["stages"]:
        lines.append(
            f"  {r['stage']:18s} {r['ms_per_img']:7.3f} ms | "
            f"+{r['delta_ms']:6.3f} ms | busy {r['busy_ms_per_img']:7.4f} ms"
            f", {r['kernels_per_call']:.0f} kernels, "
            f"{r['syncs_per_call']:.0f} syncs")
    return "\n".join(lines)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="decode stages on the card (thin 432x368, 4x)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--json", action="store_true",
                        help="print the stages as one JSON object")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    doc = profile_stages(args.batch, device=args.device)
    print(json.dumps(doc) if args.json else report(doc), flush=True)
    return doc
