"""The benchmark's frozen work counts against the program's FLOP counter
and the kernel bounds of PERF.md (section 6, NVIDIA H100 at 3.35 TB/s
and 67 TFLOP/s fp32)."""

import numpy as np
import pytest
import torch

from posebench.lib import counts
from posebench.reference.decode import PAIRS
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.ops.kernels.paf_score import candidate_geometry
from tfpose_tpu_torch.ops.kernels.smooth_nms import _phase_tables
from tfpose_tpu_torch.ops.nms import Peaks
from tfpose_tpu_torch.core.config import DecodeParams


@pytest.mark.parametrize("model,wh,gflop", [
    ("mobilenet_thin", (432, 368), 10.83), ("cmu", (656, 368), 484.63)])
def test_model_flops_pinned(model, wh, gflop):
    assert round(counts.model_flops(model, wh[1], wh[0]) / 1e9, 2) == gflop


@pytest.mark.parametrize("model,wh", [
    ("mobilenet_thin", (432, 368)), ("mobilenet_thin", (160, 96)),
    ("cmu", (656, 368))])
def test_model_flops_equal_get_flops(model, wh):
    est = TfPoseEstimator(model, target_size=wh, device="cpu",
                          params_path="/nonexistent")
    assert counts.model_flops(model, wh[1], wh[0]) == est.get_flops()


def test_k1_phase_taps_are_the_programs():
    wv, _, wh, _, _ = _phase_tables(4, 4, 25, 3.0, "cpu")
    assert wv.shape[1] == wh.shape[1] == counts.K1_PHASE_TAPS[(4, 25)]


@pytest.mark.parametrize("planes,h8,w8,ms", [
    (18, 46, 54, 0.000276), (144, 46, 54, 0.00221), (288, 46, 82, 0.00668),
    (144, 46, 46, 0.00189)])
def test_k1_bounds_pinned(planes, h8, w8, ms):
    bound = counts.bound_s(*counts.k1_work(planes, h8, w8), 67e12)
    assert round(bound * 1e3, 6 if ms < 1e-3 else 5) == ms


@pytest.mark.parametrize("hw,ms", [((184, 216), 0.00180),
                                   ((184, 328), 0.00274),
                                   ((184, 184), 0.00154)])
def test_k2_bounds_pinned(hw, ms):
    ops, nbytes = counts.k2_work(*hw)
    assert nbytes == 2 * hw[0] * hw[1] * 19 * 4
    assert round(counts.bound_s(ops, nbytes, 67e12) * 1e3, 5) == ms


def test_k3_counts_slots_and_sampled_cells():
    k = 32
    peaks = np.zeros((18, k, 2), np.int64)
    valid = np.zeros((18, k), bool)
    ops, nbytes = counts.k3_work(peaks, valid, 46, 54, 184, 216, PAIRS)
    assert nbytes == 18 * k * 9 + 19 * k * k * 5 and ops == 16 * 19 * k * k
    # one live candidate: neck (1) at (10, 10) to right shoulder (2) at
    # (50, 10); its 10 samples at x = 10, 14, ..., 46 lie in raw cells
    # x // 4 = 2..11 of row 2
    peaks[1, 0], peaks[2, 0] = (10, 10), (50, 10)
    valid[1, 0] = valid[2, 0] = True
    ops1, nbytes1 = counts.k3_work(peaks, valid, 46, 54, 184, 216, PAIRS)
    assert nbytes1 - nbytes == 10 * 8 and ops1 - ops == 131


def test_k3_samples_are_the_programs_geometry():
    rng = np.random.default_rng(0)
    k = 8
    x = rng.integers(0, 216, (1, 18, k))
    y = rng.integers(0, 184, (1, 18, k))
    valid = rng.uniform(size=(1, 18, k)) < 0.5
    pk = Peaks(x=torch.as_tensor(x), y=torch.as_tensor(y),
               score=torch.ones(1, 18, k), valid=torch.as_tensor(valid))
    *_, av, bv, iy, ix = candidate_geometry(pk, 184, 216, DecodeParams())
    live = (av[..., :, None] & bv[..., None, :])[0]
    cells = {(pid, int(cy) // 4, int(cx) // 4)
             for pid in range(19) for a in range(k) for b in range(k)
             if live[pid, a, b]
             for cy, cx in zip(iy[0, pid, a, b], ix[0, pid, a, b])}
    peaks = np.stack([x[0], y[0]], -1)
    _, nbytes = counts.k3_work(peaks, valid[0], 46, 54, 184, 216, PAIRS)
    assert nbytes == len(cells) * 8 + 18 * k * 9 + 19 * k * k * 5


@pytest.mark.parametrize("chips,batch", [(1, 1), (1, 16), (4, 64)])
def test_mfu_leaves_out_the_traced_calls(chips, batch):
    """``mfu_pct``: the frozen FLOPs of the untraced calls' images over
    those calls' host time, of the cards' peak; the calls the profiler
    slowed (the first WARM_CALLS + trace_calls) count for nothing."""
    from types import SimpleNamespace

    from posebench.lib.trace import WARM_CALLS
    from posebench.metrics import _common

    cell = SimpleNamespace(
        config={"model": "mobilenet_thin", "dtype": "float32"},
        workload={"trace_calls": 3, "chips": chips}, h=368, w=432,
        batch=batch)
    traced = WARM_CALLS + 3
    lat = [9.0] * traced + [0.02, 0.04, 0.03]
    ctx = {"cell": cell, "trace": {"calls": 3},
           "outcome": {"latencies_s": lat}}
    want = 100 * 10.83e9 * batch * 3 / 0.09 / (67e12 * chips)
    assert _common.mfu_pct(ctx) == pytest.approx(want, rel=1e-3)
    assert _common.mfu_pct({**ctx, "trace": None}) is None
    ctx["outcome"] = {"latencies_s": lat[:traced]}
    assert _common.mfu_pct(ctx) is None
    cell.config["peak"] = "bfloat16"
    ctx["outcome"] = {"latencies_s": lat}
    assert _common.mfu_pct(ctx) == pytest.approx(want * 67 / 989, rel=1e-3)
