"""The port's profiling helpers (``utils/profiling.py``) and
``TfPoseEstimator.get_flops`` on the CPU, against the JAX package's
(``tfpose_tpu/utils/profiling.py``, ``tfpose_tpu/estimator.py``).

The device timers need a card: here they must raise (no device lane);
``tests/test_torch_cuda.py`` runs them on one. ``get_flops`` counts
convolutions and matmuls (``FlopCounterMode``); JAX's figure is XLA's
cost analysis, which also counts elementwise work but leaves out the
taps of a convolution that fall in its SAME padding."""

import gzip
import json
import os
import time

import pytest
import torch
import torch.nn.functional as F

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.utils import profiling as jax_profiling
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models.layers import SameConv2d, same_pads
from tfpose_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
               for e in events)
    assert profiling.device_event_durations_ms(str(tmp_path)) == {}


def test_stage_timer_as_jax():
    """``tests/test_utils.py``'s case on both timers: the same counts,
    at least the time slept, and on the same totals the same report."""
    ours, theirs = profiling.StageTimer(), jax_profiling.StageTimer()
    for t in (ours, theirs):
        for name in ("a", "a", "b"):
            with t.section(name):
                time.sleep(0.002 if name == "a" else 0.0)
    assert ours.counts == theirs.counts == {"a": 2, "b": 1}
    assert ours.totals["a"] >= 0.004
    ours.totals = {"a": 0.004, "b": 0.0125}
    theirs.totals = dict(ours.totals)
    assert ours.report() == theirs.report()
    assert [line.split()[0] for line in ours.report().splitlines()] == \
        ["b", "a"]
    assert "x2" in ours.report().splitlines()[1]


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": ts}}


def _torch_trace(events):
    """A trace in torch.profiler's chrome format: process metadata, host
    ops and runtime calls, and the device lane's events."""
    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 1.0, "dur": 3.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "span",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 99.0},
    ] + events}


def test_device_event_durations_of_a_torch_trace(tmp_path):
    old = tmp_path / "old.pt.trace.json"
    old.write_text(json.dumps(_torch_trace([_kernel("stale", 1.0, 5.0)])))
    os.utime(old, (1, 1))
    new = tmp_path / "sub" / "host.1.2.pt.trace.json.gz"
    new.parent.mkdir()
    with gzip.open(new, "wt") as f:
        json.dump(_torch_trace([
            _kernel("smooth_nms_kernel", 10.0, 13.5),
            _kernel("smooth_nms_kernel", 40.0, 12.5),
            _kernel("cudnn::bn_fw_inf_1C11_kernel_NCHW", 60.0, 4.0),
            _kernel("Memcpy DtoH (Device -> Pinned)", 70.0, 2.0,
                    cat="gpu_memcpy"),
            _kernel("Memset (Device)", 75.0, 1.0, cat="gpu_memset"),
        ]), f)
    got = profiling.device_event_durations_ms(str(tmp_path))
    assert got == {"smooth_nms_kernel": [0.0135, 0.0125],
                   "cudnn::bn_fw_inf_1C11_kernel_NCHW": [0.004],
                   "Memcpy DtoH (Device -> Pinned)": [0.002],
                   "Memset (Device)": [0.001]}
    assert profiling.device_event_durations_ms(str(tmp_path), "cudnn") == {
        "cudnn::bn_fw_inf_1C11_kernel_NCHW": [0.004]}
    with pytest.raises(FileNotFoundError):
        profiling.device_event_durations_ms(str(tmp_path / "none"))


def test_call_busy_time_of_a_torch_trace():
    """Each ``device_p50_ms#i`` range's device-busy time, the union of
    its device events' intervals (overlapping streams count once), from
    a hand-written trace. A device event belongs to the range of the
    runtime call with its correlation id: the device's timestamps here
    lie 1 s after the host's, as after minutes of drift, and a range
    whose launches have no device record is left out."""
    ranges = [{"ph": "X", "cat": "user_annotation",
               "name": f"device_p50_ms#{i}", "pid": 1, "tid": 1,
               "ts": 100.0 * i, "dur": 90.0} for i in range(4)]
    starts = [5.0, 30.0, 105.0, 108.0, 220.0, 230.0, 240.0]
    dev = [_kernel("a", 5.0, 10.0), _kernel("b", 30.0, 20.0),
           _kernel("a", 105.0, 10.0), _kernel("e", 108.0, 12.0),
           _kernel("c", 220.0, 4.0), _kernel("d", 230.0, 40.0),
           _kernel("f", 240.0, 5.0)]
    launches = [{"ph": "X", "cat": "cuda_runtime",
                 "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                 "ts": ts - 1.0, "dur": 1.0, "args": {"correlation": ts}}
                for ts in starts + [310.0]]
    for e in dev:
        e["ts"] += 1e6
    events = _torch_trace(ranges + launches + dev)["traceEvents"]
    busy = profiling._call_busy_ms(events)
    assert busy == pytest.approx([0.030, 0.015, 0.044])
    assert [[e["name"] for e in d] for d in
            profiling.call_device_events(events)] == [
        ["a", "b"], ["a", "e"], ["c", "d", "f"], []]


def test_call_event_durations_leave_out_the_warm_up(tmp_path):
    """``call_event_durations_ms``: the durations by name of the traced
    calls' device events only (``device_p50_ms``'s warm-up calls run
    before its ranges), and how many calls the trace holds events of."""
    ranges = [{"ph": "X", "cat": "user_annotation",
               "name": f"device_p50_ms#{i}", "pid": 1, "tid": 1,
               "ts": 1000.0 + 100.0 * i, "dur": 90.0} for i in range(3)]
    launch_ts = [10.0, 20.0, 1010.0, 1020.0, 1110.0]
    launches = [{"ph": "X", "cat": "cuda_runtime",
                 "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                 "ts": ts, "dur": 1.0, "args": {"correlation": ts}}
                for ts in launch_ts]
    dev = [_kernel("warm", 10.0, 50.0), _kernel("warm", 20.0, 50.0),
           _kernel("a", 1010.0, 4.0), _kernel("b", 1020.0, 2.0),
           _kernel("a", 1110.0, 6.0)]
    (tmp_path / "h.1.2.pt.trace.json").write_text(
        json.dumps(_torch_trace(ranges + launches + dev)))
    durs, calls = profiling.call_event_durations_ms(str(tmp_path))
    assert durs == {"a": [0.004, 0.006], "b": [0.002]}
    assert calls == 2


def test_device_timers_raise_without_a_card():
    x = torch.ones(8, 3)
    with pytest.raises(ValueError, match="no device lane"):
        profiling.device_p50_ms(lambda t: t + 1, (x,))
    with pytest.raises(ValueError, match="no device lane"):
        profiling.amortized_ms(lambda t: t.sum(), x)
    with pytest.raises(NotImplementedError, match="dynolog"):
        profiling.start_server(9999)


# ---------------------------------------------------------------------------
# get_flops
# ---------------------------------------------------------------------------

def _conv_flops(net, h, w):
    """2 x multiply-adds of every conv of ``net`` at an (h, w) input,
    from each conv's weight and output shape (``full``), and counting
    only the taps inside the input, not in SAME padding (``inside``)."""
    full, inside = [0], [0]

    def hook(mod, inputs, out):
        x = inputs[0]
        cout, cin_g, kh, kw = mod.weight.shape
        full[0] += 2 * out.shape[0] * cout * out.shape[2] * out.shape[3] \
            * cin_g * kh * kw
        t, b = same_pads(x.shape[-2], kh, mod.stride[0])
        lft, r = same_pads(x.shape[-1], kw, mod.stride[1])
        ones = F.pad(torch.ones(1, 1, *x.shape[-2:]), (lft, r, t, b))
        taps = F.conv2d(ones, torch.ones(1, 1, kh, kw), stride=mod.stride)
        inside[0] += 2 * out.shape[0] * cout * cin_g * int(taps.sum())

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, SameConv2d)]
    with torch.no_grad():
        net(torch.zeros(1, h, w, 3))
    for handle in hooks:
        handle.remove()
    return full[0], inside[0]


# port / JAX figure at 64x48 (JAX's from XLA:CPU's cost analysis):
# thin 0.6048, v2small 0.2922, CMU 1.4477. JAX counts the
# elementwise work (more for the mobilenets' many small layers) and
# leaves out padded taps (most of CMU's 7x7 taps at its 8x6 grid).
_RATIO = {"mobilenet_thin": (0.55, 0.65), "mobilenet_v2_small": (0.25, 0.35),
          "cmu": (1.40, 1.50)}


@pytest.mark.parametrize("name", sorted(_RATIO))
def test_get_flops_is_the_conv_count(name):
    """The figure equals 2 x the multiply-adds of every conv (the
    decode at 4x adds none); XLA's figure is at least the count of the
    taps inside the input, and the ratio of the two is as measured."""
    w, h = 64, 48
    est = TfPoseEstimator(name, target_size=(w, h), device="cpu",
                          params_path="")
    flops = est.get_flops()
    full, inside = _conv_flops(est.net, h, w)
    assert flops == full
    jax_flops = JaxEstimator(name, target_size=(w, h),
                             params_path="").get_flops()
    assert inside <= jax_flops
    lo, hi = _RATIO[name]
    assert lo <= flops / jax_flops <= hi
