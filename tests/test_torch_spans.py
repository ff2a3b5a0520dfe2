"""The port's spans (``utils/profiling.py:span``) on the CPU: a no-op
without a profiler, ``record_function`` ranges under one, at the layer
boundaries of ``inference``, ``inference_batch``,
``BatchedEvaluator.run_batch`` and the mesh's gather, each nested in its
call's root span, and the humans the same either way; and the profile
that reads them (``profiles/spans.py``): the device's idle time put down
to the innermost span by exact overlaps."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
from tfpose_tpu_torch.parallel import mesh as mesh_mod
from tfpose_tpu_torch.profiles import main as profile_main
from tfpose_tpu_torch.profiles import spans as spans_profile
from tfpose_tpu_torch.utils import synthetic
from tfpose_tpu_torch.utils.profiling import span

_THIN160 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin160_coco", "params.msgpack")
DECODE = ("decode.peaks", "decode.candidates", "decode.greedy",
          "decode.assemble")
# entry -> (root span, the spans of one call below it, with their counts)
ENTRIES = {
    "inference": ("api.inference", {
        "model.upload": 1, "model.forward": 1, "decode.peaks": 2,
        "decode.candidates": 1, "decode.greedy": 1, "decode.assemble": 1,
        "api.fetch": 1, "api.maps": 1, "api.humans": 1}),
    "inference_batch": ("api.inference_batch", {
        "model.upload": 1, "model.forward": 1, **dict.fromkeys(DECODE, 1),
        "api.fetch": 1, "api.humans": 1}),
    "run_batch": ("api.run_batch", {
        "model.upload": 1, "model.forward": 1, **dict.fromkeys(DECODE, 1),
        "api.fetch": 1, "api.humans": 1}),
}


def _scenes(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(2, 4)), 160, 160, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, 160, 160, rng))
    return out


@pytest.fixture(scope="module")
def est():
    return TfPoseEstimator("mobilenet_thin", target_size=(160, 160),
                           params_path=_THIN160, device="cpu")


@pytest.fixture(scope="module")
def evaluator():
    ev = BatchedEvaluator("mobilenet_thin", (160, 160), batch_size=2,
                          dtype="float32", device="cpu")
    ev.load_params(_THIN160)
    return ev


def _call(entry, est, evaluator, imgs):
    if entry == "inference":
        return [est.inference(imgs[0], upsample_size=4.0)]
    if entry == "inference_batch":
        return est.inference_batch(imgs, upsample_size=4.0)
    return evaluator.run_batch(np.stack(imgs))


def _traced(fn, tmp_path):
    """``fn()`` under a CPU profiler: its result and the trace's span
    events (start, end, name), in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    return out, spans


def _humans_key(humans):
    return [[(h.score, sorted((p, b.x, b.y, b.score)
                              for p, b in h.body_parts.items()))
             for h in per_image] for per_image in humans]


def test_span_without_a_profiler_enters_no_record_function(
        monkeypatch, est):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with span("api.test"):
        pass
    assert est.inference(_scenes(1)[0], upsample_size=4.0)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_call_opens_the_layer_spans_under_its_root(entry, est, evaluator,
                                                   tmp_path):
    root, below = ENTRIES[entry]
    imgs = _scenes(2)
    _call(entry, est, evaluator, imgs)   # warm-up outside the trace
    humans, spans = _traced(lambda: _call(entry, est, evaluator, imgs),
                            tmp_path)
    assert sum(len(h) for h in humans) >= 2
    roots = [s for s in spans if s[2] == root]
    assert len(roots) == 1
    r0, r1, _ = roots[0]
    counts = {}
    for t0, t1, name in spans:
        if name != root:
            assert r0 <= t0 and t1 <= r1, name
            counts[name] = counts.get(name, 0) + 1
    assert counts == below


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_humans_equal_with_and_without_the_profiler(entry, est, evaluator,
                                                    tmp_path):
    imgs = _scenes(2, seed=9)
    off = _call(entry, est, evaluator, imgs)
    on, spans = _traced(lambda: _call(entry, est, evaluator, imgs),
                        tmp_path)
    assert spans and _humans_key(on) == _humans_key(off)
    if entry == "inference":
        heat, paf = est.heatMat, est.pafMat
        _call(entry, est, evaluator, imgs)
        np.testing.assert_array_equal(est.heatMat, heat)
        np.testing.assert_array_equal(est.pafMat, paf)


def test_escalation_opens_one_escalate_span(tmp_path):
    """``max_peaks`` 1 saturates on scenes of two or more people: the
    decode runs again at the escalated K, inside one ``decode.escalate``
    (with its own decode spans) under ``api.fetch``."""
    small = TfPoseEstimator(
        "mobilenet_thin", target_size=(160, 160), params_path=_THIN160,
        device="cpu", decode_params=DecodeParams(
            max_peaks=1, escalate_on_saturation=True))
    img = _scenes(1)[0]
    small.inference(img, upsample_size=4.0)
    _, spans = _traced(lambda: small.inference(img, upsample_size=4.0),
                       tmp_path)
    names = [n for _, _, n in spans]
    assert names.count("decode.escalate") == 1
    # the arrays fetched are the escalated decode's, under its cap
    assert not small.last_peak_saturated.any()
    (e0, e1, _), = [s for s in spans if s[2] == "decode.escalate"]
    (f0, f1, _), = [s for s in spans if s[2] == "api.fetch"]
    assert f0 <= e0 and e1 <= f1
    inner = [n for t0, t1, n in spans if e0 < t0 and t1 <= e1]
    assert sorted(inner) == sorted(DECODE)
    assert names.count("decode.greedy") == 2


def _gather_rank():
    """One gloo rank: gather a (2, 3) block of each rank under a CPU
    profiler; the span names it saw and the gathered tensor."""
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    bounds = [2 * i for i in range(n + 1)]
    local = torch.full((2, 3), float(r))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = mesh_mod.gather_blocks(local, bounds, r, dist.group.WORLD)
        flags = mesh_mod.gather_blocks(local > 0, bounds, r,
                                       dist.group.WORLD)
    names = [e.name for e in prof.events() if e.name.startswith("mesh.")]
    return names, out.numpy(), flags.numpy()


def test_mesh_gather_opens_one_span_per_gather():
    outs = mesh_mod.launch(_gather_rank, 2, ["cpu", "cpu"], "gloo",
                           timeout=120.0)
    want = np.repeat(np.arange(2.0), 2)[:, None] * np.ones((1, 3))
    for names, out, flags in outs:
        assert names == ["mesh.gather", "mesh.gather"]
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(flags, want > 0)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _kernel(name, ts, dur, corr):
    return {**_x("kernel", name, ts, dur, correlation=corr), "pid": 0,
            "tid": 7}


def _synthetic_trace():
    """Calls 2 and 3 of a window [0, 2000] us. Call 2: api.inference
    [10, 990] around model.forward [20, 300], decode.greedy [400, 700]
    and api.fetch [700, 900] (sharing greedy's end); call 3:
    api.inference [1110, 1990] around decode.greedy [1200, 1800]. Four
    device events of the calls, one launched outside them."""
    def launch(ts, corr):
        return _x("cuda_runtime", "cudaLaunchKernel", ts, 5,
                  correlation=corr)

    events = [
        _x("user_annotation", "spans#2", 0, 1000),
        _x("user_annotation", "spans#3", 1100, 900),
        _x("cpu_op", "aten::conv2d", 25, 270),
        launch(30, 1), _kernel("conv", 100, 100, 1),
        launch(450, 2), _kernel("greedy_round", 500, 100, 2),
        _x("cuda_runtime", "cudaMemcpy", 712, 90, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 750, 50, correlation=3),
        launch(1210, 4), _kernel("greedy_round", 1300, 100, 4),
        launch(1040, 5), _kernel("warm", 1050, 10, 5),
    ]
    for k, (name, ts, dur) in enumerate([
            ("api.inference", 10, 980), ("model.forward", 20, 280),
            ("decode.greedy", 400, 300), ("api.fetch", 700, 200),
            ("api.inference", 1110, 880), ("decode.greedy", 1200, 600)]):
        events.append(_x("user_annotation", name, ts, dur))
        # the device lane's mirror of a range that holds device work
        events.append({"ph": "X", "cat": "gpu_user_annotation",
                       "name": name, "ts": ts + 60, "dur": dur,
                       "pid": 0, "tid": 7, "args": {"External id": k}})
    return events


def test_idle_goes_to_the_innermost_span_by_exact_overlap():
    doc = spans_profile.idle_by_span(_synthetic_trace())
    assert doc["calls"] == 2
    assert doc["window_s"] * 1e6 == pytest.approx(2000)
    assert doc["busy_s"] * 1e6 == pytest.approx(350)
    # gaps [0,100] [200,500] [600,750] [800,1300] [1400,2000]
    assert {n: s * 1e6 for n, s in doc["idle_s"].items()} == pytest.approx({
        spans_profile.NONE: 10 + 120 + 10,
        "api.inference": 10 + 100 + 90 + 90 + 190,
        "model.forward": 80 + 100, "decode.greedy": 100 + 100 + 100 + 400,
        "api.fetch": 50 + 100})
    assert doc["count"] == {"api.inference": 2, "model.forward": 1,
                            "decode.greedy": 2, "api.fetch": 1}
    # by the span the launching runtime call lay in; "warm" was launched
    # outside the ranges
    assert {n: s * 1e6 for n, s in doc["device_s"].items()} == pytest.approx(
        {"model.forward": 100, "decode.greedy": 200, "api.fetch": 50})


def test_layer_shares_add_up_to_the_device_idle_share():
    shares = spans_profile.layer_shares(
        spans_profile.idle_by_span(_synthetic_trace()))
    assert shares == pytest.approx({
        "model": 9.0, "decode": 35.0, "api": 31.5, "mesh": 0.0,
        spans_profile.NONE: 7.0, "device_idle": 82.5})
    assert sum(v for k, v in shares.items() if k != "device_idle") == \
        pytest.approx(shares["device_idle"])


def test_recorded_calls_count_their_spans_and_split_the_window(est):
    """Three ``inference`` calls recorded on the CPU: each range holds
    the table's spans once a call (``decode.peaks`` twice), and the
    split covers the window, which holds no device event here."""
    imgs = _scenes(2)
    doc = spans_profile.idle_by_span(spans_profile.record(
        lambda i: est.inference(imgs[i % 2], upsample_size=4.0), 3))
    root, below = ENTRIES["inference"]
    assert doc["calls"] == 3 and doc["busy_s"] == 0
    assert doc["count"] == {root: 3, **{n: 3 * c for n, c in below.items()}}
    assert sum(doc["idle_s"].values()) == pytest.approx(doc["window_s"])


def test_the_spans_profile_needs_the_card():
    with pytest.raises(ValueError, match="CUDA card"):
        profile_main(["spans", "--device", "cpu", "--calls", "1"])
