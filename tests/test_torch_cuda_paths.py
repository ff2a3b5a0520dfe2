"""The port's paths on the card against the same paths on the CPU, each
with its kernels' launches counted: the estimator's entry points with
``thin368_coco``, the v2 backbones, CMU and BODY_25 on seeded weights,
serving, bf16, the trainer, conversion, the mesh's ranks sharing the
card, the parity sweep and the tools.

Marked ``cuda``: without a card they skip (decided inside the fixture,
``torch_cases.card``).
On the card they run with the other card tests (README.md, "PyTorch / CUDA
port"); the card machine has no jax, cv2 or tensorboard.
"""

import os

import numpy as np
import pytest
import torch

import torch_cases
from torch_cases import (
    CHECKPOINT,
    V2_CHECKPOINTS,
    counted,
    evaluate_on,
    heat8_of,
    humans_key,
    humans_of,
    k1_phase_reference,
    k2_compare,
    k3_compare,
    peaks_of,
    rank_gloo2,
    rank_nccl,
    rank_train,
    render_frames,
    rendered_coco,
    same_human_lists,
    same_humans,
    same_persons,
    scene_nets,
    state_diff,
    train_steps,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.evaluation.coco_eval import synthetic_e2e
from tfpose_tpu_torch.models import get_checkpoint_path
from tfpose_tpu_torch.ops import resize
from tfpose_tpu_torch.ops.decode import decode_batch, decode_maps, postprocess
from tfpose_tpu_torch.ops.kernels.paf_score import (
    score_candidates_raw,
    score_candidates_raw_plain,
)
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    smooth_nms,
    smooth_nms_plain,
    smooth_nms_topk_raw,
    smooth_nms_topk_raw_plain,
)

pytestmark = pytest.mark.cuda
K1, K2, K3, K4, K5, K6 = ("smooth_nms_topk_raw", "smooth_nms",
                          "score_candidates_raw", "smooth_nms_topk",
                          "assemble_dense", "bias_prelu")
ALL = (K1, K2, K3, K4, K5, K6)


@pytest.fixture(scope="module")
def card():
    dev = torch_cases.card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def launched(counts, must=(), never=()):
    """Every kernel of ``must`` launched and none of ``never``."""
    assert all(counts[k] > 0 for k in must), counts
    assert not any(counts[k] for k in never), counts


# ---- the estimator's entry points: thin368_coco at 432x368, upsample 4
# unless the path says otherwise


@pytest.fixture(scope="module")
def thin(card):
    """thin368_coco on the card and on the CPU."""
    est = torch_cases.thin368("cuda")
    assert next(est.net.parameters()).device.type == card.type
    return est, torch_cases.thin368("cpu")


@pytest.fixture(scope="module")
def imgs(card):
    return render_frames(np.random.default_rng(7), 8, 368, 432)


@pytest.fixture(scope="module")
def frames720(card):
    return render_frames(np.random.default_rng(720), 2, 720, 1280)


# path -> (its human lists on an estimator, kernels it must launch,
# kernels it must not); over the paths every decode kernel launches
PATHS = {
    "inference x8": (lambda e, im, fr: [
        e.inference(i, upsample_size=4.0) for i in im], (K2, K5),
        (K1, K3, K4, K6)),
    "inference_batch B=8": (lambda e, im, fr: e.inference_batch(
        im, upsample_size=4.0), (K1, K3, K5), (K2, K4, K6)),
    "inference_windowed 1280x720 x2": (lambda e, im, fr: [
        e.inference_windowed(f, upsample_size=4.0) for f in fr], (K4,),
        (K1, K6)),
    "inference_multiscale 1280x720 (1.0, 1.5)": (lambda e, im, fr: [
        e.inference_multiscale(fr[0], scales=(1.0, 1.5),
                               upsample_size=4.0)], (K4,), (K1, K6)),
    "inference_batch B=8 at 2.5x": (lambda e, im, fr: e.inference_batch(
        im, upsample_size=2.5), (K4,), (K6,)),
}


@pytest.mark.parametrize("path", PATHS)
def test_entry_points_equal_the_cpu(thin, imgs, frames720, path):
    """Each entry point on the card gives the CPU estimator's humans
    (coords 1e-6, scores 1e-4) and launches its path's kernels."""
    run, must, never = PATHS[path]
    got, counts = counted(lambda: run(thin[0], imgs, frames720))
    launched(counts, must, never)
    same_human_lists(got, run(thin[1], imgs, frames720), path)


def test_thin368_ap50_on_the_card(thin):
    """``tests/test_coco_path.py``'s gate for thin368_coco: AP50 at least
    0.95 on 50 rendered 432x368 scenes."""
    assert synthetic_e2e(thin[0], 50, 432, 368)[0]["AP50"] >= 0.95


def test_area_downscale_on_the_card_against_the_cpu(card, frames720):
    """1280x720 -> 432x368: within one grey level of the CPU's."""
    from tfpose_tpu_torch.pipeline.preprocess import downscale_area

    frame = torch.from_numpy(frames720[0])
    d = (downscale_area(frame.to(card), 368, 432).cpu().int()
         - downscale_area(frame, 368, 432).int()).abs()
    assert int(d.max()) <= 1


# ---- the v2 backbones with their committed checkpoints

@pytest.fixture(scope="module")
def v2(card):
    out = {}
    for name, wh in (("mobilenet_v2_small", (368, 368)),
                     ("mobilenet_v2_large", (432, 368))):
        kw = dict(target_size=wh, params_path=V2_CHECKPOINTS[name])
        out[name] = (TfPoseEstimator(name, device=card, **kw),
                     TfPoseEstimator(name, device="cpu", **kw))
    return out


V2_PATHS = {
    "v2small inference x8 368x368": ("mobilenet_v2_small", 368, lambda e, im: [
        e.inference(i, upsample_size=4.0) for i in im], (K2,)),
    "v2small inference_batch B=8 368x368": (
        "mobilenet_v2_small", 368, lambda e, im: e.inference_batch(
            im, upsample_size=4.0), (K1, K3)),
    "v2large inference x4 432x368": ("mobilenet_v2_large", 432, lambda e, im: [
        e.inference(i, upsample_size=4.0) for i in im[:4]], (K2,)),
}


@pytest.mark.parametrize("path", V2_PATHS)
def test_v2_paths_equal_the_cpu(v2, path):
    name, w, run, must = V2_PATHS[path]
    im = render_frames(np.random.default_rng(w), 8, 368, w)
    got, counts = counted(lambda: run(v2[name][0], im))
    launched(counts, must)
    same_human_lists(got, run(v2[name][1], im), path)


@pytest.mark.parametrize("name, n, gate", [("mobilenet_v2_small", 50, 0.90),
                                           ("mobilenet_v2_large", 25, 0.88)])
def test_v2_ap50_on_the_card(v2, name, n, gate):
    """``tests/test_coco_path.py``'s gates, on rendered 160x160 scenes."""
    assert synthetic_e2e(v2[name][0], n, 160, 160)[0]["AP50"] >= gate


# ---- CMU and BODY_25 at 656x368 on seeded weights (no checkpoint of
# either goes to the card)

@pytest.fixture(scope="module")
def frames656(card):
    for model in ("cmu", "body25"):
        assert not os.path.exists(get_checkpoint_path(model))
    return render_frames(np.random.default_rng(656), 16, 368, 656)


@pytest.mark.parametrize("model", ["cmu", "body25"])
def test_seeded_maps_equal_the_cpu(card, frames656, model):
    """The fp32 ``concat_stage7`` of two frames within 1e-4 of the
    largest |value| of the CPU forward's (TF32 off); on CMU's near-zero
    maps of 16 frames K1-K3 equal their plain versions, and
    ``inference`` launches K2."""
    est = TfPoseEstimator(model, target_size=(656, 368), device=card)
    cpu = TfPoseEstimator(model, target_size=(656, 368), device="cpu")
    with torch.inference_mode():
        maps = est._forward(np.stack(frames656), 368, 656)
        want = cpu._forward(np.stack(frames656[:2]), 368, 656)
    scale = want.abs().max().item()
    assert maps.shape[-1] == est.skeleton.out_ch and scale > 0
    assert (maps[:2].cpu() - want).abs().max().item() <= 1e-4 * scale
    if model == "body25":
        return
    launched(counted(lambda: est.inference(frames656[0],
                                           upsample_size=4.0))[1], (K2,))
    x = heat8_of(maps).contiguous()
    for k in (32, 128):
        s, i = smooth_nms_topk_raw(x, 4, 4, k, 0.05)
        assert all(map(torch.equal, (s, i), k1_phase_reference(x, 4, 4, k,
                                                               0.05)))
        s0, i0 = smooth_nms_topk_raw_plain(x, 4, 4, k, 0.05)
        assert torch.equal(i, i0)
        torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    heat = resize.resize_area(maps[0, ..., :19], 184, 328).contiguous()
    k2_compare(smooth_nms(heat), smooth_nms_plain(heat), "the cmu map")
    args = (peaks_of(*smooth_nms_topk_raw(x, 4, 4, 32, 0.05), 16, 328),
            maps[..., 19:], 184, 328, DecodeParams())
    k3_compare(score_candidates_raw(*args), score_candidates_raw_plain(*args),
               "the cmu maps")


@pytest.mark.parametrize("model, dtype, counts, traced", [
    ("cmu", "bfloat16", None, {"assemble_kernel": 1}),
    ("body25", "bfloat16", {K1: 1, K2: 0, K3: 1, K4: 0, K5: 1, K6: 99},
     {"bias_prelu_vec": 99, "assemble_kernel": 1}),
])
def test_batch_path_eager_capture_replay(card, frames656, model, dtype,
                                         counts, traced):
    """``inference_batch`` B=16 as the benchmark's cells call it: eager,
    the capture of the backbone's CUDA graph, then a replay. Each call's
    maps equal the eager call's bit for bit and launch the same kernels
    (K1, K3 and K5; BODY_25 K6 99 times, one forward); the replay's own
    trace holds ``traced`` (the graph runs them: the counts only add
    what the capture recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tfpose_tpu_torch.estimator import run_backbone

    est = TfPoseEstimator(model, target_size=(656, 368), dtype=dtype,
                          device=card)
    maps = []
    est.net.register_forward_hook(
        lambda m, a, out: maps.append(out["concat_stage7"]))

    def call():
        before = (run_backbone.eager, run_backbone.captures,
                  run_backbone.replays)
        n = counted(lambda: est.inference_batch(frames656,
                                                upsample_size=4.0))[1]
        after = (run_backbone.eager, run_backbone.captures,
                 run_backbone.replays)
        return [b - a for a, b in zip(before, after)], n

    steps = [call(), call()]
    launched(steps[0][1], (K1, K3, K5))
    # the profiler now and then loses a kernel's records: replay again
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps.append(call())
        seen = {k: sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and k in e.key)
                for k in traced}
        if seen == traced:
            break
    assert seen == traced
    assert [s for s, _ in steps] == [[1, 0, 0], [0, 1, 0]] + [[0, 0, 1]] * (
        len(steps) - 2)
    assert all(n == steps[0][1] for _, n in steps)
    assert counts is None or steps[0][1] == counts
    assert len(maps) == len(steps)
    assert all(torch.equal(m, maps[0]) for m in maps[1:])


def test_cmu_grid_decode_equals_the_cpu(card):
    """Rendered 46x82 maps (CMU's grid at 656x368): ``decode_batch`` at
    B=1 and 16 and ``postprocess`` + ``decode_maps`` give the CPU's
    humans, through K1, K2 and K3."""
    net = torch.from_numpy(scene_nets(82, [3, 1, 5, 0, 2, 6, 4, 2] * 2, 46,
                                      82))
    params = DecodeParams()

    def decode_all(net_g):
        peaks_map, _, paf_up = postprocess(net_g[0], 184, 328, params)
        one = decode_maps(peaks_map, paf_up, params)
        return (humans_of(decode_batch(net_g[:1], 184, 328, params))
                + humans_of(decode_batch(net_g, 184, 328, params))
                + humans_of(type(one)(*(t[None] for t in one))))

    got, counts = counted(lambda: decode_all(net.to(card)))
    launched(counts, (K1, K2, K3))
    same_human_lists(got, decode_all(net), "cmu grid")


# ---- serving

def test_batcher_flushes_eight_futures_at_once(thin, imgs):
    """Eight futures submitted before the first flush: one batch of 8,
    whose humans equal ``inference_batch``'s."""
    from tfpose_tpu_torch.serving import DynamicBatcher

    batcher = DynamicBatcher(thin[0], max_batch=8, max_wait_ms=2000.0,
                             upsample_size=4.0)
    try:
        got, counts = counted(lambda: [f.result(timeout=60) for f in [
            batcher.submit(img) for img in imgs]])
    finally:
        batcher.stop()
    launched(counts, (K1, K3))
    assert batcher.batch_sizes == {8: 1}
    same_human_lists(got, thin[0].inference_batch(imgs, upsample_size=4.0),
                     "batcher")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluator_ap50_on_the_card(card, dtype):
    """``BatchedEvaluator`` with thin368_coco at batch 8 on 50 rendered
    432x368 scenes: AP50 at least 0.95."""
    from tfpose_tpu_torch.evaluation.coco_eval import evaluate_oks_ap
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator

    items, gts = rendered_coco(50, 432, 368)
    ev = BatchedEvaluator("mobilenet_thin", (432, 368), batch_size=8,
                          dtype=dtype, device=card)
    ev.load_params(CHECKPOINT)
    dets, counts = counted(lambda: ev.evaluate(iter(items)))
    launched(counts, (K1, K3))
    assert evaluate_oks_ap(gts, dets)["AP50"] >= 0.95


# ---- bf16 and int8

def test_bf16_maps_and_paths(thin, frames656, imgs, card):
    """bf16 against fp32 on the card: thin368_coco's maps within 5 % of
    the largest value at the 99th percentile and 35 % at most, CMU's
    (seeded) within 5 %; bf16 ``inference`` launches K2 (the bf16 batches
    launch K1 and K3 in ``test_evaluator_ap50_on_the_card`` and
    ``test_batch_path_eager_capture_replay``)."""
    est16 = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                            params_path=CHECKPOINT, dtype="bfloat16",
                            device=card)
    cmu = {dt: TfPoseEstimator("cmu", target_size=(656, 368), dtype=dt,
                               device=card) for dt in ("float32", "bfloat16")}
    with torch.inference_mode():
        for e32, e16, frames, w, p99, top in (
                (thin[0], est16, imgs, 432, 0.05, 0.35),
                (cmu["float32"], cmu["bfloat16"], frames656, 656, 1, 0.05)):
            m32 = e32._forward(np.stack(frames), 368, w)
            d = (e16._forward(np.stack(frames), 368, w) - m32).abs()
            scale = m32.abs().max().item()
            assert d.max().item() <= top * scale
            assert torch.quantile(d.flatten()[::7], 0.99).item() <= p99 * scale
    launched(counted(lambda: [est16.inference(i, upsample_size=4.0)
                              for i in imgs])[1], (K2,))


# ---- the trainer, and what it exports

@pytest.mark.parametrize("flags", [[], ["--device-targets"], ["--bf16"]],
                         ids=["fp32", "device-targets", "bf16"])
def test_trainer_learns_on_the_card(card, tmp_path, flags):
    """``tfpose-torch-train`` with mobilenet_thin at 368x368, B=16, lr
    3e-3, 30 steps on rendered scenes: the mean loss of the last 3 steps
    below 0.85 of the first 3 (``tests/test_learning.py``'s bar), fp32
    parameters on the card, no decode kernel launched; the fp32 run's
    exported ``params.msgpack``, loaded by the estimator, gives the
    trainer's heat maps bit for bit."""
    from tfpose_tpu_torch.cli import train as train_cli

    state, counts = counted(lambda: train_cli.main([
        "--synthetic", "--model", "mobilenet_thin", "--input-size",
        "368x368", "--batchsize", "16", "--lr", "3e-3", "--max-steps", "30",
        "--log-every", "1", "--checkpoint-dir", str(tmp_path),
        "--device", str(card)] + flags))
    launched(counts, never=ALL)
    loss = [h["loss"] for h in state.history]
    assert state.step == 30 and len(loss) == 30
    assert np.mean(loss[-3:]) < 0.85 * np.mean(loss[:3])
    assert all(p.dtype == torch.float32 and p.device.type == card.type
               for p in state.net.parameters())
    if flags:
        return
    est = TfPoseEstimator("mobilenet_thin", target_size=(368, 368),
                          params_path=str(tmp_path / "params.msgpack"),
                          device=card)
    timgs = np.stack(render_frames(np.random.default_rng(9), 4, 368, 368))
    with torch.inference_mode():
        maps = est._forward(timgs, 368, 368).cpu().numpy()
    assert np.array_equal(maps[..., :19],
                          train_cli.predict_heat(state.net, timgs))


# ---- conversion and the profiling helpers

def test_converted_graph_runs_on_the_card(thin, imgs, card, tmp_path):
    """thin368_coco written as a flat GraphDef (``Openpose`` scope, /read
    nodes) and read back by ``convert_pb_file``: the msgpack bytes equal
    the checkpoint file's, and an estimator on them gives the
    checkpoint's maps, ``heatMat``/``pafMat`` and humans bit for bit, K2
    on ``inference`` and K1 and K3 on ``inference_batch``."""
    from tfpose_tpu_torch.convert import graphdef
    from tfpose_tpu_torch.convert.checkpoint import load_flax_msgpack

    pb, out = tmp_path / "graph_opt.pb", tmp_path / "converted.msgpack"
    pb.write_bytes(graphdef.variables_to_graphdef(
        load_flax_msgpack(CHECKPOINT), scope="Openpose",
        read_nodes=True).SerializeToString())
    graphdef.convert_pb_file(str(pb), "mobilenet_thin", str(out))
    assert out.read_bytes() == open(CHECKPOINT, "rb").read()
    est, conv = thin[0], TfPoseEstimator(
        "mobilenet_thin", target_size=(432, 368), params_path=str(out),
        device=card)
    with torch.inference_mode():
        assert torch.equal(conv._forward(np.stack(imgs), 368, 432),
                           est._forward(np.stack(imgs), 368, 432))
    for img in imgs[:2]:
        got, counts = counted(lambda: conv.inference(img, upsample_size=4.0))
        launched(counts, (K2,))
        same_humans(got, est.inference(img, upsample_size=4.0), "inference")
        assert np.array_equal(conv.heatMat, est.heatMat)
        assert np.array_equal(conv.pafMat, est.pafMat)
    got, counts = counted(lambda: conv.inference_batch(imgs,
                                                       upsample_size=4.0))
    launched(counts, (K1, K3))
    same_human_lists(got, est.inference_batch(imgs, upsample_size=4.0),
                     "inference_batch")


# ---- the mesh's ranks sharing the one card (parallel/)

@pytest.fixture(scope="module")
def mesh_case(card):
    """16 rendered 432x368 scenes and two train batches (B=16, 368x368),
    with the unsharded evaluator, forward and train steps on the card
    (cuDNN's deterministic algorithms, for the bit-for-bit legs)."""
    from tfpose_tpu_torch.cli.train import synthetic_batches

    items, _ = rendered_coco(16, 432, 368, seed=11)
    gen = synthetic_batches(16, (368, 368), np.random.default_rng(12))
    batches = [next(gen) for _ in range(2)]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        want = dict(eval=evaluate_on(None, items, device=card),
                    train2=train_steps(batches, device=card),
                    train1=train_steps(batches[:1], device=card))
    with torch.inference_mode():
        want["maps"] = torch_cases.thin368("cuda")._forward(np.stack([i for _, i, _ in items]), 368,
                                    432).cpu().numpy()
    return items, batches, want


def _batch_keys(batches):
    return [[humans_key(h) for h in b] for b in batches]


def test_nccl_rank_equals_the_unsharded_runs(mesh_case):
    """NCCL initialises with one rank and ``make_mesh()`` takes the
    visible card; an ``all_reduce`` on the mesh's world group returns
    its tensor; the evaluator's humans and detections (gathered by
    ``all_reduce``) equal the unsharded ones exactly, through K1 and K3;
    two train steps give the unsharded losses and state bit for bit."""
    from tfpose_tpu_torch.parallel.mesh import launch

    items, batches, want = mesh_case
    (got,) = launch(rank_nccl, 1, ["cuda:0"], "nccl", items, batches,
                    timeout=120)
    assert (got["backend"], got["device"]) == ("nccl", "cuda:0")
    assert got["shape"] == {"data": 1, "spatial": 1}
    np.testing.assert_array_equal(got["all_reduce"],
                                  np.arange(5, dtype=np.float32))
    launched(got["launches"], (K1, K3))
    assert _batch_keys(got["humans"]) == _batch_keys(want["eval"][0])
    assert got["dets"] == want["eval"][1]
    assert got["losses"] == want["train2"][0]
    for k, v in want["train2"][1].items():
        assert np.array_equal(got["state"][k], v), k


def test_gloo_two_ranks_share_the_card(mesh_case):
    """Two gloo ranks on the card: the thin368 forward of the 16 scenes
    on a (1 x 2) mesh, row halos exchanged, gathered alike on both ranks
    and within 1e-4 of the unsharded forward, with no decode kernel; the
    evaluator on (2 x 1), every rank's humans the unsharded ones (parts
    exact, coords 1e-6, scores 1e-4) through K1 and K3."""
    from tfpose_tpu_torch.parallel.mesh import launch

    items, _, want = mesh_case
    devices = ["cuda:0"] * 2
    two = launch(rank_gloo2, 2, devices, "gloo",
                 [i for _, i, _ in items], items, devices, timeout=120)
    assert np.array_equal(two[0]["maps"], two[1]["maps"])
    assert np.abs(two[0]["maps"] - want["maps"]).max() <= 1e-4
    for r, out in enumerate(two):
        launched(out["launches"]["forward"], never=ALL)
        launched(out["launches"]["eval"], (K1, K3))
        for g, w in zip(out["humans"], want["eval"][0]):
            for i, (gh, wh) in enumerate(zip(g, w)):
                same_humans(gh, wh, f"rank {r} image {i}")
        assert ([d["image_id"] for d in out["dets"]]
                == [d["image_id"] for d in want["eval"][1]])


def test_gloo_four_ranks_train_step(mesh_case):
    """Four gloo ranks on the card, one train step on (2 x 2) against the
    unsharded step: loss rtol 1e-5, BN statistics rtol 1e-5 (atol 1e-7),
    parameters atol 2.1e-4, gradients (Adam's first moment) within 0.15
    of the largest; the four states equal bit for bit (checked in the
    ranks)."""
    from tfpose_tpu_torch.parallel.mesh import launch

    _, batches, want = mesh_case
    devices = ["cuda:0"] * 4
    losses, state = launch(rank_train, 4, devices, "gloo", batches[:1],
                           devices, timeout=180)[0]
    loss, ref = want["train1"]
    assert abs(losses[0] - loss[0]) <= 1e-5 * loss[0]
    params, bn, mu = state_diff(state, ref)
    assert params <= 2.1e-4 and bn <= 1 and mu <= 0.15


# ---- the parity sweep and the tools

def test_parity_sweep_on_the_card(card):
    """Two rounds of the 8 recipe scenes decoded on the card (K1 and K3;
    K1 again at K=128 where a scene escalates) against the NumPy oracle,
    every other default scene against the C++ oracle where ``g++`` is
    present, and 8 rendered 432x368 scenes through thin368_coco: 0
    mismatches."""
    import shutil

    from tfpose_tpu_torch.evaluation import parity_sweep

    cpp_every = 2 if shutil.which("g++") else 0
    stats, counts = counted(lambda: parity_sweep.run_sweep(
        16, seed0=3000, cpp_every=cpp_every, device=str(card)))
    launched(counts, (K1, K3))
    assert stats.mismatch_total == 0 and stats.cpp_mismatch == 0, \
        stats.examples
    assert stats.escalated >= 2
    ck, counts = counted(lambda: parity_sweep.run_ckpt_sweep(
        8, CHECKPOINT, (432, 368), seed0=3000, cpp_every=cpp_every,
        device=str(card)))
    launched(counts, (K1, K3))
    assert ck.total == 8 and ck.mismatch_total == 0 and ck.cpp_mismatch == 0


@pytest.mark.parametrize("max_batch", [1, 8])
def test_broadcaster_on_the_card(thin, card, tmp_path, monkeypatch,
                                 max_batch):
    """The broadcaster (thin368_coco as the model's converted checkpoint,
    432x368, upsample 4) on 127.0.0.1 and 8 rendered 640x480 frames
    through ``visualization.annotate``: the humans equal ``inference``'s
    on the card, skeletons drawn; K2 and K5 once a frame at max_batch 1,
    K1, K3 and K5 once a flush at 8."""
    from tfpose_tpu_torch.cli import broadcaster, visualization
    from tfpose_tpu_torch.serving import PoseClient, humans_to_msg

    link = tmp_path / "jax" / "mobilenet_thin" / "params.msgpack"
    link.parent.mkdir(parents=True)
    link.symlink_to(CHECKPOINT)
    monkeypatch.setenv("TFPOSE_TPU_MODEL_DIR", str(tmp_path))
    frames = render_frames(np.random.default_rng(1313), 8, 480, 640)
    want = [humans_to_msg(thin[0].inference(f, upsample_size=4.0), 640, 480)
            for f in frames]
    assert sum(len(m.persons) for m in want) > 0
    svc = broadcaster.build_service(broadcaster.parse_args(
        ["--port", "0", "--max-batch", str(max_batch), "--device",
         str(card)]))
    assert svc.estimator.device.type == card.type
    client = None
    try:
        client = PoseClient(*svc.start())
        got, counts = counted(lambda: [visualization.annotate(client, f)
                                       for f in frames])
        n = (sum(svc._batcher.batch_sizes.values()) if max_batch > 1
             else 8)
    finally:
        if client is not None:
            client.close()
        svc.stop()
    assert n >= 1 and counts == (
        {K1: 0, K2: 8, K3: 0, K4: 0, K5: 8, K6: 0} if max_batch == 1 else
        {K1: n, K2: 0, K3: n, K4: 0, K5: n, K6: 0})
    for i, ((humans, img), w) in enumerate(zip(got, want)):
        same_persons(humans_to_msg(humans, 640, 480), w, f"frame {i}")
        assert img.shape == frames[i].shape
        assert not humans or (img != frames[i]).any()


def test_backbone_sweep_on_the_card(card, tmp_path):
    """BASELINE config 5 in bf16, 50 scenes each, over the checkpoints
    that go to the card: each AP50 at least its gate in
    ``tests/test_coco_path.py`` (CMU's 200 MB checkpoint stays off the
    card)."""
    from tfpose_tpu_torch.evaluation import backbone_sweep

    gates = {"mobilenet_thin": 0.95, "mobilenet_v2_large": 0.88,
             "mobilenet_v2_small": 0.90, "mobilenet": 0.92}
    doc, counts = counted(lambda: backbone_sweep.main([
        "--models", ",".join(gates), "--scenes", "50", "--out",
        str(tmp_path / "sweep.json"), "--device", str(card)]))
    launched(counts, (K1, K3))
    assert set(doc["backbones"]) == set(gates)
    for model, gate in gates.items():
        row = doc["backbones"][model]
        assert row["AP50"] >= gate and row["img_per_s"] > 0, (model, row)


@pytest.mark.parametrize("argv", [["stages", "--batch", "1", "--json"],
                                  ["stages", "--batch", "16", "--json"],
                                  ["forward"], ["ops", "--json"]],
                         ids=["stages-b1", "stages-b16", "forward", "ops"])
def test_profiles_on_the_card(thin, argv):
    """One call of each ``tfpose-torch-profile`` command: the decode's
    stages through K1, K3 and K4; the forward's device profile of thin
    (its FLOPs ``get_flops``'s) and CMU with no decode kernel; CMU's
    per-op table, whose buckets sum to its total."""
    from tfpose_tpu_torch import profiles

    doc, counts = counted(lambda: profiles.main(list(argv)))
    if argv[0] == "stages":
        launched(counts, (K1, K3, K4))
        assert all(np.isfinite(r["ms_per_img"]) and r["busy_ms_per_img"] > 0
                   and r["kernels_per_call"] > 0 for r in doc["stages"]), doc
    elif argv[0] == "forward":
        launched(counts, never=ALL)
        assert [(r["model"], r["batch"]) for r in doc] == [
            ("mobilenet_thin", 1), ("mobilenet_thin", 16), ("cmu", 1),
            ("cmu", 8)]
        flops = thin[0].get_flops()
        for r in doc:
            assert 0 < r["tensor_peak_pct"] < 100 and r["top_ops"], r
            assert (r["model"] != "mobilenet_thin" or abs(
                r["gflops"] - flops * r["batch"] / 1e9) <= 0.01), r
    else:
        buckets = doc["buckets_ms"]
        assert doc["model"] == "cmu" and doc["batch"] == 8
        assert buckets.get("conv", 0.0) > 0
        assert abs(sum(buckets.values()) - doc["op_total_ms"]) <= (
            1e-6 * doc["op_total_ms"])
