"""The port's training data path and trainer CLI on the CPU: the NumPy
copies of the JAX package's data modules (``train/dataset.py``,
``train/augment.py``, ``train/coco_export.py``, ``train/summaries.py``,
the synthetic batches of ``cli/train.py``) equal the JAX ones bit for
bit at the same seeds; the batch stream (``train/dataworker.py``) is the
JAX wire format both ways; ``tfpose-torch-train`` learns, resumes, logs,
and exports a ``params.msgpack`` that the JAX package loads."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.train import augment as jax_aug
from tfpose_tpu.train import coco_export as jax_export
from tfpose_tpu.train import dataset as jax_ds
from tfpose_tpu.train import dataworker as jax_worker
from tfpose_tpu.train import summaries as jax_summaries
from tfpose_tpu_torch.cli import train as train_cli
from tfpose_tpu_torch.train import augment as aug
from tfpose_tpu_torch.train import coco_export
from tfpose_tpu_torch.train import dataset as ds
from tfpose_tpu_torch.train import dataworker
from tfpose_tpu_torch.train import summaries
from test_torch_train import B, H, W, _batches, _run_both, start  # noqa: F401

torch.set_num_threads(2)

_ROOT = os.path.join(os.path.dirname(__file__), "..")


def _jax_train_cli():
    spec = importlib.util.spec_from_file_location(
        "train_cli_jax", os.path.join(_ROOT, "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k], equal_nan=True), k


def _people(seed, n=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    people = rng.uniform(0, min(h, w), (n, 18, 2))
    people[rng.uniform(size=(n, 18)) < 0.2] = np.nan
    return people


def test_targets_and_coco_parsing_match_jax():
    """``coco_to_18`` (neck from both shoulders, invisible parts NaN)
    and the heatmap and PAF rasterisers at strides 1 and 8, bit for
    bit."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        kp = np.column_stack([rng.uniform(0, 100, (17, 2)),
                              rng.integers(0, 3, 17)]).ravel()
        assert np.array_equal(ds.coco_to_18(kp), jax_ds.coco_to_18(kp),
                              equal_nan=True)
    people = _people(1)
    for stride in (1.0, 8.0):
        for h, w in ((40, 56), (5, 7)):
            assert np.array_equal(
                ds.get_heatmap(people, h, w, sigma=3.0, stride=stride),
                jax_ds.get_heatmap(people, h, w, sigma=3.0, stride=stride))
            assert np.array_equal(
                ds.get_vectormap(people, h, w, threshold=2.0, stride=stride),
                jax_ds.get_vectormap(people, h, w, threshold=2.0,
                                     stride=stride))
    empty = np.zeros((0, 18, 2))
    assert np.array_equal(ds.get_heatmap(empty, 4, 5),
                          jax_ds.get_heatmap(empty, 4, 5))
    assert np.array_equal(ds.get_vectormap(empty, 4, 5),
                          jax_ds.get_vectormap(empty, 4, 5))


def test_augmentations_match_jax():
    """Every augmentation and the whole chain, from the same generator
    state: the same image bytes and joints (cv2 inside the functions)."""
    img = np.random.default_rng(2).integers(0, 255, (90, 120, 3), np.uint8)
    joints = _people(3, h=90, w=120)
    fns = [
        ("random_scale", lambda m, i, j, r: m.random_scale(i, j, r)),
        ("random_rotation", lambda m, i, j, r: m.random_rotation(i, j, r)),
        ("random_flip", lambda m, i, j, r: m.random_flip(i, j, r)),
        ("resize_shortest_edge",
         lambda m, i, j, r: m.resize_shortest_edge(i, j, 70)),
        ("random_crop", lambda m, i, j, r: m.random_crop(i, j, (64, 96), r)),
        ("resize_fixed", lambda m, i, j, r: m.resize_fixed(i, j, (48, 40))),
        ("augment", lambda m, i, j, r: m.augment(i, j, (64, 48), r)),
    ]
    for name, fn in fns:
        for seed in range(3):
            gi, gj = fn(aug, img, joints, np.random.default_rng(seed))
            wi, wj = fn(jax_aug, img, joints, np.random.default_rng(seed))
            assert np.array_equal(gi, wi), name
            assert np.array_equal(gj, wj, equal_nan=True), name


def test_coco_export_and_pose_dataset_match_jax(tmp_path):
    """``write_synthetic_coco`` writes the same json and PNGs as the JAX
    one; ``load_coco_annotations`` reads the same annotations; and
    ``PoseDataset`` (augmented, then fixed-resize with device targets
    and uint8 frames) yields the same batches, bit for bit."""
    a, b = tmp_path / "port", tmp_path / "jax"
    ja, ia = coco_export.write_synthetic_coco(str(a), 6, (64, 48), seed=1)
    jb, ib = jax_export.write_synthetic_coco(str(b), 6, (64, 48), seed=1)
    assert json.load(open(ja)) == json.load(open(jb))
    for name in sorted(os.listdir(ib)):
        assert open(os.path.join(ia, name), "rb").read() == open(
            os.path.join(ib, name), "rb").read()
    anns = ds.load_coco_annotations(ja, ia)
    janns = jax_ds.load_coco_annotations(jb, ia)
    assert [(x.img_path, x.width, x.height) for x in anns] == \
        [(x.img_path, x.width, x.height) for x in janns]
    assert all(np.array_equal(x.joints, y.joints, equal_nan=True)
               for x, y in zip(anns, janns))
    for kw in (dict(augment=True), dict(augment=False, device_targets=True,
                                        uint8=True)):
        got = list(ds.PoseDataset(anns, (64, 48), 2, seed=3, **kw))
        want = list(jax_ds.PoseDataset(janns, (64, 48), 2, seed=3, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _equal_batches(g, w)


def test_synthetic_batches_match_jax():
    """``cli/train.py``'s rendered batches (host targets; joints for
    ``--device-targets``, float and uint8) equal ``train.py``'s at the
    same seed, and the prefetcher keeps their order."""
    jax_cli = _jax_train_cli()
    g = ds.PrefetchIterator(train_cli.synthetic_batches(
        3, (48, 40), np.random.default_rng(4), style_randomize=True), 2)
    w = jax_cli.synthetic_batches(3, (48, 40), np.random.default_rng(4),
                                  style_randomize=True)
    for got, want in zip(iter(g), [next(w) for _ in range(2)]):
        _equal_batches(got, want)
    for uint8 in (False, True):
        g = train_cli.synthetic_joint_batches(
            2, (48, 40), np.random.default_rng(5), uint8_feed=uint8)
        w = jax_cli.synthetic_joint_batches(
            2, (48, 40), np.random.default_rng(5), uint8_feed=uint8)
        _equal_batches(next(g), {k: np.asarray(v) for k, v in
                                 next(w).items()})


class _Recorder:
    def __init__(self):
        self.calls = []

    def scalar(self, *a):
        self.calls.append(("scalar",) + a)

    def image(self, *a):
        self.calls.append(("image",) + a)


def test_summaries_match_jax():
    """The prediction panel (input, predicted and ground-truth heat)
    and the scalars a writer receives equal the JAX module's; without a
    log directory the writer is the no-op one."""
    rng = np.random.default_rng(6)
    image = rng.uniform(-0.5, 0.5, (40, 48, 3)).astype(np.float32)
    pred, gt = rng.uniform(size=(2, 5, 6, 19)).astype(np.float32)
    got, want = _Recorder(), _Recorder()
    summaries.write_prediction_panel(got, 7, image, pred, gt)
    jax_summaries.write_prediction_panel(want, 7, image, pred, gt)
    summaries.write_scalars(got, 7, {"train/loss": np.float32(2.5)})
    jax_summaries.write_scalars(want, 7, {"train/loss": np.float32(2.5)})
    assert len(got.calls) == len(want.calls) == 2
    assert got.calls[0][:2] == want.calls[0][:2]
    assert np.array_equal(got.calls[0][2], want.calls[0][2])
    assert got.calls[1] == want.calls[1]
    assert isinstance(summaries.make_writer(""), summaries.NullWriter)


@pytest.mark.parametrize("server,client", [("jax", "port"),
                                           ("port", "jax")])
def test_dataworker_streams_between_the_packages(server, client):
    """A worker of one package feeds the other's ``RemoteBatches`` on
    127.0.0.1: three batches (float, uint8 and NaN-padded joints) arrive
    bit for bit."""
    rng = np.random.default_rng(7)
    sent = [{"image": rng.normal(size=(2, 8, 8, 3)).astype(np.float32),
             "heat": rng.uniform(size=(2, 1, 1, 19)).astype(np.float32)},
            {"image": rng.integers(0, 255, (2, 8, 8, 3), np.uint8),
             "joints": np.full((2, 3, 18, 2), np.nan, np.float32)},
            {"image": np.zeros((1, 4, 4, 3), np.float32)}]
    srv = {"jax": jax_worker, "port": dataworker}[server]
    cli = {"jax": jax_worker, "port": dataworker}[client]
    (host, port), stop = srv.serve_batches(iter(sent))
    remote = cli.RemoteBatches([(host, port)])
    try:
        it = iter(remote)
        for want in sent:
            _equal_batches(next(it), want)
    finally:
        remote.close()
        stop()


def _losses(model_dtype, steps=30):
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.models.layers import init_weights
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step)

    net = init_weights(get_network("mobilenet_thin", model_dtype),
                       torch.Generator().manual_seed(0))
    tx = make_optimizer(1e-3)
    state = TrainState.create(net, tx)
    step = make_train_step()
    batches = train_cli.synthetic_batches(4, (32, 32),
                                          np.random.default_rng(0))
    losses = []
    for _, batch in zip(range(steps), batches):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, metrics, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_training_loss_decreases(dtype):
    """``tests/test_learning.py``'s smoke on the port: 30 steps of thin
    at 32x32, B = 4, lr 1e-3 on rendered scenes; the mean loss of the
    last 3 steps below 0.85 of the first 3. In bf16 the parameters and
    the loss stay fp32."""
    state, metrics, losses = _losses(getattr(torch, dtype))
    assert np.mean(losses[-3:]) < 0.85 * np.mean(losses[:3]), losses
    assert all(p.dtype == torch.float32 for p in state.net.parameters())
    assert metrics["loss"].dtype == torch.float32


def test_train_cli_remote_data_and_logdir(tmp_path):
    """``train`` consuming a data worker's batches, in bf16, writing
    TensorBoard scalars and a prediction panel (``train.py``'s test);
    a mesh larger than the cards raises JAX's message, and a Datum shard
    that does not exist raises (``tests/test_torch_datum.py`` trains on
    one)."""
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"image": rng.normal(size=(4, 32, 32, 3)).astype(
                       np.float32),
                   "heat": rng.uniform(size=(4, 4, 4, 19)).astype(
                       np.float32),
                   "paf": rng.uniform(size=(4, 4, 4, 38)).astype(
                       np.float32)}

    (host, port), stop = dataworker.serve_batches(batches())
    logdir = str(tmp_path / "logs")
    try:
        state = train_cli.main([
            "--input-size", "32x32", "--batchsize", "4", "--max-steps",
            "3", "--log-every", "1", "--image-summary-every", "2",
            "--remote-data", f"{host}:{port}", "--logdir", logdir,
            "--bf16", "--device", "cpu"])
    finally:
        stop()
    assert state.step == 3 and [h["step"] for h in state.history] == [1, 2, 3]
    events = [f for f in os.listdir(logdir) if "tfevents" in f]
    assert events
    assert os.path.getsize(os.path.join(logdir, events[0])) > 500
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(ValueError, match="need 2x1 devices, have 0"):
            train_cli.main(["--mesh-data", "2"])
    with pytest.raises(FileNotFoundError):
        train_cli.main(["--datum-shard", str(tmp_path / "x.tpds"),
                        "--device", "cpu"])


def test_train_cli_resumes_and_exports_for_jax(tmp_path):
    """``--checkpoint-dir``: ``torch.save`` states every 2 steps (the
    last three kept), ``--resume latest`` continues the step count, and
    the exported ``params.msgpack`` loads in JAX's ``load_params``, whose
    network gives the port's maps (within 1e-5), and in the port's
    estimator."""
    from tfpose_tpu.convert.checkpoint import load_params
    from tfpose_tpu.models import get_network as jax_network
    from tfpose_tpu_torch.estimator import TfPoseEstimator, run_backbone

    ckpt = str(tmp_path / "ckpt")
    argv = ["--synthetic", "--input-size", "32x32", "--batchsize", "2",
            "--log-every", "1", "--checkpoint-dir", ckpt, "--save-every",
            "2", "--device", "cpu", "--device-targets", "--uint8-feed"]
    state = train_cli.main(argv + ["--max-steps", "3"])
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) == \
        ["2.pt", "3.pt"]
    state = train_cli.main(argv + ["--max-steps", "9", "--resume", "latest"])
    assert state.step == 9 and state.history[0]["step"] == 4
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".pt")) == \
        ["6.pt", "8.pt", "9.pt"]
    path = os.path.join(ckpt, "params.msgpack")
    jnet = jax_network("mobilenet_thin")
    x = np.random.default_rng(8).uniform(-0.5, 0.5, (1, 32, 32, 3)).astype(
        np.float32)
    template = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = load_params(path, template)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                 train=False)["concat_stage7"])
    state.net.eval()
    got = run_backbone(state.net, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max() + 1e-6
    est = TfPoseEstimator("mobilenet_thin", target_size=(32, 32),
                          params_path=path, device="cpu")
    maps = est._forward(np.zeros((1, 32, 32, 3), np.uint8), 32, 32)
    with torch.no_grad():
        ref = state.net(torch.full((1, 32, 32, 3), -0.5))["concat_stage7"]
    assert torch.equal(maps, ref)


def test_device_targets_uint8_feed_step_matches_jax(start):
    """``--device-targets --uint8-feed``: uint8 frames normalised on the
    device and targets rasterised from the NaN-padded joints inside the
    step, against JAX's ``make_train_step(rasterize=True)``: the loss
    rtol 1e-5, and equal to the step on host-rasterised targets of the
    same scenes within rtol 1e-5."""
    gen = train_cli.synthetic_joint_batches(B, (W, H),
                                            np.random.default_rng(2),
                                            uint8_feed=True)
    batch = next(gen)
    assert batch["image"].dtype == np.uint8
    _, jl, _, pl = _run_both(start, [batch], 1e-4, rasterize=True)
    assert pl[0] == pytest.approx(jl[0], rel=1e-5)
    host = _batches(1, seed=2)[0]
    assert np.array_equal(host["image"],
                          batch["image"].astype(np.float32) / 256 - 0.5)
    from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.train.state import batch_loss

    net = variables_from_numpy(get_network("mobilenet_thin"), start[1])
    assert pl[0] == pytest.approx(batch_loss(net, host)[0].item(), rel=1e-5)
