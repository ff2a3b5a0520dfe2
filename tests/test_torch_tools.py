"""The port's tools against the JAX package's, on the CPU: the
pycocotools path of ``evaluation/coco_eval.py`` and ``eval --coco-json``
against the repo's ``eval.py``; ``cli/broadcaster.py`` against a JAX
``PoseService`` built as ``scripts/broadcaster.py`` builds it, and its
``main`` in a process of its own; ``cli/visualization.py`` against
``scripts/visualization.py``; ``evaluation/backbone_sweep.py`` against
``scripts/sweep_backbones.py``; the console scripts. The JAX scripts are
loaded from their files and not edited. Both estimators load the
committed ``thin160_coco`` weights as the model's converted checkpoint
(``$TFPOSE_TPU_MODEL_DIR/jax/mobilenet_thin/params.msgpack``, which both
packages read); replies compare with parts exact, coords 1e-6 and
scores 1e-5."""

import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.evaluation import coco_eval as jax_coco_eval
from tfpose_tpu.serving import Persons as JaxPersons
from tfpose_tpu.serving import PoseClient as JaxClient
from tfpose_tpu.serving import PoseService as JaxService
from tfpose_tpu.utils.draw import draw_humans as jax_draw_humans
from tfpose_tpu_torch.cli import broadcaster, visualization
from tfpose_tpu_torch.cli import eval as eval_cli
from tfpose_tpu_torch.evaluation import backbone_sweep, coco_eval
from tfpose_tpu_torch.serving import Persons, PoseClient
from tfpose_tpu_torch.utils import synthetic

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_TRAINED = os.path.join(ROOT, "models", "trained")
_THIN160 = os.path.join(_TRAINED, "thin160_coco", "params.msgpack")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 4)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, h, w, rng))
    return out


def _persons_key(msg):
    return [[(bp.part_id, bp.x, bp.y, bp.confidence) for bp in p.body_part]
            for p in msg.persons]


def _assert_same_persons(got, want):
    """Equal ``Persons`` except the stamp: part ids exact, x and y 1e-6,
    confidences 1e-5."""
    assert (got.image_w, got.image_h) == (want.image_w, want.image_h)
    g, w = _persons_key(got), _persons_key(want)
    assert [[p[0] for p in h] for h in g] == [[p[0] for p in h] for h in w]
    for hg, hw in zip(g, w):
        for pg, pw in zip(hg, hw):
            assert abs(pg[1] - pw[1]) <= 1e-6 and abs(pg[2] - pw[2]) <= 1e-6
            assert abs(pg[3] - pw[3]) <= 1e-5


# ------------------------------------------------------------ pycocotools
def test_evaluate_with_pycocotools_is_none_without_it_as_in_jax(tmp_path):
    """Neither machine has pycocotools: both packages return ``None``,
    and the callers fall back to their own OKS AP."""
    path = str(tmp_path / "gt.json")
    with open(path, "w") as f:
        json.dump({"images": [], "annotations": [], "categories": []}, f)
    assert jax_coco_eval.evaluate_with_pycocotools(path, []) is None
    assert coco_eval.evaluate_with_pycocotools(path, []) is None


def test_eval_coco_json_equals_jax_eval(tmp_path):
    """``eval --coco-json`` on a two-image COCO file of rendered scenes:
    the stats equal those of the repo's ``eval.py`` within 1e-5."""
    import eval as jax_eval
    from tfpose_tpu_torch.train.coco_export import write_synthetic_coco

    pytest.importorskip("cv2")
    json_path, img_dir = write_synthetic_coco(str(tmp_path), 2, (160, 160),
                                              seed=3)
    args = ["--model", "mobilenet_thin", "--resize", "160x160",
            "--coco-json", json_path, "--coco-dir", img_dir,
            "--params", _THIN160]
    want = jax_eval.main(args + ["--write-json", str(tmp_path / "j.json")])
    got = eval_cli.main(args + ["--write-json", str(tmp_path / "p.json"),
                                "--device", "cpu"])
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-5), key
    assert got["matched_keypoints"] > 0


# ------------------------------------------------------------ broadcaster
@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory whose mobilenet_thin checkpoint is thin160_coco."""
    base = tmp_path_factory.mktemp("models")
    os.makedirs(base / "jax" / "mobilenet_thin")
    os.symlink(_THIN160, base / "jax" / "mobilenet_thin" / "params.msgpack")
    old = os.environ.get("TFPOSE_TPU_MODEL_DIR")
    os.environ["TFPOSE_TPU_MODEL_DIR"] = str(base)
    yield str(base)
    if old is None:
        del os.environ["TFPOSE_TPU_MODEL_DIR"]
    else:
        os.environ["TFPOSE_TPU_MODEL_DIR"] = old


@pytest.fixture(scope="module")
def jax_estimator(model_dir):
    return JaxEstimator("mobilenet_thin", target_size=(160, 160))


@pytest.fixture(scope="module")
def frames():
    # 320x320, halved to the 160x160 network: at a factor of 2 the port's
    # area resize equals cv2's INTER_AREA bit for bit
    return _frames(3, 320, 320, seed=31)


def _port_args(max_batch):
    return broadcaster.parse_args([
        "--model", "mobilenet_thin", "--resolution", "160x160", "--port",
        "0", "--max-batch", str(max_batch), "--device", "cpu"])


@pytest.fixture(scope="module")
def servers(jax_estimator):
    """Started services by max-batch: (JAX's, the port's)."""
    out = {}
    for mb in (1, 2):
        svc = broadcaster.build_service(_port_args(mb))
        jsvc = JaxService(jax_estimator, host="127.0.0.1", port=0,
                          upsample_size=4.0, max_batch=mb, max_wait_ms=5.0)
        out[mb] = (jsvc, svc)
        jsvc.start()
        svc.start()
    yield out
    for pair in out.values():
        for s in pair:
            s.stop()


def test_build_service_takes_the_flags(servers):
    svc = servers[2][1]
    assert svc.estimator.target_size == (160, 160)
    assert svc.estimator.device.type == "cpu"
    assert svc.ratio == 4.0 and svc._batcher is not None
    assert servers[1][1]._batcher is None
    assert svc.address[0] == "127.0.0.1" and svc.address[1] > 0


@pytest.mark.parametrize("max_batch", [1, 2])
def test_broadcaster_replies_equal_jax(servers, frames, max_batch):
    """The same raw frames to the JAX service and the port's
    ``build_service`` at one max-batch: equal ``Persons``."""
    jsvc, svc = servers[max_batch]
    cj, cp = JaxClient(*jsvc.address), PoseClient(*svc.address)
    try:
        n = 0
        for img in frames:
            want, got = cj.infer_raw(img), cp.infer_raw(img)
            _assert_same_persons(got, want)
            n += len(got.persons)
        assert n >= 3
    finally:
        cj.close()
        cp.close()


def test_broadcaster_main_serves_until_sigterm(model_dir, servers, frames):
    """``python -m tfpose_tpu_torch.cli.broadcaster`` logs its address,
    answers a client as the in-process service does, and stops on
    SIGTERM with exit code 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfpose_tpu_torch.cli.broadcaster",
         "--resolution", "160x160", "--port", "0", "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, TFPOSE_TPU_MODEL_DIR=model_dir,
                 OMP_NUM_THREADS="2"))
    lines = []
    try:
        timer = threading.Timer(120, proc.kill)
        timer.start()
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"broadcasting pose estimation on ([\d.]+):(\d+)",
                          line)
            if m:
                break
        timer.cancel()
        assert m, "".join(lines)
        c = PoseClient(m.group(1), int(m.group(2)))
        try:
            got = c.infer_raw(frames[0])
        finally:
            c.close()
        ref = PoseClient(*servers[1][1].address)
        try:
            _assert_same_persons(got, ref.infer_raw(frames[0]))
        finally:
            ref.close()
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, "".join(lines) + rest
    assert "SIGTERM: stopping" in rest


# ---------------------------------------------------------- visualization
@pytest.fixture(scope="module")
def jax_visualization():
    return _jax_script("visualization")


def _humans_key(humans):
    return [sorted((p, b.uidx, b.part_idx, b.x, b.y, b.score)
                   for p, b in h.body_parts.items()) for h in humans]


def test_msg_to_humans_equals_jax(jax_visualization):
    d = {"image_w": 320, "image_h": 240, "header": {"stamp": 1.5},
         "persons": [{"body_part": [
             {"part_id": 0, "x": 0.5, "y": 0.25, "confidence": 0.9},
             {"part_id": 4, "x": 0.125, "y": 0.75, "confidence": 0.3}]},
             {"body_part": [
                 {"part_id": 17, "x": 0.0, "y": 1.0, "confidence": 0.5}]}]}
    got = visualization.msg_to_humans(Persons.from_dict(d))
    want = jax_visualization.msg_to_humans(JaxPersons.from_dict(d))
    assert _humans_key(got) == _humans_key(want)
    assert got[1].body_parts[17].uidx == "1-17"


def test_annotate_draws_as_jax(servers, frames, jax_visualization):
    """``annotate``'s humans and image against JAX's
    ``draw_humans(frame, msg_to_humans(msg))`` of the same reply: pixel
    for pixel; the caller's frame is left as it was."""
    svc = servers[1][1]
    c = PoseClient(*svc.address)
    try:
        for frame in frames:
            before = frame.copy()
            humans, img = visualization.annotate(c, frame)
            assert np.array_equal(frame, before)
            msg = c.infer_raw(frame)
            want = jax_draw_humans(frame.copy(),
                                   jax_visualization.msg_to_humans(msg))
            assert _humans_key(humans) == _humans_key(
                jax_visualization.msg_to_humans(msg))
            assert np.array_equal(img, want)
            assert (img != frame).any()
    finally:
        c.close()


def test_visualization_main_writes_jax_frames(servers, frames, tmp_path,
                                              jax_visualization):
    """Both scripts' ``main`` on one MJPG written here, each against its
    own package's broadcaster: the frames they write read back equal."""
    cv2 = pytest.importorskip("cv2")
    video = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (320, 320))
    for f in frames:
        w.write(f)
    w.release()
    jsvc, svc = servers[1]
    outs = [str(tmp_path / "jax.mp4"), str(tmp_path / "port.mp4")]
    jax_visualization.main(["--video", video, "--port",
                            str(jsvc.address[1]), "--output", outs[0]])
    assert visualization.main(["--video", video, "--port",
                               str(svc.address[1]), "--output",
                               outs[1]]) == 3

    def read(path):
        cap = cv2.VideoCapture(path)
        got = []
        while True:
            ok, f = cap.read()
            if not ok:
                return got
            got.append(f)

    want, got = read(outs[0]), read(outs[1])
    assert len(want) == len(got) == 3
    for g, wf in zip(got, want):
        assert np.array_equal(g, wf)


# ------------------------------------------------------------------ sweep
@pytest.fixture(scope="module")
def jax_sweep():
    return _jax_script("sweep_backbones")


def test_make_scenes_equals_jax_bit_for_bit(jax_sweep):
    imgs, gts = backbone_sweep.make_scenes(6, 160, 160)
    jimgs, jgts = jax_sweep.make_scenes(6, 160, 160)
    assert len(imgs) == 6
    for a, b in zip(imgs, jimgs):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    assert gts.keys() == jgts.keys()
    for idx in gts:
        assert len(gts[idx]) == len(jgts[idx])
        for g, j in zip(gts[idx], jgts[idx]):
            assert g["area"] == j["area"]
            assert np.array_equal(np.asarray(g["keypoints"], np.float64),
                                  np.asarray(j["keypoints"], np.float64))


def test_zoo_is_jax_zoo(jax_sweep):
    assert backbone_sweep.ZOO == jax_sweep.ZOO


def test_sweep_v2small_row_equals_jax(jax_sweep, tmp_path):
    """The v2small160_coco row at 4 scenes without throughput: AP50 and
    the matched keypoints equal JAX's; AP, AP75 and AR within 0.05 and
    the deviation within 0.1 px (bf16 noise, PERF.md §6). Measured on
    the CPU: AP50 1.0 and 119 keypoints in both; AP 0.331, AP75 0.0212,
    AR 0.3714 in both; deviation 4.822 px (JAX 4.828)."""
    args = ["--models", "mobilenet_v2_small", "--scenes", "4",
            "--skip-throughput"]
    want = jax_sweep.main(args + ["--out", str(tmp_path / "j.json")])
    got = backbone_sweep.main(args + ["--out", str(tmp_path / "p.json"),
                                      "--device", "cpu"])
    assert json.load(open(tmp_path / "p.json")) == got
    assert got["device"] == "cpu" and got["scenes"] == 4
    row, ref = (d["backbones"]["mobilenet_v2_small"] for d in (got, want))
    msg = f"port {row}, JAX {ref}"
    for key in ("checkpoint", "resolution", "batch", "AP50",
                "matched_keypoints"):
        assert row[key] == ref[key], msg
    for key in ("AP", "AP75", "AR"):
        assert abs(row[key] - ref[key]) <= 0.05, msg
    assert abs(row["mean_px_deviation"] - ref["mean_px_deviation"]) <= 0.1, \
        msg
    assert "img_per_s" not in row


def test_sweep_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="v2small160_coco"):
        backbone_sweep.main(["--root", str(tmp_path), "--models",
                             "mobilenet_v2_small", "--skip-throughput",
                             "--out", str(tmp_path / "o.json"),
                             "--device", "cpu"])


def test_sweep_allow_missing_skips_the_row(tmp_path):
    """Under a root that holds v2small160_coco only: the cmu row is
    skipped; throughput then needs the card and raises on the CPU."""
    os.makedirs(tmp_path / "models" / "trained")
    os.symlink(os.path.join(_TRAINED, "v2small160_coco"),
               tmp_path / "models" / "trained" / "v2small160_coco")
    base = ["--root", str(tmp_path), "--models",
            "cmu,mobilenet_v2_small", "--scenes", "1", "--allow-missing",
            "--out", str(tmp_path / "o.json"), "--device", "cpu"]
    doc = backbone_sweep.main(base + ["--skip-throughput"])
    assert list(doc["backbones"]) == ["mobilenet_v2_small"]
    with pytest.raises(ValueError, match="CUDA"):
        backbone_sweep.main(base)


def test_sweep_writes_under_the_build_directory():
    rel = os.path.relpath(backbone_sweep.DEFAULT_OUT, ROOT)
    assert rel == os.path.join("tfpose_tpu_torch", "_build",
                               "sweep_backbones.json")
    assert "tfpose_tpu_torch/_build/" in open(
        os.path.join(ROOT, ".gitignore")).read().split()


# -------------------------------------------------------- console scripts
@pytest.mark.parametrize("name,target", [
    ("broadcaster", "tfpose_tpu_torch.cli.broadcaster"),
    ("visualization", "tfpose_tpu_torch.cli.visualization"),
    ("sweep-backbones", "tfpose_tpu_torch.evaluation.backbone_sweep"),
    ("profile", "tfpose_tpu_torch.profiles"),
])
def test_console_script_resolves(name, target, monkeypatch):
    """``tfpose-torch-<name>`` names an entry function that calls
    ``main`` of its module."""
    import importlib

    from tfpose_tpu_torch.cli import entry

    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    m = re.search(rf'^tfpose-torch-{name} = "tfpose_tpu_torch\.cli\.entry:'
                  rf'(\w+)"$', text, re.M)
    assert m
    called = []
    monkeypatch.setattr(importlib.import_module(target), "main",
                        lambda: called.append(name))
    getattr(entry, m.group(1))()
    assert called == [name]


def test_profiles_package_is_packaged():
    from setuptools import find_packages

    assert "tfpose_tpu_torch.profiles" in find_packages(
        ROOT, include=["tfpose_tpu*"])
