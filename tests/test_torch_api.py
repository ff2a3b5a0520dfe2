"""Port parity of the estimator's remaining API against the JAX package:
COCO keypoint evaluation, ``PoseEstimator.estimate_paf`` with its
``compat.pafprocess`` shim and NumPy decoder, ``runner.get_estimator`` /
``infer``, the estimator's ``device_preprocess`` resize, the batched
evaluation sweep (``evaluation/sweep.py``), the image loader and the
CLIs (``cli/``)."""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfpose_tpu.runner as jax_runner
import tfpose_tpu_torch
import tfpose_tpu_torch.runner as runner
from tfpose_tpu.core.types import BodyPart as JaxBodyPart
from tfpose_tpu.core.types import Human as JaxHuman
from tfpose_tpu.estimator import PoseEstimator as JaxPoseEstimator
from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.evaluation.sweep import BatchedEvaluator as JaxEvaluator
from tfpose_tpu.evaluation import coco_eval as jax_coco
from tfpose_tpu.oracle import numpy_decoder as jax_decoder
from tfpose_tpu.oracle import numpy_post
from tfpose_tpu.pipeline.preprocess import prepare as jax_prepare
from tfpose_tpu.utils import synthetic as jax_synthetic
from tfpose_tpu_torch.compat import pafprocess
from tfpose_tpu_torch.core.types import BodyPart, Human
from tfpose_tpu_torch.estimator import PoseEstimator, TfPoseEstimator
from tfpose_tpu_torch.cli import eval as eval_cli
from tfpose_tpu_torch.cli import run as run_cli
from tfpose_tpu_torch.cli import run_video as run_video_cli
from tfpose_tpu_torch.evaluation import coco_eval
from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
from tfpose_tpu_torch.oracle import numpy_decoder
from tfpose_tpu_torch.pipeline.preprocess import prepare_bilinear
from tfpose_tpu_torch.utils import imload
from test_torch_estimator import _assert_same_humans, _scenes

torch.set_num_threads(2)

_THIN160 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin160_coco", "params.msgpack")


# ---------------------------------------------------------------------------
# COCO evaluation
# ---------------------------------------------------------------------------

def _humans_pair(rng, n):
    """The same n random humans as port and JAX ``Human`` lists."""
    ours, theirs = [], []
    for i in range(n):
        h, j = Human(), JaxHuman()
        for p in np.flatnonzero(rng.random(18) < 0.8):
            x, y, s = (float(v) for v in rng.random(3))
            h.body_parts[int(p)] = BodyPart(f"{i}-{p}", int(p), x, y, s)
            j.body_parts[int(p)] = JaxBodyPart(f"{i}-{p}", int(p), x, y, s)
        h.score = j.score = float(rng.random())
        ours.append(h)
        theirs.append(j)
    return ours, theirs


def _ground_truth(rng, n_images):
    gts = {}
    for idx in range(n_images):
        gts[idx] = []
        for _ in range(int(rng.integers(0, 4))):
            kp = np.zeros((17, 3))
            kp[:, :2] = rng.uniform(0, 160, (17, 2))
            kp[:, 2] = 2 * (rng.random(17) < 0.85)
            gts[idx].append({"keypoints": kp.ravel().tolist(),
                             "area": float(rng.uniform(100, 4000))})
    return gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_matches_jax(seed):
    """Seeded humans -> detections, and OKS AP and mean keypoint
    deviation on seeded ground truth: exactly the JAX package's."""
    rng = np.random.default_rng(seed)
    gts = _ground_truth(rng, 12)
    dets, jdets = [], []
    for idx in range(12):
        ours, theirs = _humans_pair(rng, int(rng.integers(0, 5)))
        dets += coco_eval.humans_to_detections(ours, idx, 160, 160)
        jdets += jax_coco.humans_to_detections(theirs, idx, 160, 160)
    assert dets == jdets
    # detections near the ground truth, so that matches happen
    for d in dets[::2]:
        gt = gts[d["image_id"]]
        if gt:
            kp = np.asarray(gt[0]["keypoints"], np.float64).reshape(17, 3)
            kp[:, :2] += rng.normal(0, 3, (17, 2))
            d["keypoints"] = kp.ravel().tolist()
    got = coco_eval.evaluate_oks_ap(gts, dets)
    assert got == jax_coco.evaluate_oks_ap(gts, dets)
    assert got["AP50"] > 0
    dev = coco_eval.mean_keypoint_deviation(gts, dets)
    want = jax_coco.mean_keypoint_deviation(gts, dets)
    assert dev == want and dev["matched_humans"] > 0
    gt = np.asarray(gts[0][0]["keypoints"] if gts[0] else dets[0][
        "keypoints"], np.float64).reshape(17, 3)
    dt = gt + rng.normal(0, 2, gt.shape)
    assert coco_eval.oks(gt, 900.0, dt) == jax_coco.oks(gt, 900.0, dt)


def test_synthetic_e2e_ground_truth_matches_eval_cli():
    """The ground truth of ``synthetic_e2e`` is ``eval.py``'s: the same
    scenes from ``default_rng(7)`` and the same COCO entries."""
    rng = np.random.default_rng(7)
    people = jax_synthetic.random_people(
        rng, 2, 160, 160, separated=True,
        template=jax_synthetic.SPREAD_TEMPLATE)
    people[0, 3] = np.nan  # an unlabelled part
    for person in people:
        kp = []
        for coco_id in range(17):
            x, y = person[int(jax_coco.COCO17_FROM_MODEL18[coco_id])]
            kp.extend([0, 0, 0] if np.isnan(x) else [x, y, 2])
        entry = coco_eval.person_to_gt(person)
        assert entry["keypoints"] == kp
        xs, ys = person[:, 0][~np.isnan(person[:, 0])], person[:, 1][
            ~np.isnan(person[:, 1])]
        assert entry["area"] == pytest.approx(
            (xs.max() - xs.min()) * (ys.max() - ys.min()), rel=1e-12)


# ---------------------------------------------------------------------------
# estimate_paf, the pafprocess shim and the NumPy decoder
# ---------------------------------------------------------------------------

def _post(seed, n_people, noise=0.0):
    rng = np.random.default_rng(seed)
    net, _ = jax_synthetic.render_scene(rng, n_people, 46, 54, noise=noise)
    peaks, heat, paf = numpy_post.full_post(net, 184, 216)
    return (peaks.astype(np.float32), heat.astype(np.float32),
            paf.astype(np.float32))


_SCENES = [(50, 2, 0.0), (3, 5, 0.0), (8, 3, 0.05), (9, 0, 0.0)]


@pytest.mark.parametrize("seed, n_people, noise", _SCENES)
def test_numpy_decoder_copy_matches_the_jax_oracle(seed, n_people, noise):
    peaks, heat, paf = _post(seed, n_people, noise)
    got = numpy_decoder.process_paf(peaks, heat, paf)
    want = jax_decoder.process_paf(peaks, heat, paf)
    np.testing.assert_array_equal(got.parts, want.parts)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert len(got.subset) == len(want.subset)
    for a, b in zip(got.subset, want.subset):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed, n_people, noise", _SCENES)
def test_estimate_paf_matches_jax(seed, n_people, noise):
    """The port's ``PoseEstimator.estimate_paf`` (NumPy decoder) against
    the JAX one (its C++ decoder): parts and coords exact, scores 1e-5
    (the C++ decoder sums in float32)."""
    peaks, heat, paf = _post(seed, n_people, noise)
    got = PoseEstimator.estimate_paf(peaks, heat, paf)
    want = JaxPoseEstimator.estimate_paf(peaks, heat, paf)
    assert len(got) == len(want) >= min(n_people, 1)
    for g, w in zip(got, want):
        assert g.body_parts.keys() == w.body_parts.keys()
        assert abs(g.score - w.score) <= 1e-5
        for p, bp in g.body_parts.items():
            wp = w.body_parts[p]
            assert (bp.x, bp.y, bp.uidx) == (wp.x, wp.y, wp.uidx)
            assert bp.score == pytest.approx(wp.score, abs=1e-6)


def test_pafprocess_shim_api():
    peaks, heat, paf = _post(50, 2)
    assert pafprocess.process_paf(peaks, heat, paf) == 0
    assert pafprocess.get_num_humans() == 2
    for h in range(2):
        assert pafprocess.get_score(h) > 0.4
        parts = [p for p in range(18) if pafprocess.get_part_cid(h, p) >= 0]
        assert len(parts) >= 4
        for p in parts:
            assert 0 <= pafprocess.get_part_x(h, p) < 216
            assert 0 <= pafprocess.get_part_y(h, p) < 184
            assert pafprocess.get_part_score(h, p) > 0.05


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@pytest.fixture
def model_dir(tmp_path, monkeypatch):
    """A model directory whose mobilenet_thin checkpoint is thin160_coco,
    and empty estimator caches in both runners."""
    d = tmp_path / "jax" / "mobilenet_thin"
    d.mkdir(parents=True)
    os.symlink(os.path.abspath(_THIN160), d / "params.msgpack")
    monkeypatch.setenv("TFPOSE_TPU_MODEL_DIR", str(tmp_path))
    monkeypatch.setattr(runner, "_estimators", {})
    monkeypatch.setattr(jax_runner, "_estimators", {})
    return tmp_path


def test_runner_infer_on_an_array_matches_jax(model_dir):
    img = _scenes(1, 160, 160, seed=3)[0]
    got = runner.infer(img, "mobilenet_thin", "160x160", 4.0, device="cpu")
    want = jax_runner.infer(img, "mobilenet_thin", "160x160", 4.0)
    assert got
    _assert_same_humans(got, want)
    _assert_same_humans(tfpose_tpu_torch.infer(
        img, "mobilenet_thin", "160x160", 4.0, device="cpu"), want)
    est = runner.get_estimator("mobilenet_thin", "160x160", device="cpu")
    assert est is runner.get_estimator("mobilenet_thin", "160x160", "cpu")
    assert runner.get_estimator("mobilenet_thin", "0x0",
                                "cpu").target_size == (432, 368)


_P1 = os.path.join(os.path.dirname(__file__), "..", "images", "p1.jpg")


def test_runner_infer_on_a_path_matches_jax(model_dir):
    """A file path is read as ``tfpose_tpu.runner.infer`` reads it
    (``read_imgfile``, then the estimator's resize to the network)."""
    got = runner.infer(_P1, "mobilenet_thin", "160x160", 4.0, device="cpu")
    want = jax_runner.infer(_P1, "mobilenet_thin", "160x160", 4.0)
    assert got
    _assert_same_humans(got, want)
    _assert_same_humans(tfpose_tpu_torch.infer(
        _P1, "mobilenet_thin", "160x160", 4.0, device="cpu"), want)


def test_runner_infer_rejects_a_path(model_dir, tmp_path, monkeypatch):
    """A path that cannot be read raises as JAX's does; without cv2 a
    path raises naming cv2 (an array needs no cv2)."""
    for bad in (str(tmp_path / "missing.jpg"), None):
        with pytest.raises(Exception, match="can not be read"):
            jax_runner.infer(bad)
        with pytest.raises(Exception, match="can not be read"):
            runner.infer(bad, device="cpu")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        runner.infer(_P1, "mobilenet_thin", "160x160", device="cpu")
    img = _scenes(1, 160, 160, seed=3)[0]
    assert runner.infer(img, "mobilenet_thin", "160x160", 4.0, device="cpu")


def test_package_names_equal_jax():
    """``from tfpose_tpu_torch import BodyPart, Human`` as from the JAX
    package, and ``ops`` lists and imports the same six submodules."""
    import tfpose_tpu
    import tfpose_tpu.ops as jax_ops
    import tfpose_tpu_torch.ops as ops

    public = {n for n in dir(tfpose_tpu) if not n.startswith("_")}
    assert public - {"cli", "compat", "convert", "core", "estimator",
                     "evaluation", "models", "ops", "oracle", "parallel",
                     "pipeline", "runner", "serving", "train", "utils"} == \
        {"BodyPart", "Human", "infer"}
    assert tfpose_tpu_torch.BodyPart is BodyPart
    assert tfpose_tpu_torch.Human is Human
    assert ops.__all__ == jax_ops.__all__
    for name in jax_ops.__all__:
        assert getattr(ops, name).__name__ == f"tfpose_tpu_torch.ops.{name}"


# ---------------------------------------------------------------------------
# device_preprocess
# ---------------------------------------------------------------------------

def test_prepare_bilinear_matches_jax_prepare():
    img = np.random.default_rng(1).integers(0, 256, (2, 203, 245, 3),
                                            np.uint8)
    for hw in ((160, 160), (368, 432), (203, 245)):
        got = prepare_bilinear(torch.from_numpy(img), *hw).numpy()
        want = np.asarray(jax_prepare(jnp.asarray(img), *hw))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_device_preprocess_humans_equal_jax():
    """A 240x200 scene resized bilinearly to 160x160 on the device:
    humans and maps equal the JAX estimator's with the same option; the
    default resize (cv2's INTER_AREA numerics) gives other maps."""
    kw = dict(target_size=(160, 160), params_path=_THIN160,
              device_preprocess=True)
    jax_est = JaxEstimator("mobilenet_thin", **kw)
    est = TfPoseEstimator("mobilenet_thin", device="cpu", **kw)
    for img in _scenes(2, 200, 240, seed=5):
        want = jax_est.inference(img, upsample_size=4.0)
        got = est.inference(img, upsample_size=4.0)
        assert got
        _assert_same_humans(got, want)
        np.testing.assert_allclose(est.heatMat, jax_est.heatMat, rtol=0,
                                   atol=1e-5)
        bilinear = est.heatMat
        est.device_preprocess = False
        est.inference(img, upsample_size=4.0)
        est.device_preprocess = True
        assert np.abs(est.heatMat - bilinear).max() > 1e-3


# ---------------------------------------------------------------------------
# the batched evaluation sweep
# ---------------------------------------------------------------------------

def _assert_same_detections(got, want):
    """Same images and detections; keypoints within 1e-4 px (coords 1e-6
    of 160), scores 1e-5."""
    assert [d["image_id"] for d in got] == [d["image_id"] for d in want]
    for g, w in zip(got, want):
        assert g["category_id"] == w["category_id"]
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], rtol=0,
                                   atol=1e-4)
        assert abs(g["score"] - w["score"]) <= 1e-5


def test_batched_evaluator_matches_jax_fp32():
    """``run_batch`` and ``evaluate`` against the JAX evaluator in fp32,
    both with the committed ``thin160_coco`` variables: a batch of 4 at
    the network size, then 5 images of 320x320 in batches of 4 (halved
    to the network, where the port's area resize equals cv2's; the tail
    padded with zero images whose results are dropped)."""
    jax_ev = JaxEvaluator("mobilenet_thin", (160, 160), batch_size=4,
                          dtype="float32")
    ev = BatchedEvaluator("mobilenet_thin", (160, 160), batch_size=4,
                          dtype="float32", device="cpu")
    jax_ev.load_params(_THIN160)
    ev.load_params(_THIN160)
    imgs = np.stack(_scenes(4, 160, 160, seed=13))
    got = ev.run_batch(imgs)
    assert sum(len(h) for h in got) >= 4
    for g, w in zip(got, jax_ev.run_batch(imgs)):
        _assert_same_humans(g, w)
    np.testing.assert_array_equal(ev.last_peak_saturated,
                                  jax_ev.last_peak_saturated)
    big = _scenes(5, 320, 320, seed=14)
    items = [(10 + i, img, (320, 320)) for i, img in enumerate(big)]
    got, want = ev.evaluate(iter(items)), jax_ev.evaluate(iter(items))
    assert {d["image_id"] for d in got} >= {10, 14}  # the tail image too
    _assert_same_detections(got, want)


def test_sweep_evaluates_each_model():
    """``sweep`` on 3 rendered scenes with two backbones' seeded random
    weights (bf16, the evaluator's default): AP stats per model."""
    from tfpose_tpu_torch.evaluation.sweep import sweep

    items, gts = [], {}
    rng = np.random.default_rng(31)
    for idx in range(3):
        people = jax_synthetic.random_people(
            rng, 1, 64, 64, separated=True,
            template=jax_synthetic.SPREAD_TEMPLATE)
        items.append((idx, jax_synthetic.render_image(people, 64, 64, rng),
                      (64, 64)))
        gts[idx] = [coco_eval.person_to_gt(p) for p in people]
    out = sweep(["mobilenet_thin", "mobilenet_v2_small"], lambda: iter(items),
                gts, target_size=(64, 64), batch_size=2, device="cpu")
    assert set(out) == {"mobilenet_thin", "mobilenet_v2_small"}
    for stats in out.values():
        assert {"AP", "AP50"} <= set(stats)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(spatial=True)])
def test_batched_evaluator_rejects_mesh_and_spatial(kw):
    """A mesh that is no ``parallel.mesh.Mesh``, and ``spatial`` without
    a mesh, raise (``tests/test_torch_parallel_eval.py`` evaluates on
    meshes)."""
    with pytest.raises(ValueError, match="parallel.mesh.Mesh|needs a mesh"):
        BatchedEvaluator("mobilenet_thin", (64, 64), device="cpu", **kw)


# ---------------------------------------------------------------------------
# image loading and the CLIs
# ---------------------------------------------------------------------------

def test_imload_without_cv2_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import fails
    with pytest.raises(RuntimeError, match="cv2"):
        imload.read_imgfile(str(tmp_path / "x.png"))


def _jax_eval_main(argv):
    spec = importlib.util.spec_from_file_location(
        "eval_cli_jax", os.path.join(os.path.dirname(__file__), "..",
                                     "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


@pytest.mark.parametrize("argv", [
    ["--synthetic-e2e", "3", "--resize", "160x160", "--params", _THIN160],
    ["--synthetic", "3"],
])
def test_eval_cli_matches_jax(argv):
    """``eval --synthetic-e2e`` (the estimator on rendered scenes) and
    ``eval --synthetic`` (the decode on rendered maps): the same stats
    as the JAX ``eval.py``; AP exact, mean deviation 1e-5 px."""
    want = _jax_eval_main(list(argv))
    got = eval_cli.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=0, abs=1e-5), k
    assert got["AP50"] > 0.5
    with pytest.raises(SystemExit, match="AP50 gate"):
        eval_cli.main(argv + ["--device", "cpu", "--assert-ap50", "1.01"])


def test_eval_cli_quantize_is_not_ported():
    """``eval --quantize`` runs the int8 backbone (ROADMAP A12): a
    rendered 64x64 scene through the int8 estimator with random weights,
    calibrated on rendered scenes, gives the statistics' keys and no
    human. Its numbers against the JAX
    ``eval.py --quantize`` are ``tests/test_torch_quantize.py``'s."""
    stats = eval_cli.main(["--synthetic-e2e", "1", "--resize", "64x64",
                           "--quantize", "--device", "cpu"])
    assert {"AP", "AP50", "matched_humans"} <= stats.keys()
    assert stats["AP50"] == 0.0


def test_run_cli_on_an_image_file(tmp_path, monkeypatch):
    """``run`` on a PNG written with cv2, with ``thin160_coco`` as the
    model directory's ``mobilenet_thin`` checkpoint: the estimator's
    humans on the decoded image, and the annotated image written to
    ``--output``."""
    cv2 = pytest.importorskip("cv2")
    ckpt_dir = tmp_path / "models" / "jax" / "mobilenet_thin"
    ckpt_dir.mkdir(parents=True)
    (ckpt_dir / "params.msgpack").symlink_to(os.path.abspath(_THIN160))
    monkeypatch.setenv("TFPOSE_TPU_MODEL_DIR", str(tmp_path / "models"))
    img = _scenes(1, 320, 320, seed=23)[0]
    path, out = str(tmp_path / "scene.png"), str(tmp_path / "out.png")
    assert cv2.imwrite(path, img)
    humans = run_cli.main(["--image", path, "--resize", "160x160",
                           "--output", out, "--device", "cpu"])
    assert humans
    est = TfPoseEstimator("mobilenet_thin", target_size=(160, 160),
                          device="cpu")
    _assert_same_humans(humans, est.inference(img, upsample_size=4.0))
    drawn = cv2.imread(out)
    assert drawn.shape == img.shape and (drawn != img).any()


def test_run_video_cli_on_a_video_file(tmp_path):
    """``run_video`` on a short MJPG video written with cv2: every frame
    through the pipeline and into ``--output``."""
    cv2 = pytest.importorskip("cv2")
    path, out = str(tmp_path / "in.avi"), str(tmp_path / "out.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (96, 80))
    for img in _scenes(3, 80, 96, seed=29):
        writer.write(img)
    writer.release()
    run_video_cli.main(["--video", path, "--model", "mobilenet_thin",
                        "--resize", "96x80", "--output", out,
                        "--device", "cpu", "--depth", "2"])
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 3
