"""The slice end to end: the port's ``TfPoseEstimator(device="cpu")``
against the JAX ``TfPoseEstimator`` on the CPU — mobilenet_thin at
432x368 with the committed thin368_coco weights (at 4x, at the
non-integer 2.5x that decodes through the full-resolution top-K, on an
image to downscale, and through the multi-scale path), and at 96x80 with
the JAX estimator's random-init weights carried over."""

import os

import jax
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxParams
from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.ops import decode
from tfpose_tpu_torch.utils import synthetic

torch.set_num_threads(2)

_THIN368 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin368_coco", "params.msgpack")


def _scenes(n, h, w, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 4)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, h, w, rng))
    return out


def _assert_same_humans(got, want):
    """Same humans and part sets; coords 1e-6, scores 1e-5."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.body_parts.keys() == w.body_parts.keys()
        assert abs(g.score - w.score) <= 1e-5
        for p, bp in g.body_parts.items():
            wp = w.body_parts[p]
            assert abs(bp.x - wp.x) <= 1e-6 and abs(bp.y - wp.y) <= 1e-6
            assert abs(bp.score - wp.score) <= 1e-5


def _spy_escalation(est):
    """Record every _should_escalate decision of an estimator."""
    seen = []
    orig = est._should_escalate

    def spy(sat):
        seen.append(orig(sat))
        return seen[-1]

    est._should_escalate = spy
    return seen


@pytest.fixture(scope="module")
def thin368():
    jax_est = JaxEstimator("mobilenet_thin", target_size=(432, 368),
                           params_path=_THIN368)
    est = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                          params_path=_THIN368, device="cpu")
    return jax_est, est, _scenes(2, 368, 432)


def test_inference_432x368_thin368(thin368):
    jax_est, est, imgs = thin368
    for img in imgs:
        want = jax_est.inference(img, upsample_size=4.0)
        got = est.inference(img, upsample_size=4.0)
        assert len(got) > 0
        _assert_same_humans(got, want)
        assert est.heatMat.shape == (184, 216, 19)
        assert est.pafMat.shape == (184, 216, 38)
        # the maps are the backbone output upsampled, so they carry the
        # backbone's fp32 tolerance at this size (atol 1e-4); measured
        # max |d| 1.5e-5
        np.testing.assert_allclose(est.heatMat, jax_est.heatMat, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(est.pafMat, jax_est.pafMat, rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(est.last_peak_saturated,
                                      jax_est.last_peak_saturated)


def test_inference_batch_432x368_thin368(thin368):
    jax_est, est, imgs = thin368
    want = jax_est.inference_batch(imgs, upsample_size=4.0)
    got = est.inference_batch(imgs, upsample_size=4.0)
    assert [len(h) for h in got] == [len(h) for h in want]
    for g, w in zip(got, want):
        _assert_same_humans(g, w)


def _spy_full_res_topk(monkeypatch):
    calls = []
    orig = decode.smooth_nms_topk

    def spy(heat, *args, **kwargs):
        calls.append(tuple(heat.shape))
        return orig(heat, *args, **kwargs)

    monkeypatch.setattr(decode, "smooth_nms_topk", spy)
    return calls


def test_inference_batch_at_a_non_integer_upsample(thin368, monkeypatch):
    """Upsample 2.5: both scenes' heat decodes at 115x135 in one
    full-resolution top-K call; the JAX estimator's humans."""
    jax_est, est, imgs = thin368
    calls = _spy_full_res_topk(monkeypatch)
    got = est.inference_batch(imgs, upsample_size=2.5)
    assert calls == [(115, 135, 2 * 18)]
    want = jax_est.inference_batch(imgs, upsample_size=2.5)
    assert [len(h) for h in got] == [len(h) for h in want]
    assert sum(len(h) for h in got) > 0
    for g, w in zip(got, want):
        _assert_same_humans(g, w)


def test_inference_downscales_an_864x736_image_like_jax(thin368):
    """An image twice the target size: the port area-downscales it on the
    device to uint8, which equals the JAX estimator's ``cv2.INTER_AREA``
    at this factor; the same humans."""
    jax_est, est, _ = thin368
    img = _scenes(1, 736, 864, seed=9)[0]
    got = est.inference(img, resize_to_default=True, upsample_size=4.0)
    assert len(got) > 0
    _assert_same_humans(got, jax_est.inference(img, resize_to_default=True,
                                               upsample_size=4.0))


def test_inference_enlarges_a_300x250_image_like_jax(thin368):
    """An image smaller than the network on both axes: the port resizes
    it on the device as ``cv2.INTER_AREA`` does (the JAX estimator's host
    resize), byte for byte; the same humans."""
    jax_est, est, _ = thin368
    img = _scenes(1, 300, 250, seed=5)[0]
    got = est.inference(img, resize_to_default=True, upsample_size=4.0)
    assert len(got) > 0
    _assert_same_humans(got, jax_est.inference(img, resize_to_default=True,
                                               upsample_size=4.0))


def test_inference_multiscale_432x368_thin368(thin368):
    """Scales (1.0, 1.5) of a 432x368 scene: one window, then four of
    the 648x552 image, averaged on the 46x54 grid and decoded at 2.5x;
    the JAX estimator's humans."""
    jax_est, est, imgs = thin368
    got = est.inference_multiscale(imgs[0], scales=(1.0, 1.5),
                                   upsample_size=2.5)
    assert len(got) > 0
    _assert_same_humans(got, jax_est.inference_multiscale(
        imgs[0], scales=(1.0, 1.5), upsample_size=2.5))


def test_escalation_taken_on_the_same_inputs(thin368):
    """With a peak cap of 1 every scene saturates; both estimators must
    escalate (to K=4) and give the same humans."""
    jax_est, est, imgs = thin368
    small = dict(max_peaks=1, escalated_max_peaks=4, max_humans=4,
                 escalated_max_humans=8)
    jax_est.decode_params = JaxParams(**small)
    jax_est._jit_cache = {}  # its pipelines are keyed without the params
    est.decode_params = DecodeParams(**small)
    seen_j, seen_t = _spy_escalation(jax_est), _spy_escalation(est)
    for img in imgs:
        _assert_same_humans(est.inference(img, upsample_size=4.0),
                            jax_est.inference(img, upsample_size=4.0))
    assert seen_t == seen_j and all(seen_t)


@pytest.fixture(scope="module")
def small_pair():
    jax_est = JaxEstimator("mobilenet_thin", target_size=(96, 80))
    est = TfPoseEstimator("mobilenet_thin", target_size=(96, 80),
                          device="cpu")
    variables_from_numpy(est.net, jax.tree.map(np.asarray, jax_est.variables))
    return jax_est, est


def test_inference_96x80_carried_over_random_init(small_pair):
    jax_est, est = small_pair
    imgs = [np.random.default_rng(s).integers(0, 255, (80, 96, 3), np.uint8)
            for s in (0, 1)]
    for img in imgs:
        want = jax_est.inference(img, resize_to_default=False,
                                 upsample_size=4.0)
        got = est.inference(img, resize_to_default=False, upsample_size=4.0)
        _assert_same_humans(got, want)
        np.testing.assert_allclose(est.heatMat, jax_est.heatMat, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(est.pafMat, jax_est.pafMat, rtol=0,
                                   atol=1e-5)
    got = est.inference_batch(imgs, upsample_size=4.0)
    want = jax_est.inference_batch(imgs, upsample_size=4.0)
    for g, w in zip(got, want):
        _assert_same_humans(g, w)


def test_inference_resizes_input_on_the_device(small_pair):
    _, est = small_pair
    humans = est.inference(np.zeros((200, 300, 3), np.uint8),
                           resize_to_default=True, upsample_size=2.0)
    assert isinstance(humans, list)
    assert est.heatMat.shape == (80 // 8 * 2, 96 // 8 * 2, 19)
    assert est.pafMat.shape[2] == 38
    out = est.inference_batch([np.zeros((80, 96, 3), np.uint8),
                               np.zeros((60, 70, 3), np.uint8)],
                              upsample_size=2.0)
    assert len(out) == 2
    with pytest.raises(Exception):
        est.inference(None)


def test_draw_humans_and_warmup(small_pair):
    _, est = small_pair
    img = _scenes(1, 368, 432)[0]
    big = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                          params_path=_THIN368, device="cpu", warmup=True)
    humans = big.inference(img, upsample_size=4.0)
    assert humans
    out = TfPoseEstimator.draw_humans(img, humans, imgcopy=True)
    assert out.shape == img.shape and (out != img).any()
    assert (img == _scenes(1, 368, 432)[0]).all()  # imgcopy kept the input


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TfPoseEstimator("mobilenet_thin", target_size=(96, 80))
