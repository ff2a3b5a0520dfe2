"""Port parity for windowed and multi-scale inference: the port's
``pipeline/multiscale.py`` against ``tfpose_tpu/pipeline/multiscale.py``
(window grids, merge weights, the merge, edge padding of non-stride
images, the multi-scale average), and the estimator's
``inference_windowed`` / ``inference_multiscale`` against the JAX
estimator on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.pipeline import multiscale as j_ms
from tfpose_tpu.pipeline.preprocess import normalize as j_normalize
from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.ops import decode
from tfpose_tpu_torch.pipeline import multiscale as ms
from tfpose_tpu_torch.utils import synthetic

torch.set_num_threads(2)

_THIN368 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin368_coco", "params.msgpack")


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


@pytest.mark.parametrize("img_h, img_w, win_h, win_w, overlap", [
    (720, 1280, 368, 432, 0.2), (1080, 1920, 368, 432, 0.2),
    (104, 200, 48, 48, 0.2), (40, 40, 48, 64, 0.2),
    (160, 200, 80, 96, 0.5)])
def test_window_grid_matches_jax(img_h, img_w, win_h, win_w, overlap):
    got = ms.generate_windows(img_h, img_w, win_h, win_w, overlap)
    want = j_ms.generate_windows(img_h, img_w, win_h, win_w, overlap)
    np.testing.assert_array_equal(got.origins, want.origins)
    assert tuple(got)[1:] == tuple(want)[1:]
    with pytest.raises(ValueError, match="stride"):
        ms.generate_windows(img_h + 3, img_w, win_h, win_w)


def test_merge_weights_and_merge_match_jax():
    """The 12 windows of a 1280x720 frame: weights bit for bit, the
    merged stride-8 map within 1e-6 (the same order of window adds)."""
    grid = ms.generate_windows(720, 1280, 368, 432)
    j_grid = j_ms.generate_windows(720, 1280, 368, 432)
    key = (tuple(map(tuple, grid.origins.tolist())), 368, 432, 720, 1280)
    np.testing.assert_array_equal(ms._merge_weights(key),
                                  j_ms._merge_weights(key))
    maps = np.random.default_rng(0).normal(
        size=(12, 46, 54, 57)).astype(np.float32)
    got = ms.merge_maps(torch.from_numpy(maps), grid, out_scale=1.0 / 8.0)
    want = j_ms.merge_maps(jnp.asarray(maps), j_grid, out_scale=1.0 / 8.0)
    assert got.shape == (90, 160, 57)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _pool_j(wins):  # a stand-in network: normalize, stride-8 mean pool
    n, h, w, c = wins.shape
    return j_normalize(wins).reshape(n, h // 8, 8, w // 8, 8, c).mean((2, 4))


def _pool_t(wins):
    n, h, w, c = wins.shape
    x = wins.float() / 256.0 - 0.5
    return x.reshape(n, h // 8, 8, w // 8, 8, c).mean((2, 4))


@pytest.mark.parametrize("img_h, img_w", [(203, 157), (100, 99), (160, 200)])
def test_windowed_forward_pads_like_jax(img_h, img_w):
    """Non-stride (and smaller-than-window) uint8 images are padded by
    edge replication before windowing; merged maps within 1e-6."""
    img = np.random.default_rng(img_h).integers(0, 256, (img_h, img_w, 3),
                                                dtype=np.uint8)
    padded = ms.pad_edge(torch.from_numpy(img), img_h + 13, img_w + 5)
    np.testing.assert_array_equal(
        padded.numpy(), np.pad(img, ((0, 13), (0, 5), (0, 0)), mode="edge"))
    got = ms.windowed_forward(_pool_t, torch.from_numpy(img), 96, 80)
    want = j_ms.windowed_forward(_pool_j, jnp.asarray(img), 96, 80)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_multiscale_forward_matches_jax():
    """Scales (1.0, 1.5, 0.7) of a 200x160 uint8 image: the scaled image
    stays float, per-scale maps are area-resampled to the base grid and
    averaged; within 1e-6."""
    img = np.random.default_rng(5).integers(0, 256, (200, 160, 3),
                                            dtype=np.uint8)
    scales = (1.0, 1.5, 0.7)
    got = ms.multiscale_forward(_pool_t, torch.from_numpy(img), 96, 80,
                                scales)
    want = j_ms.multiscale_forward(_pool_j, jnp.asarray(img), 96, 80, scales)
    assert got.shape == (25, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _spy_full_res_topk(monkeypatch):
    calls = []
    orig = decode.smooth_nms_topk

    def spy(heat, *args, **kwargs):
        calls.append(tuple(heat.shape))
        return orig(heat, *args, **kwargs)

    monkeypatch.setattr(decode, "smooth_nms_topk", spy)
    return calls


def test_inference_windowed_1280x720_thin368(monkeypatch):
    """One rendered 1280x720 frame, 12 windows of 432x368 with the
    committed thin368_coco weights, decoded at 4x (360x640, through the
    full-resolution top-K): the JAX estimator's humans."""
    rng = np.random.default_rng(11)
    people = synthetic.random_people(rng, 3, 720, 1280, separated=True,
                                     template=synthetic.SPREAD_TEMPLATE)
    img = synthetic.render_image(people, 720, 1280, rng)
    jax_est = JaxEstimator("mobilenet_thin", target_size=(432, 368),
                           params_path=_THIN368)
    est = TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                          params_path=_THIN368, device="cpu")
    calls = _spy_full_res_topk(monkeypatch)
    got = est.inference_windowed(img, upsample_size=4.0)
    assert calls == [(360, 640, 18)]
    assert len(got) == 3
    _assert_same_humans(got, jax_est.inference_windowed(img,
                                                        upsample_size=4.0))
    np.testing.assert_array_equal(est.last_peak_saturated,
                                  jax_est.last_peak_saturated)


@pytest.fixture(scope="module")
def small_pair():
    """96x80 estimators sharing the JAX estimator's random-init weights,
    a 200x160 image, and both sides' merged maps at scales (1.0, 1.5)."""
    jax_est = JaxEstimator("mobilenet_thin", target_size=(96, 80))
    est = TfPoseEstimator("mobilenet_thin", target_size=(96, 80),
                          device="cpu")
    variables_from_numpy(est.net, jax.tree.map(np.asarray, jax_est.variables))
    img = np.random.default_rng(3).integers(0, 256, (160, 200, 3),
                                            dtype=np.uint8)
    merged = ms.multiscale_forward(est._forward_windows,
                                   torch.from_numpy(img), 80, 96, (1.0, 1.5))
    j_merged = jax.jit(lambda v, im: j_ms.multiscale_forward(
        lambda w: jax_est.net.apply(v, j_normalize(w),
                                    train=False)["concat_stage7"],
        im, 80, 96, (1.0, 1.5)))(jax_est.variables, jnp.asarray(img))
    return jax_est, est, img, merged.numpy(), np.asarray(j_merged)


@pytest.mark.parametrize("upsample", [2.0, 2.5])
def test_inference_multiscale_random_init(small_pair, upsample):
    """96x80 windows with the JAX estimator's random-init weights carried
    over, on a 200x160 image at scales (1.0, 1.5): merged maps within
    1e-5 of their largest value (random-init outputs are ~1e-3; measured
    1.4e-6 of it), and the same humans and saturation."""
    jax_est, est, img, merged, j_merged = small_pair
    assert merged.shape == (20, 25, 57)
    np.testing.assert_allclose(merged, j_merged, rtol=0,
                               atol=1e-5 * np.abs(j_merged).max())
    got = est.inference_multiscale(img, scales=(1.0, 1.5),
                                   upsample_size=upsample)
    want = jax_est.inference_multiscale(img, scales=(1.0, 1.5),
                                        upsample_size=upsample)
    _assert_same_humans(got, want)
    np.testing.assert_array_equal(est.last_peak_saturated,
                                  jax_est.last_peak_saturated)
