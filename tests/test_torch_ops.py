"""Port parity per op: each of the port's decode ops against its JAX
function on the same seeded numpy inputs (both on the CPU)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxParams
from tfpose_tpu.ops import assemble as j_assemble
from tfpose_tpu.ops import gaussian as j_gaussian
from tfpose_tpu.ops import nms as j_nms
from tfpose_tpu.ops import paf as j_paf
from tfpose_tpu.ops import resize as j_resize
from tfpose_tpu.pipeline import preprocess as j_pre
from tfpose_tpu.utils import synthetic
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.ops import assemble, gaussian, nms, paf, resize
from tfpose_tpu_torch.ops.kernels.smooth_nms import blur_in_tap_order
from tfpose_tpu_torch.pipeline import preprocess

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape,out", [((46, 54, 19), (184, 216)),
                                       ((2, 10, 12, 5), (40, 24)),
                                       ((46, 54, 7), (100, 130)),
                                       ((13, 11, 3), (5, 7))])
def test_resize_area(shape, out):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref = _np(j_resize.resize_area(jnp.asarray(x), *out))
    got = resize.resize_area(_t(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((80, 96, 3), (368, 432)),
                                       ((200, 300, 3), (80, 96)),
                                       ((1, 9, 7, 2), (1, 3))])
def test_resize_bilinear(shape, out):
    x = np.random.default_rng(1).uniform(-0.5, 0.5, shape).astype(np.float32)
    ref = _np(j_resize.resize_bilinear(jnp.asarray(x), *out))
    got = resize.resize_bilinear(_t(x), *out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_normalize():
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    np.testing.assert_array_equal(
        preprocess.normalize(_t(img)).numpy(),
        _np(j_pre.normalize(jnp.asarray(img))))


def _photo(seed, h, w):
    """A rendered scene with pixel noise: texture at every scale."""
    rng = np.random.default_rng(seed)
    people = synthetic.random_people(rng, 2, h, w, separated=True,
                                     template=synthetic.SPREAD_TEMPLATE)
    img = synthetic.render_image(people, h, w, rng).astype(np.int16)
    img += rng.integers(-20, 21, img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h, w, max_share", [(736, 864, 0.0),
                                             (552, 648, 0.0),
                                             (720, 1280, 1e-4)])
def test_downscale_area_matches_cv2_inter_area(h, w, max_share):
    """The JAX estimator shrinks frames on the host with cv2.INTER_AREA;
    the port's area average rounded half up equals it bit for bit at
    864x736 and 648x552 -> 432x368, and at 1280x720 differs by at most
    one grey level on at most 1e-4 of the values (sums within an ulp of
    .5)."""
    img = _photo(h, h, w)
    want = cv2.resize(img, (432, 368), interpolation=cv2.INTER_AREA)
    got = preprocess.downscale_area(_t(img), 368, 432).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= max_share
    np.testing.assert_array_equal(
        preprocess.prepare(_t(img[None]), 368, 432).numpy()[0],
        preprocess.normalize(_t(got)).numpy())


@pytest.mark.parametrize("h, w, oh, ow", [
    (480, 640, 160, 160), (480, 640, 240, 320), (480, 640, 96, 128),
    (480, 640, 480, 160), (72, 90, 8, 9), (736, 864, 368, 432)])
def test_downscale_area_at_integer_factors_equals_cv2(h, w, oh, ow):
    """At integer factors cv2.INTER_AREA takes its fast path: the int
    block sum, (sum + 2) >> 2 at 2 x 2, else sum * float(1/area) rounded
    half to even; the port equals it bit for bit (a 640x480 photo to
    160x160, 3 x 4, rounded half up, differed in 374 of 76800 values)."""
    img = _photo(h + w, h, w)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(
        preprocess.downscale_area(_t(img), oh, ow).numpy(), want)
    np.testing.assert_array_equal(
        preprocess.downscale_area(_t(np.stack([img, img[::-1]])), oh,
                                  ow).numpy()[1],
        cv2.resize(img[::-1], (ow, oh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("h, w, oh, ow", [
    (60, 70, 80, 96), (300, 250, 368, 432), (37, 41, 368, 432),
    (367, 431, 368, 432), (1, 1, 5, 3),           # enlarging
    (500, 300, 368, 432), (200, 600, 368, 432),   # mixed
    (368, 300, 368, 432), (100, 432, 368, 432),   # one axis kept
    (123, 77, 200, 91), (7, 5, 13, 11)])          # odd sizes
def test_resize_area_u8_matches_cv2_inter_area(h, w, oh, ow):
    """Where the image does not shrink on both axes, cv2.INTER_AREA is
    cv2's linear rule with area weights in 11-bit fixed point: the port
    equals it byte for byte, also through ``prepare``."""
    img = _photo(h + w, h, w)
    want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
    got = resize.resize_area_u8(_t(img), oh, ow).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        preprocess.prepare(_t(img[None]), oh, ow).numpy()[0],
        preprocess.normalize(_t(want)).numpy())


def test_resize_area_u8_matches_cv2_on_random_shapes():
    """200 random shapes up to 120x160 that enlarge on at least one axis,
    with 1, 3 or 4 channels and a batch axis: byte for byte."""
    rng = np.random.default_rng(11)
    n = 0
    while n < 200:
        h, w, oh, ow = (int(v) for v in rng.integers(1, (120, 120, 160, 160)))
        if oh <= h and ow <= w:
            continue
        c = int(rng.choice([1, 3, 4]))
        imgs = rng.integers(0, 256, (2, h, w, c), np.uint8)
        got = resize.resize_area_u8(_t(imgs), oh, ow).numpy()
        for img, g in zip(imgs, got):
            want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(g, want.reshape(oh, ow, c))
        n += 1


def test_gauss_kernel_and_smooth():
    np.testing.assert_array_equal(gaussian.gauss_kernel_1d(25, 3.0),
                                  j_gaussian.gauss_kernel_1d(25, 3.0))
    x = np.random.default_rng(3).normal(size=(2, 46, 54, 19)).astype(
        np.float32)
    ref = _np(j_gaussian.smooth(jnp.asarray(x)))
    for img, want in zip(x, ref):  # the port's blur: (C, H, W) in tap order
        got = blur_in_tap_order(_t(img).permute(2, 0, 1)).permute(1, 2, 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_nms_keeps_ge_local_maxima():
    x = np.random.default_rng(4).normal(size=(30, 40, 5)).astype(np.float32)
    x[3:6, 3:6, 0] = 2.0  # a plateau: every cell >= its pooled max
    ref = _np(j_nms.nms(jnp.asarray(x)))
    got = nms.nms(_t(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[3:6, 3:6, 0] == 2.0).all()


def test_top_peaks_ties_to_lower_index():
    rng = np.random.default_rng(5)
    plane = np.zeros((20, 24, 19), np.float32)
    plane[rng.integers(0, 20, 60), rng.integers(0, 24, 60), :] = 0.5
    plane[rng.integers(0, 20, 10), rng.integers(0, 24, 10), :] = 0.9
    ref = j_nms.top_peaks(jnp.asarray(plane), 32, 0.05)
    got = nms.top_peaks(_t(plane), 32, 0.05)
    for name in ("x", "y", "score", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), err_msg=name)


def _scene_peaks(seed, n_people, k=32):
    net, _ = synthetic.render_scene(np.random.default_rng(seed), n_people,
                                    46, 54)
    heat_up = j_resize.resize_area(jnp.asarray(net[..., :19]), 184, 216)
    pm = j_nms.nms(j_gaussian.smooth(heat_up))
    pk = j_nms.top_peaks(pm, k, 0.05)
    paf_up = j_resize.resize_area(jnp.asarray(net[..., 19:]), 184, 216)
    return pk, paf_up


def _port_peaks(pk):
    return nms.Peaks(*(_t(a) for a in pk))


@pytest.mark.parametrize("seed,n_people", [(0, 3), (1, 1), (2, 6)])
def test_score_candidates_gather(seed, n_people):
    pk, paf_up = _scene_peaks(seed, n_people)
    ref = j_paf.score_candidates(pk, paf_up, JaxParams())
    got = paf.score_candidates(_port_peaks(pk), _t(paf_up), DecodeParams())
    np.testing.assert_array_equal(got.ok.numpy(), _np(ref.ok))
    np.testing.assert_allclose(got.score.numpy(), _np(ref.score),
                               rtol=0, atol=1e-5)
    assert got.ok.sum() > 0 or n_people == 0


def _random_cands(seed, k=16):
    rng = np.random.default_rng(seed)
    score = rng.uniform(-1, 1, (19, k, k)).astype(np.float32)
    score[0, :4, :4] = 0.5  # planted ties: the first maximum wins
    ok = rng.uniform(size=(19, k, k)) > 0.4
    return score, ok


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_connections(seed):
    score, ok = _random_cands(seed)
    ref = j_paf.greedy_connections(
        j_paf.Candidates(jnp.asarray(score), jnp.asarray(ok)), JaxParams())
    got = paf.greedy_connections(
        paf.Candidates(_t(score), _t(ok)), DecodeParams())
    for name in ("a_slot", "b_slot", "score", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), err_msg=name)
    # batched: two images at once give the per-image results
    both = paf.greedy_connections(paf.Candidates(
        _t(np.stack([score, score[::-1]])), _t(np.stack([ok, ok[::-1]]))),
        DecodeParams())
    np.testing.assert_array_equal(both.a_slot[0].numpy(), got.a_slot.numpy())


@pytest.mark.parametrize("seed,n_people", [(0, 3), (2, 6), (7, 0), (9, 9)])
def test_assemble_dense(seed, n_people):
    params = JaxParams()
    pk, paf_up = _scene_peaks(seed, n_people)
    conns = j_paf.greedy_connections(
        j_paf.score_candidates(pk, paf_up, params), params)
    ref = j_assemble.assemble_dense(pk, conns, params)
    got = assemble.assemble_dense(
        _port_peaks(pk), paf.Connections(*(_t(a) for a in conns)),
        DecodeParams())
    for name in ("part_valid", "human_valid", "peak_saturated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(got.coords.numpy(), _np(ref.coords))
    for name in ("part_scores", "human_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   _np(getattr(ref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert int(got.human_valid.sum()) >= min(n_people, 1)
