"""Port parity for the kernel modules: each kernel's plain PyTorch
version (what the wrapper runs on a CPU tensor) against the Pallas TPU
kernel it replaces, run in interpret mode on the CPU."""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxParams
from tfpose_tpu.ops import nms as j_nms
from tfpose_tpu.ops import paf as j_paf
from tfpose_tpu.ops import resize as j_resize
from tfpose_tpu.ops.pallas.paf_score import HPAD, paf_sample_scores_pallas
from tfpose_tpu.ops.pallas.smooth_nms import (
    can_use_phase_kernel as j_can_use_phase_kernel,
)
from tfpose_tpu.ops.pallas.smooth_nms import (
    smooth_nms_pallas,
    smooth_nms_topk_pallas,
    smooth_nms_topk_raw_pallas,
)
from tfpose_tpu.utils import synthetic
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import pairs_array
from tfpose_tpu_torch.ops import nms
from tfpose_tpu_torch.ops.assemble import ASSEMBLE_ARGTYPES
from tfpose_tpu_torch.ops.kernels import build
from tfpose_tpu_torch.ops.kernels.bias_prelu import BIAS_PRELU_ARGTYPES
from tfpose_tpu_torch.ops.kernels.paf_score import (
    MAX_STEPS,
    SCORE_ARGTYPES,
    paf_sample_scores_plain,
    score_candidates_raw,
)
from torch_cases import k1_phase_reference
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    LIST_CAP,
    SMOOTH_NMS_ARGTYPES,
    TOPK_ARGTYPES,
    TOPK_RAW_ARGTYPES,
    MAX_K,
    MAX_TAPS,
    PHASE_ROUTE_FLOATS,
    _phase_range,
    can_use_phase_kernel,
    peak_lists,
    smooth_nms,
    smooth_nms_topk,
    smooth_nms_topk_raw,
    smooth_nms_topk_raw_plain,
)

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _heat8(seed, h8, w8, c, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":  # saturates K=32 at 4x
        return rng.normal(0, 0.3, (h8, w8, c)).astype(np.float32)
    net, _ = synthetic.render_scene(rng, 4, h8, w8)
    return np.ascontiguousarray(np.tile(net[..., :18], (1, 1, 2))[..., :c])


@pytest.mark.parametrize("f", [1, 2, 4])
@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("kind", ["scene", "noise"])
def test_smooth_nms_topk_raw_plain_vs_pallas(f, k, kind):
    """Indices exact; scores rtol 1e-5 (the plain version blurs the
    upsampled map, the kernel the phase planes: other sum orders)."""
    heat8 = _heat8(f + k, 46, 54, 4, kind)
    c = heat8.shape[2]
    s_ref, i_ref = smooth_nms_topk_raw_pallas(jnp.asarray(heat8), f, f, k,
                                              0.05, interpret=True)
    before = smooth_nms_topk_raw.launches
    s, i = smooth_nms_topk_raw(_t(heat8), f, f, k, 0.05)
    assert smooth_nms_topk_raw.launches == before  # CPU: no kernel launch
    assert s.shape == (c, k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=0)
    if kind == "noise" and (f, k) == (4, 32):
        assert (i.numpy() >= 0).all()  # every slot filled: saturated


def _heat_up(seed, h, w, c, kind):
    """An upsampled heat map as decode sees it: a rendered scene's part
    planes area-resized to (h, w), or noise drawn at (h, w) itself around
    a level above the threshold (a peak every few pixels)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.normal(0.1, 0.3, (h, w, c)).astype(np.float32)
    net, _ = synthetic.render_scene(rng, 4, 46, 54)
    return np.asarray(j_resize.resize_area(jnp.asarray(net[..., :c]), h, w))


@pytest.mark.parametrize("shape", [(115, 135, 18), (72, 128, 18)])
@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("kind", ["scene", "noise"])
def test_smooth_nms_topk_plain_vs_pallas(shape, k, kind):
    """Indices exact, scores atol 1e-6 (the plain version sums the taps
    in the Pallas kernel's order; XLA on the CPU may fuse a multiply-add,
    which moves a score by an ulp or so)."""
    heat = _heat_up(k + shape[0], *shape, kind)
    s_ref, i_ref = smooth_nms_topk_pallas(jnp.asarray(heat), k, 0.05,
                                          interpret=True)
    before = smooth_nms_topk.launches
    s, i = smooth_nms_topk(_t(heat), k, 0.05)
    assert smooth_nms_topk.launches == before  # CPU: no kernel launch
    assert s.shape == (shape[2], k) and i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=1e-6)
    assert (i.numpy() >= 0).sum() > 0
    if kind == "noise" and k == 32:
        assert (i.numpy() >= 0).all(1).any()  # a plane saturates K


def test_smooth_nms_topk_plain_vs_pallas_on_a_plateau():
    """A plateau above the threshold makes every pixel of its interior a
    peak of equal score: the K kept are the lowest flat indices, on both
    sides. A second plane is all below the threshold: no peak, slots 0
    and -1."""
    heat = np.zeros((40, 48, 2), np.float32)
    heat[..., 0] = 0.5
    heat[..., 1] = 0.01
    s_ref, i_ref = smooth_nms_topk_pallas(jnp.asarray(heat), 32, 0.05,
                                          interpret=True)
    s, i = smooth_nms_topk(_t(heat), 32, 0.05)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0,
                               atol=1e-6)
    assert (np.diff(i.numpy()[0]) > 0).all() and len(set(s.numpy()[0])) == 1
    assert (i.numpy()[1] == -1).all() and (s.numpy()[1] == 0).all()


def _route_floats(h8, w8, fy, fx, kernlen=25):
    """The quantity the raw-grid route bounds: a plane's vertical phase
    sums plus both phase weight tables, in floats."""
    (dvmin, dvmax), (dhmin, dhmax) = (_phase_range(f, kernlen, kernlen // 2)
                                      for f in (fy, fx))
    nv, nh = dvmax - dvmin + 1, dhmax - dhmin + 1
    return fy * h8 * (w8 + nh - 1) + fy * nv + fx * nh


def _old_route(h8, w8, up_h, up_w, kernlen=25):
    """The route as it stood with the one-block-per-plane raw-grid kernel:
    integer factors 1..8 and that kernel's shared memory (2,048 keys, the
    vertical phase sums and the weights) within 232,448 bytes."""
    if h8 <= 0 or w8 <= 0 or up_h % h8 or up_w % w8:
        return False
    fy, fx = up_h // h8, up_w // w8
    if not (1 <= fy <= 8 and 1 <= fx <= 8):
        return False
    return 8 * 2048 + 4 * _route_floats(h8, w8, fy, fx, kernlen) <= 232448


@pytest.mark.parametrize("h8, w8, up_h, up_w", [
    (46, 54, 184, 216), (46, 54, 368, 432), (60, 80, 240, 320),
    (90, 160, 360, 640), (90, 160, 720, 1280), (46, 54, 115, 135),
    (46, 54, 92, 108), (135, 240, 540, 960)])
def test_phase_kernel_route_depends_on_shapes_only(h8, w8, up_h, up_w):
    """The raw-grid route needs an integer factor and planes within its
    size limit; where the port leaves it, the JAX package leaves it too
    or (720p at 4x) keeps it only through its larger VMEM budget."""
    ok = can_use_phase_kernel(h8, w8, up_h, up_w)
    if ok:
        assert j_can_use_phase_kernel(h8, w8, up_h, up_w)
        fy, fx = up_h // h8, up_w // w8
        assert _route_floats(h8, w8, fy, fx) <= PHASE_ROUTE_FLOATS
    assert ok == ((h8, w8, up_h, up_w) in {(46, 54, 184, 216),
                                           (46, 54, 368, 432),
                                           (60, 80, 240, 320),
                                           (46, 54, 92, 108)})


@pytest.mark.parametrize("f", range(1, 9))
def test_phase_route_equals_the_old_shared_memory_rule(f):
    """The explicit size limit routes every shape as the old kernel's
    shared-memory budget did: raw grids of 1..160 x 1..240 at factor f
    on both axes and (f, 3) and (3, f), and ratios that are no
    integer."""
    for h8 in (1, 5, 23, 46, 60, 90, 101, 135, 160):
        for w8 in (1, 7, 54, 80, 123, 160, 199, 240):
            for up_h, up_w in ((f * h8, f * w8), (f * h8, 3 * w8),
                               (3 * h8, f * w8), (f * h8 + 1, f * w8),
                               (f * h8, f * w8 - 1)):
                for kernlen in (25, 13):
                    assert (can_use_phase_kernel(h8, w8, up_h, up_w, kernlen)
                            == _old_route(h8, w8, up_h, up_w, kernlen))
    assert not can_use_phase_kernel(46, 54, 9 * 46, 9 * 54)


@pytest.mark.parametrize("shape", [(46, 54, 19), (184, 216, 19),
                                   (10, 12, 19), (22, 26, 19),
                                   (115, 135, 19)])
def test_smooth_nms_plain_vs_pallas(shape):
    """atol 1e-6, which also holds the nonzero mask (value >= its 3x3
    max) equal wherever the kept value exceeds 1e-6; at the main path's
    4x map, the 2.5x map and the three maps of the 432x368 warm-up."""
    h, w, _ = shape
    net, _ = synthetic.render_scene(np.random.default_rng(3), 3, h, w)
    rng = np.random.default_rng(4)
    heat = (net[..., :19] + rng.normal(0, 0.05, net[..., :19].shape)
            ).astype(np.float32)
    ref = np.asarray(smooth_nms_pallas(jnp.asarray(heat), interpret=True))
    got = smooth_nms(_t(heat)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got > 0.05).sum() > 0


@pytest.mark.parametrize("kernlen", [13, 4, 1])
def test_smooth_nms_plain_vs_pallas_other_blur_lengths(kernlen):
    """Blur lengths other than 25 (the kernel's run-time loops; an even
    one pads kernlen // 2 on each side as the JAX kernel does): atol 1e-6
    on a 22x26 map, smaller than the 25-tap blur's reach."""
    net, _ = synthetic.render_scene(np.random.default_rng(kernlen), 2, 22,
                                    26)
    heat = np.ascontiguousarray(net[..., :19])
    ref = np.asarray(smooth_nms_pallas(jnp.asarray(heat), kernlen,
                                       interpret=True))
    got = smooth_nms(_t(heat), kernlen).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got > 0.05).sum() > 0


@pytest.mark.parametrize("call, match", [
    (lambda x: smooth_nms(x, kernlen=0), "kernlen"),
    (lambda x: smooth_nms(x, kernlen=MAX_TAPS + 1), "kernlen"),
    (lambda x: smooth_nms(x[:, :, :0]), "empty"),
    (lambda x: smooth_nms(x[:0]), "empty")])
def test_smooth_nms_checks_its_limits_on_every_device(call, match):
    """The blur length (1..64) and a non-empty map are checked before a
    device is chosen, so the CPU raises where the card would."""
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(6, 7, 2))


def _paf_inputs(seed, p, k, h8, w8, s=10):
    rng = np.random.default_rng(seed)
    planes = rng.normal(0, 0.5, (p, 2, h8, w8)).astype(np.float32)
    kk = k * k
    iy = rng.integers(0, h8, (p, s, kk)).astype(np.int32)
    ix = rng.integers(0, w8, (p, s, kk)).astype(np.int32)
    ang = rng.uniform(0, 2 * np.pi, (p, 1, kk))
    vx = np.broadcast_to(np.cos(ang), (p, s, kk)).astype(np.float32)
    vy = np.broadcast_to(np.sin(ang), (p, s, kk)).astype(np.float32)
    nrows = rng.integers(0, kk // 128 + 1, p).astype(np.int32)
    nrows[0] = 0  # an all-invalid pair
    nrows[-1] = kk // 128
    return planes, iy, ix, vx, vy, nrows


def _pallas_planes(planes):
    """(P, 2, h8, w8) -> the Pallas layout (P, 2*wpad, HPAD)."""
    p, _, h8, w8 = planes.shape
    wpad = (w8 + 7) // 8 * 8
    t = np.zeros((p, 2, wpad, HPAD), np.float32)
    t[:, :, :w8, :h8] = planes.transpose(0, 1, 3, 2)
    return t.reshape(p, 2 * wpad, HPAD)


@pytest.mark.parametrize("k", [32, 16])
def test_paf_sample_scores_plain_vs_pallas(k):
    """cnt exact, mean atol 1e-6, rows at or beyond nrows zero."""
    planes, iy, ix, vx, vy, nrows = _paf_inputs(k, 6, k, 46, 54)
    kk = k * k
    kk_pad = -(-kk // 1024) * 1024  # the Pallas kernel's (8, 128) tiles
    pad = ((0, 0), (0, 0), (0, kk_pad - kk))
    m_ref, c_ref = paf_sample_scores_pallas(
        jnp.asarray(_pallas_planes(planes)), jnp.asarray(np.pad(iy, pad)),
        jnp.asarray(np.pad(ix, pad)), jnp.asarray(np.pad(vx, pad)),
        jnp.asarray(np.pad(vy, pad)), s_paf=10, thresh=0.05,
        nrows=jnp.asarray(nrows), interpret=True)
    m, c = paf_sample_scores_plain(_t(planes), _t(iy), _t(ix), _t(vx),
                                   _t(vy), _t(nrows), s_paf=10, thresh=0.05)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref)[:, :kk])
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref)[:, :kk],
                               rtol=0, atol=1e-6)
    assert (c.numpy()[0] == 0).all() and (m.numpy()[0] == 0).all()
    assert c.numpy()[-1].sum() > 0


def _jax_peaks(nets, k, f=4):
    """The JAX raw-grid top-K's peaks of each net (B, h8, w8, 57) at f x,
    as numpy arrays (x, y, score, valid)."""
    up_w = nets.shape[2] * f

    def peaks_of(net):
        s, i = smooth_nms_topk_raw_pallas(net[..., :18], f, f, k, 0.05,
                                          interpret=True)
        i = jnp.maximum(i, 0)
        return j_nms.Peaks(x=i % up_w, y=i // up_w, score=s, valid=s > 0.05)

    return [np.array(a) for a in jax.vmap(peaks_of)(jnp.asarray(nets))]


def _people_peaks(people, k, f=4):
    """Peaks (1, 18, K) at the people's parts, scaled to the f x grid,
    valid in a prefix of each part's slots: the raw-grid top-K's layout
    without running it (a 90x160 plane at 4x)."""
    x = np.zeros((1, 18, k), np.int32)
    y = np.zeros_like(x)
    valid = np.zeros((1, 18, k), bool)
    for part in range(18):
        pts = people[:, part]
        pts = pts[~np.isnan(pts).any(1)][:k]
        x[0, part, :len(pts)] = np.round(pts[:, 0] * f + f // 2)
        y[0, part, :len(pts)] = np.round(pts[:, 1] * f + f // 2)
        valid[0, part, :len(pts)] = True
    return [x, y, valid.astype(np.float32), valid]


def _scorer_cases(case):
    """(nets (B, h8, w8, 57), peaks [x, y, score, valid], K, up_h, up_w)
    with three planted cases: image 0's pair 0 has no valid a-peak
    (nrows 0), its pair 3 no valid b-peak, and pair 5's first b-peak sits
    on its first a-peak (norm 0, so ``safe`` is False)."""
    pairs = pairs_array()
    if case == "90x160 4x K=32":
        net, people = synthetic.render_scene(np.random.default_rng(9), 3,
                                             90, 160)
        nets, k = net[None], 32
        pk = _people_peaks(people, k)
    else:
        k = 32 if case == "46x54 B=3 K=32" else 16
        nets = np.stack([synthetic.render_scene(np.random.default_rng(s), n,
                                                46, 54)[0]
                         for s, n in [(0, 4), (1, 0), (2, 1)]])
        pk = _jax_peaks(nets, k)
    x, y, score, valid = pk
    valid[0, pairs[0, 0]] = False
    valid[0, pairs[3, 1]] = False
    pa, pb = pairs[5]
    assert valid[0, pa, 0] and valid[0, pb, 0]
    x[0, pb, 0], y[0, pb, 0] = x[0, pa, 0], y[0, pa, 0]
    h8, w8 = nets.shape[1:3]
    return nets, [x, y, score, valid], k, 4 * h8, 4 * w8


@pytest.mark.parametrize("prefix_valid", [True, False])
@pytest.mark.parametrize("case", ["46x54 B=3 K=32", "46x54 B=3 K=16",
                                  "90x160 4x K=32"])
def test_score_candidates_raw_batch_vs_pallas_batch(case, prefix_valid):
    """The port's raw-grid scorer (:func:`score_candidates_raw` on the
    CPU) vs ``score_candidates_pallas_batch`` (interpret): ``ok`` exact,
    scores within 1e-5, on a mixed batch at K = 32 and 16 and on a
    1280x720 frame's merged 90x160 grid at 4x, with a pair without valid
    a-peaks, one without valid b-peaks and a zero-length candidate."""
    params = JaxParams()
    nets, pk, k, up_h, up_w = _scorer_cases(case)
    ref = j_paf.score_candidates_pallas_batch(
        j_nms.Peaks(*(jnp.asarray(a) for a in pk)),
        jnp.asarray(nets[..., 19:]), up_h, up_w, params, interpret=True,
        prefix_valid=prefix_valid)
    before = score_candidates_raw.launches
    got = score_candidates_raw(
        nms.Peaks(*(_t(a) for a in pk)), _t(nets[..., 19:]), up_h, up_w,
        DecodeParams(), prefix_valid=prefix_valid)
    assert score_candidates_raw.launches == before  # CPU: no kernel launch
    assert got.ok.shape == (len(nets), 19, k, k) and got.ok.dtype == torch.bool
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               rtol=0, atol=1e-5)
    assert got.ok.numpy().sum() > 10
    assert not got.ok.numpy()[0, [0, 3]].any()
    assert not got.ok.numpy()[0, 5, 0, 0]


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        smooth_nms(torch.zeros(4, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        smooth_nms_topk_raw(torch.zeros(4, 4), 4, 4, 8, 0.05)
    with pytest.raises(ValueError, match="k_top"):
        smooth_nms_topk(torch.zeros(4, 4, 2), 1025, 0.05)
    with pytest.raises(ValueError, match="cap"):
        smooth_nms_topk(torch.zeros(4, 4, 2), 32, 0.05, cap=16)
    z = torch.zeros(2, 18, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        score_candidates_raw(nms.Peaks(z, z, z.float(), z.bool()),
                             torch.zeros(2, 3, 3, 37), 12, 12,
                             DecodeParams())


def _scorer_args(b=2, k=4, h8=3, w8=3, dtype=torch.int32):
    z = torch.zeros(b, 18, k, dtype=dtype)
    return nms.Peaks(z, z, z.float(), z.bool()), torch.zeros(b, h8, w8, 38)


@pytest.mark.parametrize("call, match", [
    (lambda: score_candidates_raw(*_scorer_args(), 13, 12, DecodeParams()),
     "integer upsample"),
    (lambda: score_candidates_raw(*_scorer_args(), 2, 12, DecodeParams()),
     "integer upsample"),
    (lambda: score_candidates_raw(*_scorer_args(k=1025), 12, 12,
                                  DecodeParams()), "K in"),
    (lambda: score_candidates_raw(*_scorer_args(), 12, 12, DecodeParams(
        step_paf=MAX_STEPS + 1)), "step_paf"),
    (lambda: score_candidates_raw(*_scorer_args(dtype=torch.int64), 12, 12,
                                  DecodeParams()), "peaks.x"),
    (lambda: score_candidates_raw(_scorer_args()[0], torch.zeros(3, 3, 3, 38),
                                  12, 12, DecodeParams()), "paf8")])
def test_score_candidates_raw_checks_its_inputs_on_every_device(call, match):
    """Peaks (B, 18, K) int32/bool with K in 1..1024, a raw PAF of the same
    batch, an integer upsample and 1..64 samples are checked before a
    device is chosen, so the CPU raises where the card would."""
    with pytest.raises(ValueError, match=match):
        call()


def test_topk_smem_fits_hopper_at_main_path_sizes():
    """46x54 raw planes at 4x (the main path) and at 8x stay on the
    raw-grid route: within its size limit, as they fit the old kernel's
    shared memory."""
    assert _route_floats(46, 54, 4, 4) * 4 < 100 * 1024
    assert _route_floats(46, 54, 8, 8) <= PHASE_ROUTE_FLOATS
    assert can_use_phase_kernel(46, 54, 184, 216)
    assert can_use_phase_kernel(46, 54, 368, 432)


@pytest.mark.parametrize("call, match", [
    (lambda x: smooth_nms_topk_raw(x, 4, 4, MAX_K + 1, 0.05), "k_top"),
    (lambda x: smooth_nms_topk_raw(x, 4, 4, 0, 0.05), "k_top"),
    (lambda x: smooth_nms_topk_raw(x, 4, 4, 32, 0.05, cap=0), "cap"),
    (lambda x: smooth_nms_topk_raw(x, 4, 4, 32, 0.05, cap=LIST_CAP + 1),
     "cap"),
    (lambda x: smooth_nms_topk_raw(x, 4, 0, 32, 0.05), "fy and fx"),
    (lambda x: smooth_nms_topk_raw(x, 4, 4, 32, 0.05, kernlen=MAX_TAPS + 1),
     "kernlen"),
    (lambda x: smooth_nms_topk(x, 32, 0.05, kernlen=0), "kernlen"),
    (lambda x: smooth_nms_topk(x, 32, 0.05, cap=LIST_CAP + 1), "cap"),
    (lambda x: smooth_nms_topk(x, 0, 0.05), "k_top")])
def test_topk_wrappers_check_their_limits_on_every_device(call, match):
    """The wrappers check K (1..1024), the shared-memory list length
    (1..4096; K4 at least K) and the blur length (1..64) before choosing
    a device, so the CPU raises where the card would."""
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(6, 7, 2))


def test_topk_raw_takes_a_cap_below_k():
    """K1's ``cap`` only says how long a list is sorted whole: below K
    (the radix path on the card) the plain version answers as usual."""
    x = _t(_heat8(3, 46, 54, 2, "noise"))
    for cap in (1, 8, LIST_CAP):
        s, i = smooth_nms_topk_raw(x, 4, 4, 32, 0.05, cap=cap)
        assert (i.numpy() >= 0).all()


@pytest.mark.parametrize("c, plane", [(18, 184 * 216), (144, 115 * 135),
                                      (2, 1)])
def test_peak_lists_sized_for_the_worst_case(c, plane):
    """Every value of every plane may be a peak (a plateau): the list
    holds c * plane keys of 8 bytes, and the counts start at 0."""
    lists, counts = peak_lists(c, plane, "cpu")
    assert lists.dtype == torch.int64 and lists.numel() == c * plane
    assert counts.dtype == torch.int32 and counts.tolist() == [0] * c


@pytest.mark.parametrize("f, kind", [(1, "scene"), (2, "scene"),
                                     (3, "scene"), (4, "scene"),
                                     (2, "noise"), (4, "noise")])
def test_k1_phase_reference_vs_plain(f, kind):
    """The raw-grid kernel's own arithmetic in PyTorch (the card tests
    hold the kernel to it bit for bit) selects the plain version's peaks:
    indices exact, scores rtol 1e-5."""
    heat8 = _t(_heat8(10 * f, 46, 54, 4, kind))
    s, i = k1_phase_reference(heat8, f, f, 32, 0.05)
    s0, i0 = smooth_nms_topk_raw_plain(heat8, f, f, 32, 0.05)
    np.testing.assert_array_equal(i.numpy(), i0.numpy())
    np.testing.assert_allclose(s.numpy(), s0.numpy(), rtol=1e-5, atol=0)
    assert (i.numpy() >= 0).sum() > 0


def test_build_dir_hashes_sources_and_finds_all_kernels():
    d = build.build_dir()
    assert d.startswith(build.BUILD_ROOT) and d == build.build_dir()
    assert {n[:-3] for n in build._sources() if n.endswith(".cu")} == {
        "smooth_nms", "smooth_nms_topk_raw", "smooth_nms_topk", "paf_score",
        "assemble", "bias_prelu"}


def test_build_dir_hashes_the_shared_header():
    """``csrc/peak_select.cuh`` is shared by the two top-K sources and the
    smooth + NMS source: it is hashed into the build directory's name but
    not compiled alone."""
    names = build._sources()
    assert "peak_select.cuh" in names
    for stem in ("smooth_nms_topk", "smooth_nms_topk_raw", "smooth_nms"):
        with open(os.path.join(build.CSRC, stem + ".cu")) as f:
            assert '#include "peak_select.cuh"' in f.read()


@pytest.mark.parametrize("stem, symbol, argtypes", [
    ("smooth_nms_topk_raw", "smooth_nms_topk_raw_launch", TOPK_RAW_ARGTYPES),
    ("smooth_nms_topk", "smooth_nms_topk_launch", TOPK_ARGTYPES),
    ("smooth_nms", "smooth_nms_launch", SMOOTH_NMS_ARGTYPES),
    ("paf_score", "score_candidates_raw_launch", SCORE_ARGTYPES),
    ("assemble", "assemble_launch", ASSEMBLE_ARGTYPES),
    ("bias_prelu", "bias_prelu_launch", BIAS_PRELU_ARGTYPES)])
def test_launcher_argtypes_match_the_c_signature(stem, symbol, argtypes):
    """ctypes passes what the wrapper declares: the declared types must
    follow the C launch function's parameters one for one (pointers,
    ints, 64-bit strides, the float thresholds), or the card call
    fails."""
    with open(os.path.join(build.CSRC, stem + ".cu")) as f:
        src = f.read()
    head = src[src.index(f'extern "C" int {symbol}('):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.split()[0] == "float" else
             ctypes.c_longlong if p.split()[:2] == ["long", "long"] else
             ctypes.c_int for p in params]
    assert kinds == list(argtypes)
