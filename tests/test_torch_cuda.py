"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip (the decision is made inside
the fixture, so every worker collects the same tests). On the card,
whose Python has no jax for ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    heat8_of,
    k1_phase_reference,
    k2_compare,
    k3_compare,
    k4_compare,
    peaks_of,
    planes_up,
    scene_nets,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import pairs_array
from tfpose_tpu_torch.ops import resize
from tfpose_tpu_torch.ops.kernels.paf_score import (
    score_candidates_raw,
    score_candidates_raw_plain,
)
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    smooth_nms,
    smooth_nms_plain,
    smooth_nms_topk,
    smooth_nms_topk_plain,
    smooth_nms_topk_raw,
    smooth_nms_topk_raw_plain,
)
from tfpose_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    scenes = [synthetic.render_scene(rng, n, 46, 54)[0] for n in (3, 0, 5)]
    return torch.from_numpy(np.stack(scenes)).cuda()


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("cap", [4096, 8])
def test_topk_raw_kernel(nets, k, cap):
    """184x216 planes (not a multiple of the 32x64 tile); ``cap=8``
    takes the radix-select path. Indices exact, scores rtol 1e-5 against
    the plain version, bit for bit against the kernel's own phase
    arithmetic."""
    heat8 = nets[..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), 4, 4, k, 0.05, cap=cap)
    s0, i0 = smooth_nms_topk_raw_plain(heat8, 4, 4, k, 0.05)
    assert torch.equal(i, i0)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    s1, i1 = k1_phase_reference(heat8, 4, 4, k, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)


@pytest.mark.parametrize("f", [1, 2, 3])
def test_topk_raw_kernel_other_factors(nets, f):
    """Factors other than 4 run the kernel's run-time loops."""
    heat8 = nets[..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), f, f, 32, 0.05)
    s1, i1 = k1_phase_reference(heat8, f, f, 32, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)
    assert torch.equal(i, smooth_nms_topk_raw_plain(heat8, f, f, 32, 0.05)[1])


@pytest.mark.parametrize("cap", [4096, 16])
def test_topk_raw_kernel_on_a_plateau(nets, cap):
    """A plateau makes peaks of near-equal values: the two summation
    orders pick different ones, so the kernel is held bit for bit
    against its own phase arithmetic; a plane below the threshold has
    no peak."""
    x = torch.full((46, 54, 2), 0.5, device=nets.device)
    x[..., 1] = 0.01
    s, i = smooth_nms_topk_raw(x, 4, 4, 128, 0.05, cap=cap)
    s1, i1 = k1_phase_reference(x, 4, 4, 128, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)
    assert bool((i[0] >= 0).all()) and bool((i[1] == -1).all())


@pytest.fixture(scope="module")
def nets8(nets):
    rng = np.random.default_rng(8)
    scenes = [synthetic.render_scene(rng, n, 46, 54)[0]
              for n in (1, 4, 0, 2, 6)]
    return torch.cat([nets, torch.from_numpy(np.stack(scenes)).cuda()])


@pytest.mark.parametrize("shape, kernlen", [
    ((184, 216), 25), ((46, 54), 25), ((115, 135), 25), ((10, 12), 25),
    ((22, 26), 25), ((184, 216), 13)])
def test_smooth_nms_kernel(nets, shape, kernlen):
    """Bit for bit against the plain version on the 4x and 2.5x maps, the
    warm-up's 1x maps and at 13 taps (the run-time loops)."""
    heat = resize.resize_area(nets[0, ..., :19], *shape).contiguous()
    k2_compare(smooth_nms(heat, kernlen), smooth_nms_plain(heat, kernlen),
               f"{shape} {kernlen} taps")


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [32, 128])
def test_paf_sample_kernel(nets8, b, k):
    """The fused candidate scorer bit for bit against its plain version
    (``ok`` and ``score``), with one pair of image 0 without a valid
    a-peak (the row skip's nrows 0)."""
    heat8 = nets8[:b, ..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    pk = peaks_of(*smooth_nms_topk_raw(heat8.contiguous(), 4, 4, k, 0.05),
                  b, 216)
    valid = pk.valid.clone()
    valid[0, pairs_array()[0, 0]] = False
    pk = pk._replace(valid=valid)
    params = DecodeParams()
    got = score_candidates_raw(pk, nets8[:b, ..., 19:], 184, 216, params)
    k3_compare(got, score_candidates_raw_plain(pk, nets8[:b, ..., 19:], 184,
                                               216, params), f"B={b} K={k}")
    assert not bool(got.ok[0, 0].any()) and bool(got.ok.any())


def test_paf_sample_kernel_on_the_windowed_grid(nets):
    """A 1280x720 frame's merged 90x160 grid at 4x, peaks from the
    full-resolution top-K, with and without the row skip."""
    net = torch.from_numpy(synthetic.render_scene(
        np.random.default_rng(4), 3, 90, 160)[0]).to(nets.device)
    pk = peaks_of(*smooth_nms_topk(planes_up(net[None], 360, 640), 32, 0.05),
                  1, 640)
    params = DecodeParams()
    for prefix_valid in (True, False):
        args = (pk, net[None, ..., 19:], 360, 640, params, prefix_valid)
        got = score_candidates_raw(*args)
        k3_compare(got, score_candidates_raw_plain(*args), "90x160")
    assert bool(got.ok.any())


@pytest.mark.parametrize("k, cap", [(32, 4096), (128, 4096), (32, 32)])
@pytest.mark.parametrize("up", [(360, 640), (115, 135)])
def test_full_res_topk_kernel(nets, up, k, cap):
    """Scene planes as decode hands them over (a (H, W, C) view of
    channel-first planes); ``cap=32`` takes the radix-select path.
    Indices exact, scores 1e-6."""
    x = planes_up(nets, *up)
    k4_compare(smooth_nms_topk(x, k, 0.05, cap=cap),
               smooth_nms_topk_plain(x, k, 0.05))


def test_full_res_topk_kernel_on_a_plateau(nets):
    """Every interior pixel of a plateau is a peak: far more than the
    kernel's shared list, so it selects by radix from device memory."""
    x = torch.full((360, 640, 2), 0.5, device=nets.device)
    x[..., 1] = 0.01
    got = smooth_nms_topk(x, 128, 0.05)
    k4_compare(got, smooth_nms_topk_plain(x, 128, 0.05))
    assert bool((got[1][0].diff() > 0).all()) and bool((got[1][1] == -1).all())


def test_full_res_topk_kernel_other_blur_length(nets):
    """A blur length other than 25 runs the kernel's run-time loops."""
    x = planes_up(nets, 115, 135)
    for kernlen in (13, 4):
        k4_compare(smooth_nms_topk(x, 32, 0.05, kernlen=kernlen),
                   smooth_nms_topk_plain(x, 32, 0.05, kernlen))


# the new backbones' grids: CMU at 656x368 (46x82, B=16) and
# mobilenet_v2_small at 368x368 (46x46, B=8)
_GRIDS = {(46, 82): [3, 1, 5, 0, 2, 6, 4, 2] * 2, (46, 46): [2, 1, 3, 0, 2,
                                                            4, 1, 2]}


@pytest.fixture(scope="module")
def grid_nets(nets):
    return {g: torch.from_numpy(scene_nets(sum(g), people, *g)).to(
        nets.device) for g, people in _GRIDS.items()}


@pytest.mark.parametrize("grid", sorted(_GRIDS))
@pytest.mark.parametrize("k", [32, 128])
def test_topk_raw_kernel_at_the_new_grids(grid_nets, grid, k):
    """K1 at (46, 82, 288) and (46, 46, 144), and at B=1: bit for bit
    against its phase arithmetic; against the plain version the same
    peaks with scores rtol 1e-5. Here two peaks of one 46x46 plane lie
    an ulp apart and take each other's place in the plain version's
    order (it sums the upsampled blur in another order; the CPU shows the
    same swap between the plain version and the phase arithmetic), so
    the peaks are compared as sets."""
    net = grid_nets[grid]
    for b in (1, len(net)):
        heat8 = heat8_of(net[:b]).contiguous()
        s, i = smooth_nms_topk_raw(heat8, 4, 4, k, 0.05)
        s1, i1 = k1_phase_reference(heat8, 4, 4, k, 0.05)
        assert torch.equal(i, i1) and torch.equal(s, s1)
        s0, i0 = smooth_nms_topk_raw_plain(heat8, 4, 4, k, 0.05)
        i_sorted, order = i.sort(1)
        i0_sorted, order0 = i0.sort(1)
        assert torch.equal(i_sorted, i0_sorted) and bool((i >= 0).any())
        torch.testing.assert_close(s.gather(1, order), s0.gather(1, order0),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_smooth_nms_kernel_at_the_new_grids(grid_nets, grid):
    """K2 at 184x328x19 (two waves of tiles) and 184x184x19, bit for bit."""
    h8, w8 = grid
    heat = resize.resize_area(grid_nets[grid][0, ..., :19], 4 * h8,
                              4 * w8).contiguous()
    k2_compare(smooth_nms(heat), smooth_nms_plain(heat), f"{heat.shape}")


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_paf_sample_kernel_at_the_new_grids(grid_nets, grid):
    """K3 at 46x82 B=16 and 46x46 B=8, with and without the row skip."""
    h8, w8 = grid
    net = grid_nets[grid]
    b, up_h, up_w = len(net), 4 * h8, 4 * w8
    pk = peaks_of(*smooth_nms_topk_raw(heat8_of(net).contiguous(), 4, 4, 32,
                                       0.05), b, up_w)
    params = DecodeParams()
    for prefix_valid in (True, False):
        args = (pk, net[..., 19:], up_h, up_w, params, prefix_valid)
        got = score_candidates_raw(*args)
        k3_compare(got, score_candidates_raw_plain(*args), f"{grid} B={b}")
    assert bool(got.ok.any())
