"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip (the decision is made inside
the fixture, so every worker collects the same tests). On the card,
whose Python has no jax for ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import k1_phase_reference, k2_compare, k4_compare, planes_up
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.ops import nms, paf, resize
from tfpose_tpu_torch.ops.kernels.paf_score import (
    paf_sample_scores,
    paf_sample_scores_plain,
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


@pytest.mark.parametrize("up", [1, 4])
def test_smooth_nms_kernel(nets, up):
    heat = resize.resize_area(nets[0, ..., :19], 46 * up, 54 * up)
    got, want = smooth_nms(heat.contiguous()), smooth_nms_plain(heat)
    k2_compare(got, want, heat)  # values 1e-6; flips only at near-ties


def test_paf_sample_kernel(nets):
    s, i = smooth_nms_topk_raw(
        nets[..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1).contiguous(),
        4, 4, 32, 0.05)
    s, i = s.reshape(3, 18, 32), i.reshape(3, 18, 32).clamp(min=0)
    pk = nms.Peaks(x=i % 216, y=i // 216, score=s, valid=s > 0.05)
    samples, _ = paf.raw_sample_inputs(pk, nets[..., 19:], 184, 216,
                                       DecodeParams())
    m, c = paf_sample_scores(*samples, s_paf=10, thresh=0.05)
    m0, c0 = paf_sample_scores_plain(*samples, s_paf=10, thresh=0.05)
    assert torch.equal(c, c0)
    torch.testing.assert_close(m, m0, rtol=0, atol=1e-6)


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
