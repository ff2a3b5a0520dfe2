"""Port parity for the decode: the port's ``decode`` / ``decode_batch``
(plain versions of the kernels on the CPU) against the JAX ``decode`` /
``decode_batch`` on the CPU, on rendered scenes, the golden fixtures and
a crowded input that saturates K; at integer ratios through the raw-grid
top-K and PAF sampler, and through the full-resolution top-K where the
ratio is not an integer or the raw-grid block does not fit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxParams
from tfpose_tpu.ops import decode as j_decode
from tfpose_tpu.utils import synthetic
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.ops import decode
from tfpose_tpu_torch.ops.kernels.smooth_nms import can_use_phase_kernel

torch.set_num_threads(2)

_FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                    "golden_decode.npz")


def _assert_same(got, ref):
    """Same humans: parts exact, coords 1e-6, scores 1e-5, same
    ``peak_saturated``."""
    for name in ("part_valid", "human_valid", "peak_saturated"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(ref.coords),
                               rtol=0, atol=1e-6)
    for name in ("part_scores", "human_scores"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)


def _scenes(spec, noise=0.0):
    return np.stack([synthetic.render_scene(np.random.default_rng(s), n, 46,
                                            54, noise=noise)[0]
                     for s, n in spec])


def test_decode_batch_on_rendered_scenes():
    nets = _scenes([(0, 3), (1, 0), (2, 5), (3, 1)])
    ref = jax.vmap(lambda t: j_decode.decode_jit(t, 184, 216, JaxParams()))(
        jnp.asarray(nets))
    got = decode.decode_batch(torch.from_numpy(nets), 184, 216,
                              DecodeParams())
    _assert_same(got, ref)
    assert got.human_valid.sum(1).tolist() == [3, 0, 4, 1]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_decode_on_golden_fixtures(i):
    net = np.load(_FIX)[f"net_{i}"]
    ref = j_decode.decode_jit(jnp.asarray(net), 184, 216, JaxParams())
    got = decode.decode(torch.from_numpy(net), 184, 216, DecodeParams())
    _assert_same(got, ref)
    assert int(got.human_valid.sum()) == np.load(_FIX)[f"parts_{i}"].shape[0]


def test_decode_batch_matches_jax_decode_batch_at_2x():
    nets = _scenes([(4, 2), (5, 4)], noise=0.02)
    ref = j_decode.decode_batch(jnp.asarray(nets), 92, 108, JaxParams())
    got = decode.decode_batch(torch.from_numpy(nets), 92, 108,
                              DecodeParams())
    _assert_same(got, ref)


def test_crowded_input_sets_peak_saturated_and_escalates():
    """A noisy crowd saturates K=32; ``decode_adaptive`` escalates to
    K=128 on both sides with the same result."""
    net = _scenes([(6, 12)], noise=0.3)[0]
    out, esc = decode.decode_adaptive(torch.from_numpy(net), 184, 216,
                                      DecodeParams())
    ref, ref_esc = j_decode.decode_adaptive(jnp.asarray(net), 184, 216,
                                            JaxParams())
    assert esc and ref_esc
    _assert_same(out, ref)
    plain = decode.decode(torch.from_numpy(net), 184, 216, DecodeParams())
    assert bool(plain.peak_saturated.any())


def _spy_full_res_topk(monkeypatch):
    """Record the (H, W, C) shape of every full-resolution top-K call
    that decode makes."""
    calls = []
    orig = decode.smooth_nms_topk

    def spy(heat, *args, **kwargs):
        calls.append(tuple(heat.shape))
        return orig(heat, *args, **kwargs)

    monkeypatch.setattr(decode, "smooth_nms_topk", spy)
    return calls


def test_decode_at_a_non_integer_ratio(monkeypatch):
    """Ratio 2.5 from (46, 54, 57): 115x135 through the full-resolution
    top-K and the gather scorer, against JAX ``decode_batch`` and
    ``decode``."""
    nets = _scenes([(7, 3), (8, 1), (9, 0)], noise=0.02)
    calls = _spy_full_res_topk(monkeypatch)
    ref = j_decode.decode_batch(jnp.asarray(nets), 115, 135, JaxParams())
    got = decode.decode_batch(torch.from_numpy(nets), 115, 135,
                              DecodeParams())
    _assert_same(got, ref)
    assert calls == [(115, 135, 3 * 18)]
    assert got.human_valid.sum(1).tolist()[1:] == [1, 0]
    ref = j_decode.decode_jit(jnp.asarray(nets[0]), 115, 135, JaxParams())
    _assert_same(decode.decode(torch.from_numpy(nets[0]), 115, 135,
                               DecodeParams()), ref)


def test_decode_at_4x_where_the_raw_grid_block_does_not_fit(monkeypatch):
    """A 1280x720 frame in 432x368 windows merges to a 90x160 grid; at 4x
    the raw-grid block would not fit shared memory, so the heat decodes
    at 360x640 through the full-resolution top-K."""
    assert not can_use_phase_kernel(90, 160, 360, 640)
    net = synthetic.render_scene(np.random.default_rng(10), 4, 90, 160)[0]
    calls = _spy_full_res_topk(monkeypatch)
    ref = j_decode.decode_jit(jnp.asarray(net), 360, 640, JaxParams())
    got = decode.decode(torch.from_numpy(net), 360, 640, DecodeParams())
    _assert_same(got, ref)
    assert calls == [(360, 640, 18)]
    assert int(got.human_valid.sum()) > 0
