"""Port parity: the CMU (VGG-19) backbone — JAX on the CPU against the
port on the CPU, fp32 — with seeded random weights at odd and even sizes
(TF ``SAME`` convs and max-pools with -inf padding at odd edges) and
with the committed ``cmu160_coco`` weights, through the backbone and the
estimator (humans against the JAX estimator's). Sizes stay at 160x160
or smaller: CMU is the heaviest model of the repo."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxParams
from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.ops import decode as j_decode
from tfpose_tpu.ops.pallas.smooth_nms import (
    can_use_phase_kernel as jax_route,
)
from tfpose_tpu.utils import synthetic
from tfpose_tpu_torch.convert.checkpoint import load_flax_msgpack
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import CmuNetwork, get_network
from tfpose_tpu_torch.ops import decode
from tfpose_tpu_torch.ops.kernels.smooth_nms import can_use_phase_kernel
from test_torch_backbones import _forward_both
from test_torch_checkpoint import _random_variables
from test_torch_decode import _assert_same
from test_torch_estimator import _assert_same_humans, _scenes

torch.set_num_threads(2)

_CMU = os.path.join(os.path.dirname(__file__), "..", "models", "trained",
                    "cmu160_coco", "params.msgpack")


@pytest.fixture(scope="module")
def cmu160():
    return load_flax_msgpack(_CMU)


@pytest.mark.parametrize("hw", [(33, 47), (64, 80), (40, 57)])
def test_cmu_backbone_random_weights_odd_and_even_sizes(hw):
    """Seeded random kernels and biases (N(0, 0.1)) over every leaf of
    the checkpoint's tree; atol 1e-5."""
    h, w = hw
    variables = _random_variables(_CMU, 2)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, h, w, 3)).astype(
        np.float32)
    ref, got = _forward_both("cmu", variables, x)
    assert got.shape == ref.shape == (2, -(-h // 8), -(-w // 8), 57)
    assert np.abs(ref).max() > 1e-2  # a non-trivial output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cmu_backbone_committed_weights(cmu160):
    """The committed checkpoint on a rendered 160x160 scene; atol 1e-5
    on outputs of order 1."""
    x = np.stack(_scenes(1, 160, 160)).astype(np.float32) / 256.0 - 0.5
    ref, got = _forward_both("cmu", cmu160, x)
    assert got.shape == (1, 20, 20, 57)
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_vgg_is_the_cmu_network():
    assert isinstance(get_network("vgg"), CmuNetwork)


def test_cmu_estimator_humans_equal_jax():
    """``cmu160_coco`` at 160x160 on two rendered scenes: the port's
    humans equal the JAX estimator's (parts exact, coords 1e-6, scores
    1e-5), one image at a time and as a batch."""
    kw = dict(target_size=(160, 160), params_path=_CMU)
    jax_est = JaxEstimator("cmu", **kw)
    est = TfPoseEstimator("cmu", device="cpu", **kw)
    imgs = _scenes(2, 160, 160, seed=11)
    n = 0
    for img in imgs:
        got = est.inference(img, upsample_size=4.0)
        _assert_same_humans(got, jax_est.inference(img, upsample_size=4.0))
        n += len(got)
    assert n >= 2
    for got, want in zip(est.inference_batch(imgs, upsample_size=4.0),
                         jax_est.inference_batch(imgs, upsample_size=4.0)):
        _assert_same_humans(got, want)


@pytest.mark.parametrize("grid, people", [
    ((46, 82), (3, 1, 5, 0)),   # CMU at 656x368
    ((46, 46), (2, 4, 1)),      # mobilenet_v2_small at 368x368
    ((20, 20), (1, 2))])        # the 160x160 checkpoints' grid
def test_decode_at_the_new_grids_matches_jax(grid, people):
    """The new paths' stride-8 grids at 4x take the raw-grid route in both
    packages, and decode rendered scenes to the JAX ``decode_batch``'s
    humans."""
    h8, w8 = grid
    assert can_use_phase_kernel(h8, w8, 4 * h8, 4 * w8)
    assert jax_route(h8, w8, 4 * h8, 4 * w8)
    rng = np.random.default_rng(h8 * w8)
    nets = np.stack([synthetic.render_scene(rng, n, h8, w8)[0]
                     for n in people])
    ref = jax.jit(j_decode.decode_batch, static_argnums=(1, 2, 3))(
        jnp.asarray(nets), 4 * h8, 4 * w8, JaxParams())
    got = decode.decode_batch(torch.from_numpy(nets), 4 * h8, 4 * w8,
                              DecodeParams())
    _assert_same(got, ref)
    assert int(got.human_valid.sum()) > 0
