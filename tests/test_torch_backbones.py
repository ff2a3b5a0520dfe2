"""Port parity: the registry and the mobilenet_v2 backbones (large and
small) — JAX on the CPU against the port on the CPU, fp32 — with seeded
random weights at odd and even sizes (TF ``SAME`` pads of the stride-2
depthwise convs, the bilinear 2x of the stride-16 tap) and with the
committed ``v2small160_coco`` / ``v2large160_coco`` weights, through the
backbone, the estimator (humans against the JAX estimator's) and the
AP50 gate of ``tests/test_coco_path.py``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
)
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.evaluation.coco_eval import synthetic_e2e
from tfpose_tpu_torch.models import MODEL_NAMES, get_network
from test_torch_checkpoint import _SUFFIX, _random_variables
from test_torch_estimator import _assert_same_humans, _scenes

torch.set_num_threads(2)

_TRAINED = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained")
_V2 = {"mobilenet_v2_small": os.path.join(_TRAINED, "v2small160_coco",
                                          "params.msgpack"),
       "mobilenet_v2_large": os.path.join(_TRAINED, "v2large160_coco",
                                          "params.msgpack")}


def _state_shapes_from_flax(name):
    """The port's state-dict shapes that the JAX network's variables
    imply (conv kernels HWIO -> OIHW), traced without computing."""
    x = jax.ShapeDtypeStruct((1, 32, 48, 3), jnp.float32)
    tree = jax.eval_shape(lambda t: jax_network(name).init(
        jax.random.PRNGKey(0), t, train=False), x)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path][1:]
        shape = leaf.shape
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1])
        out[".".join(keys[:-1] + [_SUFFIX[keys[-1]]])] = tuple(shape)
    return out


# BODY_25 is the port's own network (the JAX package has none): its
# state dict is held to the benchmark reference's tree in
# tests/test_torch_body25.py
@pytest.mark.parametrize("name", tuple(
    n for n in MODEL_NAMES if n != "body25") + ("vgg",))
def test_registry_builds_every_model_like_jax(name):
    """Every registry name builds, with the JAX network's parameters and
    BN statistics, name for name and shape for shape."""
    state = {k: tuple(v.shape) for k, v in get_network(name).state_dict()
             .items() if not k.endswith("num_batches_tracked")}
    assert state == _state_shapes_from_flax(name)


def _forward_both(name, variables, x):
    net_j = jax_network(name)
    apply = jax.jit(lambda v, t: net_j.apply(v, t, train=False))
    ref = np.asarray(apply(variables, jnp.asarray(x))["concat_stage7"])
    net = variables_from_numpy(get_network(name).eval(), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))["concat_stage7"].numpy()
    return ref, got


@pytest.mark.parametrize("hw", [(33, 47), (64, 80), (40, 57)])
@pytest.mark.parametrize("name", sorted(_V2))
def test_v2_backbone_random_weights_odd_and_even_sizes(name, hw):
    """Seeded random weights (every leaf of the checkpoint's tree, BN
    statistics away from identity) at odd and even sizes; atol 1e-5."""
    h, w = hw
    variables = _random_variables(_V2[name], 1)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, h, w, 3)).astype(
        np.float32)
    ref, got = _forward_both(name, variables, x)
    assert got.shape == ref.shape == (2, -(-h // 8), -(-w // 8), 57)
    assert np.abs(ref).max() > 1e-2  # a non-trivial output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(_V2))
def test_v2_backbone_committed_weights(name):
    """The committed checkpoint on rendered 160x160 scenes; atol 1e-5 on
    outputs of order 1."""
    x = np.stack(_scenes(2, 160, 160)).astype(np.float32) / 256.0 - 0.5
    ref, got = _forward_both(name, load_flax_msgpack(_V2[name]), x)
    assert got.shape == (2, 20, 20, 57)
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(_V2))
def test_v2_estimator_humans_equal_jax(name):
    """The estimator with the committed checkpoint at 160x160: humans
    equal the JAX estimator's (parts exact, coords 1e-6, scores 1e-5)
    on three rendered scenes, one image at a time and as a batch."""
    kw = dict(target_size=(160, 160), params_path=_V2[name])
    jax_est = JaxEstimator(name, **kw)
    est = TfPoseEstimator(name, device="cpu", **kw)
    imgs = _scenes(3, 160, 160, seed=11)
    n = 0
    for img in imgs:
        want = jax_est.inference(img, upsample_size=4.0)
        got = est.inference(img, upsample_size=4.0)
        _assert_same_humans(got, want)
        n += len(got)
    assert n >= 3
    for got, want in zip(est.inference_batch(imgs, upsample_size=4.0),
                         jax_est.inference_batch(imgs, upsample_size=4.0)):
        _assert_same_humans(got, want)


def test_v2small_checkpoint_passes_the_ap50_gate_through_the_port():
    """``tests/test_coco_path.py``'s v2small gate through the port: 50
    rendered 160x160 scenes (``default_rng(7)``), AP50 >= 0.90 (the JAX
    package measured 0.978)."""
    est = TfPoseEstimator("mobilenet_v2_small", target_size=(160, 160),
                          params_path=_V2["mobilenet_v2_small"], device="cpu")
    stats, _ = synthetic_e2e(est, 50, 160, 160)
    assert stats["AP50"] >= 0.90, stats
