"""Port parity: the msgpack checkpoint reader, the carry-over of flax
variables into the port's modules, and the mobilenet backbone forward
(JAX on the CPU vs the port on the CPU, fp32)."""

import glob
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
)
from tfpose_tpu_torch.models import get_network

torch.set_num_threads(2)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
_CKPTS = sorted(glob.glob(os.path.join(
    _ROOT, "models", "trained", "*", "params.msgpack")))
_THIN368 = os.path.join(_ROOT, "models", "trained", "thin368_coco",
                        "params.msgpack")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_all_committed_checkpoints_found():
    assert len(_CKPTS) == 8


@pytest.mark.parametrize("path", _CKPTS,
                         ids=[p.split(os.sep)[-2] for p in _CKPTS])
def test_msgpack_reader_matches_flax(path):
    got = load_flax_msgpack(path)
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for key, w in want_l.items():
        g = got_l[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert g.tobytes() == w.tobytes(), key  # bit for bit


def test_msgpack_reader_rejects_unknown_types(tmp_path):
    p = tmp_path / "bad.msgpack"
    # a map holding a timestamp ext (type -1)
    p.write_bytes(bytes([0x81, 0xA1, ord("a"), 0xD6, 0xFF, 0, 0, 0, 0]))
    with pytest.raises(ValueError, match="ext type"):
        load_flax_msgpack(str(p))
    p.write_bytes(bytes([0x81, 0xA1, ord("a"), 0xC1]))  # never-used byte
    with pytest.raises(ValueError, match="unsupported"):
        load_flax_msgpack(str(p))


_V1FULL = os.path.join(_ROOT, "models", "trained", "v1full160_coco",
                       "params.msgpack")


def _random_variables(path, seed):
    """A checkpoint's variables tree with every leaf replaced by seeded
    random values: kernels ~ N(0, 1/fan_in), BN scale and var in
    [0.5, 1.5], BN bias and mean ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    tree = load_flax_msgpack(path)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(0, fan_in ** -0.5, v.shape)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            else:
                out[k] = rng.normal(0, 0.1, v.shape)
            if not isinstance(v, dict):
                out[k] = out[k].astype(np.float32)
        return out

    return fill(tree)


def _trained(name):
    return os.path.join(_ROOT, "models", "trained", name, "params.msgpack")


# flax leaf -> the port's state-dict suffix, stated independently
_SUFFIX = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


@pytest.mark.parametrize("name,path", [
    ("mobilenet_thin", _THIN368), ("mobilenet", _V1FULL),
    ("mobilenet_v2_small", _trained("v2small160_coco")),
    ("mobilenet_v2_large", _trained("v2large160_coco")),
    ("cmu", _trained("cmu160_coco"))])
def test_carry_over_covers_every_leaf(name, path):
    """Every leaf of the committed checkpoint lands in its state-dict
    entry, conv kernels HWIO -> OIHW (a depthwise (3,3,1,C) as (C,1,3,3)),
    and every entry is filled: no missing or extra key."""
    variables = load_flax_msgpack(path)
    net = variables_from_numpy(get_network(name), variables)
    state = net.state_dict()
    n_leaves = sum(1 for _ in _leaves(variables))
    n_state = sum(1 for k in state if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_state
    for path_, arr in _leaves(variables):
        key = ".".join(path_[1:-1] + (_SUFFIX[path_[-1]],))
        want = arr.transpose(3, 2, 0, 1) if path_[-1] == "kernel" else arr
        np.testing.assert_array_equal(state[key].numpy(), want)


def test_carry_over_raises_on_missing_or_extra_key():
    def fresh():
        return _random_variables(_THIN368, 0)

    missing = fresh()
    del missing["params"]["MConv_Stage6"]["L2_5"]["pw_bn"]["scale"]
    with pytest.raises(KeyError, match="lacks"):
        variables_from_numpy(get_network("mobilenet_thin"), missing)
    extra = fresh()
    extra["params"]["Conv2d_0"]["conv"]["bias"] = np.zeros(24, np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        variables_from_numpy(get_network("mobilenet_thin"), extra)
    wrong = fresh()
    wrong["params"]["Conv2d_0"]["conv"]["kernel"] = np.zeros(
        (3, 3, 3, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        variables_from_numpy(get_network("mobilenet_thin"), wrong)


def _forward_both(name, variables, x):
    net_j = jax_network(name)
    apply = jax.jit(lambda v, t: net_j.apply(v, t, train=False))
    ref = np.asarray(apply(variables, jnp.asarray(x))["concat_stage7"])
    net = variables_from_numpy(get_network(name).eval(), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))["concat_stage7"].numpy()
    return ref, got


@pytest.mark.parametrize("hw", [(33, 47), (64, 80), (40, 57)])
def test_backbone_random_init_odd_and_even_sizes(hw):
    """TF-SAME padding: odd and even inputs through the stride-2 convs
    and the SAME max-pool, with seeded random weights; atol 1e-5."""
    h, w = hw
    variables = _random_variables(_THIN368, 1)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, h, w, 3)).astype(
        np.float32)
    ref, got = _forward_both("mobilenet_thin", variables, x)
    assert got.shape == ref.shape == (2, -(-h // 8), -(-w // 8), 57)
    assert np.abs(ref).max() > 1e-2  # a non-trivial output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_backbone_thin368_at_432x368():
    """The trained checkpoint at the main path's size; measured max
    |d| 1.9e-5 on outputs up to ~1."""
    variables = load_flax_msgpack(_THIN368)
    x = (np.random.default_rng(0).integers(0, 256, (1, 368, 432, 3))
         .astype(np.float32) / 256.0 - 0.5)
    ref, got = _forward_both("mobilenet_thin", variables, x)
    assert got.shape == (1, 46, 54, 57)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
