"""The bf16 backbone: the port's ``get_network(name, torch.bfloat16)``
and ``TfPoseEstimator(dtype="bfloat16")`` against the JAX package's bf16
networks and estimator on the CPU.

bf16 rounds at other places in the two packages. The port rounds where
flax's dtype declarations put the casts (``models/layers.py``); XLA on
the CPU may keep excess precision between fused ops (for example a conv
and its BatchNorm, ``xla_allow_excess_precision``), so its roundings are
a subset of those. The two bf16 results therefore differ by bf16 noise,
which these tests bound against the size of bf16's own effect.

Measured on the CPU, random weights (``concat_stage7``, max |port bf16 -
JAX bf16| / max |fp32 map|): thin 5.5e-3 (33x47) and 1.1e-2 (64x80),
v2small 8.1e-3 / 7.9e-3, CMU 4.8e-3 (40x57); JAX's own bf16 against
its fp32 is 5.1e-3 to 9.0e-3 there. With the trained 160x160 checkpoints
the maps move more under bf16 (JAX bf16 against fp32: max 0.10-0.35 on
maps of 1.5-2.1, 99th percentile 0.031-0.043); the port's bf16 maps are
as far from JAX's bf16 maps (max 0.12-0.56, 99th percentile 0.035-0.051).
The humans on 8 rendered scenes keep their part sets in every scene, for
both checkpoints, with coordinates within one cell of the 4x grid
(1/80) and part scores within 0.035.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import get_network
from test_torch_checkpoint import _random_variables
from test_torch_estimator import _scenes

torch.set_num_threads(2)

_TRAINED = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained")


def _ckpt(name):
    return os.path.join(_TRAINED, name, "params.msgpack")


@pytest.mark.parametrize("name,ckpt,hw", [
    ("mobilenet_thin", "thin368_coco", (33, 47)),
    ("mobilenet_v2_small", "v2small160_coco", (33, 47)),
    ("cmu", "cmu160_coco", (40, 57)),
])
def test_bf16_backbone_random_weights_against_jax_bf16(name, ckpt, hw):
    """Seeded random weights (every leaf of the checkpoint's tree, BN
    statistics away from identity): the port's bf16 ``concat_stage7``
    within 2e-2 of the largest fp32 map value of JAX's bf16 one (measured
    4.8e-3 to 8.1e-3 at these sizes), and bf16 really used: the output
    is bf16 and moves away from the fp32 forward, by at most 2e-2 of
    that value, as JAX's bf16 does. The parameters stay fp32."""
    h, w = hw
    variables = _random_variables(_ckpt(ckpt), 1)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, h, w, 3)).astype(
        np.float32)

    def jax_forward(dtype):
        net = jax_network(name, dtype=dtype)
        out = jax.jit(lambda v, t: net.apply(v, t, train=False))(
            variables, jnp.asarray(x))["concat_stage7"]
        return np.asarray(out.astype(jnp.float32))

    ref = jax_forward(jnp.bfloat16)
    net = variables_from_numpy(get_network(name, torch.bfloat16).eval(),
                               variables)
    net32 = variables_from_numpy(get_network(name).eval(), variables)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(b.dtype == torch.float32 for b in net.buffers()
               if b.is_floating_point())
    with torch.no_grad():
        out = net(torch.from_numpy(x))["concat_stage7"]
        # the fp32 forward, equal to JAX's within 1e-5
        # (tests/test_torch_backbones.py, test_torch_models.py)
        ref32 = net32(torch.from_numpy(x))["concat_stage7"].numpy()
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    scale = np.abs(ref32).max()
    assert scale > 0.1
    assert np.abs(got - ref).max() <= 2e-2 * scale
    d32 = np.abs(got - ref32).max()
    assert 0 < d32 <= 2e-2 * scale


def test_estimator_dtype_and_quantize_arguments():
    est = TfPoseEstimator("mobilenet_thin", target_size=(64, 64),
                          dtype="bfloat16", device="cpu")
    assert est.net.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in est.net.parameters())
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)
    est.inference(img, upsample_size=2.0)
    assert est.heatMat.dtype == np.float32
    with pytest.raises(ValueError, match="dtype"):
        TfPoseEstimator("mobilenet_thin", dtype="float16", device="cpu")
    # quantize=True composes with bf16: int8 convs on the upcast input,
    # BatchNorm rounding its fp32 output to bf16, fp32 maps
    est8 = TfPoseEstimator("mobilenet_thin", target_size=(64, 64),
                           dtype="bfloat16", quantize=True, device="cpu")
    assert est8.quantized and est8.net.dtype == torch.bfloat16
    assert {m.quant for m in est8.net.modules() if hasattr(m, "quant")} \
        == {"int8"}
    assert all(p.dtype == torch.float32 for p in est8.net.parameters())
    est8.inference(img, upsample_size=2.0)
    assert est8.heatMat.dtype == np.float32
    assert np.isfinite(est8.heatMat).all()
    with pytest.raises(ValueError, match="dtype"):
        get_network("mobilenet_thin", torch.float16)


def _matched(got, want):
    """Pairs of humans with the same part set, each human of ``got``
    with the nearest remaining one of ``want`` (the order of humans of
    near-equal score can differ under bf16 noise)."""
    assert len(got) == len(want)
    left = list(want)
    pairs = []
    for g in got:
        same = [w for w in left if w.body_parts.keys() == g.body_parts.keys()]
        assert same, f"no JAX human with parts {sorted(g.body_parts)}"
        best = min(same, key=lambda w: max(
            max(abs(g.body_parts[p].x - w.body_parts[p].x),
                abs(g.body_parts[p].y - w.body_parts[p].y))
            for p in g.body_parts))
        left.remove(best)
        pairs.append((g, best))
    return pairs


@pytest.fixture(scope="module")
def scenes():
    return _scenes(6, 160, 160, seed=3)


@pytest.mark.parametrize("ckpt", ["thin160_coco_bf16", "thin160_coco"])
def test_bf16_checkpoints_humans_against_jax_bf16(ckpt, scenes):
    """The committed 160x160 checkpoints run in bf16 in both packages on
    6 rendered scenes, as a batch (4x, the raw-grid decode) and one image
    at a time: the same number of humans and part sets in every scene;
    coordinates within one cell of the 4x grid (1/80 = 0.0125), part
    scores within 0.05 and human scores within 0.1 (bf16 noise in the
    maps, see the module docstring; measured 0.0125 and 0.035)."""
    kw = dict(target_size=(160, 160), params_path=_ckpt(ckpt),
              dtype="bfloat16")
    jax_est = JaxEstimator("mobilenet_thin", **kw)
    est = TfPoseEstimator("mobilenet_thin", device="cpu", **kw)
    results = list(zip(est.inference_batch(scenes, upsample_size=4.0),
                       jax_est.inference_batch(scenes, upsample_size=4.0)))
    results += [(est.inference(img, upsample_size=4.0),
                 jax_est.inference(img, upsample_size=4.0))
                for img in scenes[:3]]
    n = 0
    for got, want in results:
        for g, w in _matched(got, want):
            n += 1
            assert abs(g.score - w.score) <= 0.1
            for p, bp in g.body_parts.items():
                wp = w.body_parts[p]
                assert abs(bp.x - wp.x) <= 0.0125 + 1e-6
                assert abs(bp.y - wp.y) <= 0.0125 + 1e-6
                assert abs(bp.score - wp.score) <= 0.05
    assert n >= 15
