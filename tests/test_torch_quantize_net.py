"""The port's int8 networks against the JAX package's on the CPU: the
calibration, and every int8 conv and BatchNorm of thin, v2small and CMU
on the network's own activations (``models/layers.py``,
``models/quantize.py``).

An int8 network amplifies an ulp: an activation at a rounding boundary
of the next conv's quantisation moves by a whole step when it differs by
an ulp, and later layers spread the step. So each layer is held on JAX's
own input to it (the JAX network's captured outputs are fed forward in
place of the port's), which isolates its arithmetic; the free-running
maps are held within what the int8 network's sensitivity allows.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu.models.quantize import calibrate as jax_calibrate
from tfpose_tpu.pipeline.preprocess import normalize as jax_normalize
from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.models.layers import (
    BatchNorm,
    SameConv2d,
    set_quant_mode,
)
from tfpose_tpu_torch.models.quantize import (
    calibrate,
    default_calibration_images,
)
from test_torch_checkpoint import _random_variables
from test_torch_quantize import _flat

torch.set_num_threads(2)

_TRAINED = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained")
_CKPT = {"mobilenet_thin": "thin368_coco",
         "mobilenet_v2_small": "v2small160_coco", "cmu": "cmu160_coco"}


def _variables(name, seed):
    """Random weights of ``name``'s checkpoint tree, BN statistics away
    from identity (``test_torch_checkpoint._random_variables``)."""
    return _random_variables(os.path.join(
        _TRAINED, _CKPT[name], "params.msgpack"), seed)


def test_calibrate_matches_jax():
    """The fp32 forward's absmax of every conv's input, image by image
    from zero, against the JAX network's own calibration step
    (``get_network(quant="calib")`` applied with a mutable ``quant``)
    with the same weights: rtol 1e-5 (measured 2e-6), every conv
    present, the first conv's input within 0.5.

    JAX's ``calibrate`` starts its running max from ``net.init``, which
    runs the calibrating forward once more on the first image with
    flax's random initial weights; so its absmax is the larger of the
    two (ROADMAP C4). The port starts from zero, as the function's own
    docstring describes."""
    variables = _variables("mobilenet_thin", 2)
    imgs = default_calibration_images((48, 64), n=2)
    jnet = jax_network("mobilenet_thin", quant="calib")

    @jax.jit
    def step(v, img):
        return jnet.apply(v, jax_normalize(img), train=False,
                          mutable=["quant"])[1]["quant"]

    init_quant = jax.jit(lambda x: jnet.init(
        jax.random.PRNGKey(0), jax_normalize(x), train=False)["quant"])(
            jnp.asarray(imgs[:1]))
    quant = jax.tree.map(jnp.zeros_like, init_quant)
    for img in imgs:
        quant = step(dict(variables, quant=quant), jnp.asarray(img[None]))
    want = _flat(jax.tree.map(np.asarray, quant))
    net = variables_from_numpy(get_network("mobilenet_thin"), variables)
    got = _flat(calibrate(net, imgs))
    assert got.keys() == want.keys() and len(got) == 143
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert 0.1 < got["Conv2d_0/conv/in_absmax"] <= 0.5
    assert all(m.quant == "calib" for m in net.modules()
               if isinstance(m, SameConv2d))
    # JAX's calibrate: the larger of this and the init forward's absmax
    ref = _flat(jax.tree.map(np.asarray, jax_calibrate(
        "mobilenet_thin", variables, imgs)))
    init = _flat(jax.tree.map(np.asarray, init_quant))
    for k in ref:
        np.testing.assert_allclose(ref[k], np.maximum(want[k], init[k]),
                                   rtol=1e-6, err_msg=k)
    assert any(init[k] > 1.01 * want[k] for k in want)


@pytest.mark.parametrize("name,dtype", [
    ("mobilenet_thin", "float32"),
    ("mobilenet_thin", "bfloat16"),
    ("mobilenet_v2_small", "float32"),
    ("cmu", "float32"),
])
def test_int8_forward_matches_jax(name, dtype):
    """At 33x47, random weights with BN statistics away from identity
    and the port's calibration in both networks:

    * layer by layer, each int8 conv and BatchNorm of the port, given
      the JAX network's input to it, within 1e-6 of that layer's largest
      output (measured 3.1e-7); in bf16 the convs the same and the
      BatchNorms, which round to bf16 at their end, within 1e-2 (two
      bf16 ulps; measured 1.3e-3);
    * the free-running ``concat_stage7`` within 0.05 of the largest map
      value: measured 0 (thin bf16), 8e-8 (CMU) and 1.5e-7 (v2small),
      and 0.0196 for thin in fp32, where a flipped rounding spread, about
      what int8 itself moves these maps from the fp32 forward;
    * and int8 really used: the maps move from the fp32 forward by more
      than 0.5 % of their largest value (measured 1.2-2.6 %)."""
    h, w = 33, 47
    variables = _variables(name, 3)
    x = np.random.default_rng(5).uniform(-0.5, 0.5, (1, h, w, 3)).astype(
        np.float32)
    net32 = variables_from_numpy(get_network(name).eval(), variables)
    variables = dict(variables, quant=calibrate(
        net32, default_calibration_images((w, h), n=2, seed=4)))
    set_quant_mode(net32, "none")
    bf16 = dtype == "bfloat16"
    jnet = jax_network(name, dtype=jnp.bfloat16 if bf16 else jnp.float32,
                       quant="int8")
    out, state = jax.jit(lambda v, t: jnet.apply(
        v, t, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(variables, jnp.asarray(x))
    want = np.asarray(out["concat_stage7"].astype(jnp.float32))
    captured = {}
    for path, val in jax.tree_util.tree_flatten_with_path(
            state["intermediates"])[0]:
        keys = [str(getattr(k, "key", "")) for k in path]
        if keys[-2] == "__call__":
            captured[".".join(keys[:-2])] = np.asarray(
                val.astype(jnp.float32))

    net = variables_from_numpy(get_network(
        name, torch.bfloat16 if bf16 else torch.float32,
        quant="int8").eval(), variables)
    with torch.no_grad():
        free = net(torch.from_numpy(x))["concat_stage7"].float().numpy()
        f32 = net32(torch.from_numpy(x))["concat_stage7"].numpy()

    layers = {}

    def forced(mod, inputs, output, path):
        jax_out = torch.from_numpy(captured[path]).permute(0, 3, 1, 2)
        layers[path] = (type(mod), output.float(), jax_out)
        return jax_out.to(output.dtype)

    for path, mod in net.named_modules():
        if isinstance(mod, (SameConv2d, BatchNorm)):
            mod.register_forward_hook(
                lambda m, i, o, path=path: forced(m, i, o, path))
    with torch.no_grad():
        net(torch.from_numpy(x))
    n_convs = sum(isinstance(m, SameConv2d) for m in net.modules())
    assert sum(t is SameConv2d for t, _, _ in layers.values()) == n_convs
    for path, (kind, got, ref) in layers.items():
        tol = 1e-2 if bf16 and kind is BatchNorm else 1e-6
        scale = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol * scale, path

    scale = np.abs(want).max()
    assert np.abs(free - want).max() <= 0.05 * scale
    assert np.abs(free - f32).max() > 0.005 * scale
