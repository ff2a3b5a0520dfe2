"""The int8 backbone (post-training quantisation, ``models/quantize.py``,
``QUANT_MODES`` in ``models/layers.py``) and the storage quantisation
(``convert/quantize.py``) of the port, against the JAX package on the
CPU.

The int8 arithmetic is the JAX ``QuantConv``'s: ``round_half_even(x /
s_in)`` clipped to +-127 with ``s_in = max(absmax, 1e-6) / 127`` (XLA
folds that constant division into a product with the fp32 reciprocal,
and so does the port), per-output-channel weight scales, int8 x int8
products accumulated exactly in int32, then ``acc * (s_in * s_w)``.
The port's accumulators are integer operations on every device
(``torch._int_mm`` for dense convs, int32 tap sums for depthwise ones),
so they equal the JAX accumulators and an int64 reference bit for bit,
including a saturated K = 9065 conv, where an fp32 accumulator is not
exact.

The int8 network amplifies an ulp: an activation that sits at a
rounding boundary of the next conv's quantisation moves by a whole step
when it differs by an ulp, and later layers spread the step. Layer by
layer the port equals JAX within 3e-7 (``tests/test_torch_quantize_net.py``);
whole networks agree as far as the int8 network allows, which the
tolerances below state. JAX's int8 convolution takes about 40 s per
160x160 image on the CPU, so the 160x160 estimator and ``eval
--quantize`` are held against a record of the JAX package's output
(``tests/make_int8_golden.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from tfpose_tpu.convert import quantize as jax_storage
from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu.models.layers import QuantConv
from tfpose_tpu_torch.cli import eval as eval_cli
from tfpose_tpu_torch.convert import quantize as storage
from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
    variables_to_numpy,
)
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.models.layers import (
    SameConv2d,
    int_conv2d,
    quantize_input,
    quantize_weight,
    same_pads,
    set_quant_mode,
)
from tfpose_tpu_torch.models.quantize import (
    calibrate,
    default_calibration_images,
    quantize_variables,
)
from test_torch_checkpoint import _random_variables

torch.set_num_threads(2)

_TRAINED = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained")
_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                       "int8_thin160_jax.npz")


def _ckpt(name):
    return os.path.join(_TRAINED, name, "params.msgpack")


def _flat(tree, prefix=""):
    """A nested dict's leaves by their "/"-joined path, as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# (kernel, in channels, out channels, stride, depthwise, bias)
_CONVS = {
    "depthwise_3x3": ((3, 3), 24, 24, (1, 1), True, False),
    "depthwise_3x3_stride2": ((3, 3), 16, 16, (2, 2), True, False),
    "dense_1x1": ((1, 1), 40, 20, (1, 1), False, False),
    "dense_3x3_stride2": ((3, 3), 3, 24, (2, 2), False, False),
    "dense_7x7_bias": ((7, 7), 37, 16, (1, 1), False, True),
}


@pytest.mark.parametrize("case", sorted(_CONVS))
def test_quant_conv_matches_jax(case):
    """One conv: the port's int8 values, scales and int32 accumulators
    equal the JAX ``QuantConv``'s arithmetic bit for bit (its
    ``lax.conv`` with ``preferred_element_type=int32``, jitted as in the
    network), and its output equals ``QuantConv``'s within rtol 1e-6.
    The input absmax is set below max|x|, so some inputs clip."""
    kernel, cin, cout, stride, depthwise, bias = _CONVS[case]
    groups = cin if depthwise else 1
    rng = np.random.default_rng(sum(map(ord, case)))
    x = rng.normal(0, 1, (2, 11, 13, cin)).astype(np.float32)
    absmax = np.float32(0.8 * np.abs(x).max())
    mod = QuantConv(cout, kernel, stride, feature_group_count=groups,
                    use_bias=bias)
    params = jax.tree.map(np.asarray, mod.init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if bias:
        params["bias"] = rng.normal(0, 0.1, cout).astype(np.float32)
    want = np.asarray(mod.apply(
        {"params": params, "quant": {"in_absmax": absmax}},
        jnp.asarray(x)))

    @jax.jit
    def jax_acc(x, kernel, stat):
        s_in = jnp.maximum(stat, 1e-6) / 127.0
        xq = jnp.clip(jnp.round(x / s_in), -127, 127).astype(jnp.int8)
        s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)),
                          1e-8) / 127.0
        wq = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
        dn = lax.conv_dimension_numbers(x.shape, kernel.shape,
                                        ("NHWC", "HWIO", "NHWC"))
        acc = lax.conv_general_dilated(
            xq, wq, stride, "SAME", dimension_numbers=dn,
            feature_group_count=groups, preferred_element_type=jnp.int32)
        return xq, s_in, wq, s_w, acc

    jxq, js_in, jwq, js_w, jacc = map(np.asarray, jax_acc(
        jnp.asarray(x), jnp.asarray(params["kernel"]), absmax))

    conv = SameConv2d(cin, cout, kernel, stride, groups=groups, bias=bias)
    set_quant_mode(conv, "int8")
    variables_from_numpy(conv, {"params": params,
                                "quant": {"in_absmax": absmax}})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        xq, s_in = quantize_input(xt, conv.in_absmax)
        wq, s_w = quantize_weight(conv.weight)
        top, bottom = same_pads(11, kernel[0], stride[0])
        left, right = same_pads(13, kernel[1], stride[1])
        acc = int_conv2d(F.pad(xq, (left, right, top, bottom)), wq, stride,
                         groups)
        got = conv(xt).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(xq.permute(0, 2, 3, 1).numpy(), jxq)
    assert s_in.item() == js_in
    assert np.array_equal(wq.permute(2, 3, 1, 0).numpy(), jwq)
    assert np.array_equal(s_w.numpy(), js_w)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.permute(0, 2, 3, 1).numpy(), jacc)
    assert (np.abs(jxq) == 127).any()  # some inputs clipped
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _int64_conv(xq, wq):
    """Dense valid int8 conv accumulated in int64 (unfold + matmul)."""
    o, c, kh, kw = wq.shape
    cols = F.unfold(xq.double(), (kh, kw)).long()        # (N, C*kh*kw, L)
    out = torch.einsum("ok,nkl->nol", wq.reshape(o, -1).long(), cols)
    n, _, h, w = xq.shape
    return out.reshape(n, o, h - kh + 1, w - kw + 1)


@pytest.mark.parametrize("case", ["one_sign", "input_signs_mixed",
                                  "depthwise"])
def test_saturated_accumulators_equal_int64(case):
    """CMU's largest conv, ``Mconv1_stage2_L1`` (7x7x185: K = 9065),
    with every input +-127 and every weight 127 of one sign: the int32
    accumulators equal an int64 reference. At one sign they reach
    9065 * 127^2 = 146,209,385, beyond fp32's 2^24 of exact integers,
    where an fp32 conv of the same values is not exact. The depthwise
    case saturates its 3x3 taps the same way."""
    rng = np.random.default_rng(9065)
    if case == "depthwise":
        x = torch.full((1, 64, 6, 7), 127, dtype=torch.int8)
        x[:, ::2] = -127
        w = torch.full((64, 1, 3, 3), -127, dtype=torch.int8)
        got = int_conv2d(x, w, (1, 1), groups=64)
        want = (x.long().unfold(2, 3, 1).unfold(3, 3, 1)
                * w.long().reshape(1, 64, 1, 1, 3, 3)).sum((4, 5))
        assert int(want.abs().max()) == 9 * 127 * 127
        assert torch.equal(got.long(), want)
        return
    x = torch.full((2, 185, 10, 9), 127, dtype=torch.int8)
    if case == "input_signs_mixed":
        x = torch.from_numpy(rng.choice(np.int8([-127, 127]), x.shape))
    w = torch.full((24, 185, 7, 7), 127, dtype=torch.int8)
    got = int_conv2d(x, w, (1, 1))
    want = _int64_conv(x, w)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.long(), want)
    if case == "one_sign":
        assert int(want.max()) == 9065 * 127 * 127 > 2 ** 24
        f32 = F.conv2d(x.float(), w.float())
        assert not torch.equal(f32.long(), want)


@pytest.fixture(scope="module")
def golden():
    with np.load(_GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def est160():
    return TfPoseEstimator("mobilenet_thin", target_size=(160, 160),
                           params_path=_ckpt("thin160_coco"), quantize=True,
                           device="cpu")


def test_thin160_int8_estimator_matches_jax(golden, est160):
    """``TfPoseEstimator(quantize=True)`` with ``thin160_coco`` at
    160x160 against the JAX int8 estimator's record on the three scenes
    of ``eval --synthetic-e2e 3``: the calibration (8 rendered scenes)
    within rtol 1e-5 (measured 1.7e-6); then, with the JAX calibration
    loaded, the same humans with the same part sets, coordinates within
    one cell of the 4x grid (1/80) and scores within 0.05 (measured
    0.0125 and 0.044). Past that the int8 network itself sets the
    tolerance: an ulp of difference in an activation, where it sits at a
    rounding boundary of the next conv's quantisation, moves that input
    by a whole step, and later layers spread it (the layers themselves
    agree within 3e-7, ``tests/test_torch_quantize_net.py``)."""
    from make_int8_golden import eval_scenes

    got = _flat(variables_to_numpy(est160.net)["quant"])
    assert len(got) == 143
    for k, v in got.items():
        np.testing.assert_allclose(v, golden["absmax/" + k], rtol=1e-5,
                                   err_msg=k)
    state = est160.net.state_dict()
    with torch.no_grad():
        for k in got:
            state[k.replace("/", ".")].copy_(torch.from_numpy(
                np.array(golden["absmax/" + k])))
    rows = []
    for i, img in enumerate(eval_scenes(3)):
        for j, hu in enumerate(est160.inference(img, upsample_size=4.0)):
            for part, bp in sorted(hu.body_parts.items()):
                rows.append((i, j, part, bp.x, bp.y, bp.score, hu.score))
    rows = np.asarray(rows, np.float64).reshape(-1, 7)
    want = golden["humans"]
    assert rows.shape == want.shape and len(rows) > 20
    assert np.array_equal(rows[:, :3], want[:, :3])
    assert np.abs(rows[:, 3:5] - want[:, 3:5]).max() <= 1 / 80 + 1e-6
    assert np.abs(rows[:, 5:] - want[:, 5:]).max() <= 0.05


def test_eval_quantize_synthetic_e2e_matches_jax(golden):
    """``eval --quantize --synthetic-e2e 3 --resize 160x160`` with
    ``thin160_coco``, each package calibrating on its own: the JAX
    ``eval.py``'s statistics (its record) with the same AP50 and the same
    matched and missed humans and keypoints; AP and AR within 0.05 and
    the mean deviation within 0.1 px (measured 0.037, 0.02 and 0.058 px:
    the two calibrations differ by ulps, which the int8 network spreads,
    as ``test_thin160_int8_estimator_matches_jax`` says)."""
    from make_int8_golden import ARGV

    want = json.loads(str(golden["eval_stats_json"]))
    got = eval_cli.main(list(ARGV) + ["--device", "cpu"])
    assert got.keys() == want.keys()
    for k in ("AP50", "matched_humans", "matched_keypoints",
              "missed_keypoints"):
        assert got[k] == want[k], k
    for k, tol in (("AP", 0.05), ("AR", 0.05), ("mean_px_deviation", 0.1)):
        assert got[k] == pytest.approx(want[k], rel=0, abs=tol), k
    assert got["AP50"] >= 0.6  # tests/test_quantize.py's int8 gate


def test_quantize_variables_tree_loads_both_ways():
    """``quantize_variables`` returns the fp32 tree plus a ``quant``
    collection of one absmax per conv, which an int8 network of either
    package takes: the port's carries it into ``in_absmax`` and back
    unchanged, and its structure is the JAX int8 network's."""
    variables = _random_variables(_ckpt("v2small160_coco"), 4)
    out = quantize_variables("mobilenet_v2_small", variables,
                             default_calibration_images((32, 32), n=1),
                             target_size=(32, 32))
    jnet = jax_network("mobilenet_v2_small", quant="int8")
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    assert _flat(out["quant"]).keys() == _flat(
        jax.tree.map(lambda a: a, dict(shapes["quant"]))).keys()
    net = variables_from_numpy(
        get_network("mobilenet_v2_small", quant="int8"), out)
    back = _flat(variables_to_numpy(net)["quant"])
    assert all(np.array_equal(back[k], v)
               for k, v in _flat(out["quant"]).items())
    with pytest.raises(KeyError):  # an fp32 network has no in_absmax
        variables_from_numpy(get_network("mobilenet_v2_small"), out)


def test_storage_quantization_matches_jax_bit_for_bit():
    """``convert/quantize.py`` on the ``thin368_coco`` params: int8
    values, scales, the fp32 leaves, the dequantised tree, the bf16 cast
    and the round-trip error equal the JAX module's bit for bit."""
    params = load_flax_msgpack(_ckpt("thin368_coco"))["params"]
    got = storage.quantize_params(params)
    want = jax.tree.map(np.asarray, jax_storage.quantize_params(params))
    for part in ("q", "s", "fp"):
        g, w = _flat(got[part]), _flat(want[part])
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    g = _flat(storage.dequantize_params(got))
    w = _flat(jax.tree.map(np.asarray, jax_storage.dequantize_params(want)))
    assert g.keys() == w.keys()
    assert all(np.array_equal(g[k], w[k]) for k in w)
    g = storage.cast_params(params)
    w = jax_storage.cast_params(params)
    gf, wf = _flat(g), _flat(w)
    for k in wf:
        if np.ndim(wf[k]) >= 2:
            assert gf[k].dtype == torch.bfloat16
            assert np.array_equal(gf[k].float().numpy(),
                                  np.asarray(wf[k], np.float32)), k
        else:
            assert np.array_equal(gf[k], wf[k])
    assert storage.quantization_error(params) == \
        jax_storage.quantization_error(params)
