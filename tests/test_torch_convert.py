"""The port's TF1 GraphDef converter (``convert/graphdef.py``,
``cli/convert.py``) and checkpoint inspector (``cli/checkpoint.py``)
against the JAX package's (``tfpose_tpu/convert/graphdef.py``,
``convert.py``, ``run_checkpoint.py``) and TensorFlow, which the JAX side
needs (skipped without it, as ``tests/test_convert.py`` is).

Graphs come from JAX's exporter and from TensorFlow
(``tests/fixtures/graphdef_tf.pb``, written by
``tests/make_conversion_fixtures.py``); no real ``graph_opt.pb`` is in
the tree. Variables are compared bit for bit."""

import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tensorflow.core.framework import graph_pb2  # noqa: E402
from tensorflow.python.framework import tensor_util  # noqa: E402

from make_conversion_fixtures import GRAPHDEF, GRAPHDEF_ARRAYS  # noqa: E402
from tfpose_tpu.convert import graphdef as jgd  # noqa: E402
from tfpose_tpu_torch.convert import graphdef as gd  # noqa: E402
from tfpose_tpu_torch.convert.checkpoint import (  # noqa: E402
    load_flax_msgpack,
    variables_to_numpy,
)
from tfpose_tpu_torch.models import get_network  # noqa: E402
from tfpose_tpu_torch.models.layers import init_weights  # noqa: E402
from test_torch_estimator import _assert_same_humans, _scenes  # noqa: E402

torch.set_num_threads(2)

_TRAINED = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained")


def _variables(name, seed=0):
    """Seeded variables of a registry model as the flax numpy tree, with
    BN statistics away from identity so that every leaf differs."""
    net = init_weights(get_network(name), torch.Generator().manual_seed(seed))
    variables = variables_to_numpy(net)
    rng = np.random.default_rng(seed)
    for path, leaf in gd._flatten(variables).items():
        if path[0] == "batch_stats" or path[-1] in ("scale", "bias"):
            leaf += rng.normal(0, 0.1, leaf.shape).astype(np.float32)
            if path[-1] == "var":
                np.abs(leaf, out=leaf)
    return variables


def _assert_same_tree(got, want):
    fg, fw = gd._flatten(got), jgd._flatten(want)
    assert set(fg) == set(fw)
    for k in fw:
        w = np.asarray(fw[k])
        assert fg[k].dtype == w.dtype == np.float32, k
        assert fg[k].shape == w.shape and fg[k].tobytes() == w.tobytes(), k


# (model, writer keywords): flat and slim styles, scopes, /read nodes
_GRAPHS = [
    ("mobilenet_thin", dict()),
    ("mobilenet_thin", dict(scope="Openpose", read_nodes=True)),
    ("mobilenet_v2_small", dict(scope="Openpose", style="slim",
                                read_nodes=True)),
    ("mobilenet_v2_small", dict(style="flat")),
    ("cmu", dict(scope="Openpose", read_nodes=True)),
]


@pytest.mark.parametrize("name, kw", _GRAPHS)
def test_jax_written_graphs_read_by_the_port(name, kw):
    """JAX's ``variables_to_graphdef`` bytes -> the port's reader: JAX's
    ``graphdef_to_variables`` of the same graph, bit for bit."""
    variables = _variables(name)
    raw = jgd.variables_to_graphdef(variables, **kw).SerializeToString()
    want = jgd.graphdef_to_variables(graph_pb2.GraphDef.FromString(raw),
                                     variables, scope=kw.get("scope", ""))
    got = gd.graphdef_to_variables(gd.GraphDef.FromString(raw), variables,
                                   scope=kw.get("scope", ""))
    _assert_same_tree(got, want)
    _assert_same_tree(got, variables)


@pytest.mark.parametrize("name, kw", _GRAPHS)
def test_port_written_graphs_read_by_tensorflow_and_jax(name, kw):
    variables = _variables(name, seed=1)
    ours = gd.variables_to_graphdef(variables, **kw)
    theirs = jgd.variables_to_graphdef(variables, **kw)
    tf_gd = graph_pb2.GraphDef.FromString(ours.SerializeToString())
    assert [(n.name, n.op, list(n.input)) for n in tf_gd.node] == [
        (n.name, n.op, list(n.input)) for n in theirs.node]
    for node in tf_gd.node:
        if node.op == "Const":
            assert node.attr["dtype"].type == 1
            assert tensor_util.MakeNdarray(node.attr["value"].tensor).dtype \
                == np.float32
    _assert_same_tree(jgd.graphdef_to_variables(
        tf_gd, variables, scope=kw.get("scope", "")), variables)


def test_name_tables_equal_jax():
    """Every path of every registry model's tree gets JAX's names."""
    examples = {
        ("MConv_Stage1", "L1_1", "depthwise", "kernel"):
            "MConv_Stage1_L1_1_depthwise/depthwise_weights",
        ("MConv_Stage1", "L1_1", "dw_bn", "scale"):
            "MConv_Stage1_L1_1_depthwise/BatchNorm/gamma",
        ("conv4_3_CPM", "conv", "kernel"): "conv4_3_CPM/weights",
    }
    for path, name in examples.items():
        assert gd.tf1_name_for(path, "params") == name
    assert gd.tf1_name_for(("conv1_1", "conv", "bias"), "params",
                           "Openpose") == "Openpose/conv1_1/biases"
    for model in ("mobilenet_thin", "mobilenet_v2_small", "cmu"):
        variables = variables_to_numpy(get_network(model))
        for coll, tree in variables.items():
            for path in gd._flatten(tree):
                for scope in ("", "Openpose"):
                    assert gd.tf1_name_for(path, coll, scope) == \
                        jgd.tf1_name_for(path, coll, scope)
                    assert gd.tf1_name_candidates(path, coll, scope) == \
                        jgd.tf1_name_candidates(path, coll, scope)
                assert gd.tf1_slim_name_for(path, coll) == \
                    jgd.tf1_slim_name_for(path, coll)


def test_missing_and_mismatched_consts_reported():
    variables = _variables("mobilenet_thin")
    with pytest.raises(ValueError, match=r"missing consts \(715\)"):
        gd.graphdef_to_variables(gd.GraphDef(), variables)
    graph = gd.variables_to_graphdef(variables)
    node = next(n for n in graph.node if n.name.endswith("/weights"))
    node.attr["value"].tensor = gd.TensorProto.from_array(
        np.zeros((1, 2, 3), np.float32))
    with pytest.raises(ValueError, match="shape mismatches: \\[\\(\\("):
        gd.graphdef_to_variables(graph, variables)


def test_folded_batchnorm_graph():
    """A graph whose BatchNorm was folded (weights and a ``biases``
    const per conv, no BN nodes), as ``tests/test_convert.py`` builds it
    with TensorFlow: the port restores JAX's identity BatchNorm bit for
    bit, and the network computes the folded graph's conv + bias."""
    variables = _variables("mobilenet_thin")
    rng = np.random.default_rng(2)
    graph = graph_pb2.GraphDef()
    for coll in ("params", "batch_stats"):
        for path, value in jgd._flatten(variables[coll]).items():
            mod = path[-2] if len(path) >= 2 else ""
            if path[-1] in ("scale", "bias", "mean", "var") and (
                    mod.endswith("_bn") or mod == "bn"):
                if path[-1] == "bias":
                    side = {"dw_bn": "depthwise", "pw_bn": "pointwise",
                            "bn": "conv"}.get(mod, mod[:-3])
                    base = jgd.tf1_name_for(path[:-2] + (side, "kernel"),
                                            "params").rsplit("/", 1)[0]
                    node = graph.node.add(name=f"{base}/biases", op="Const")
                    node.attr["value"].tensor.CopyFrom(
                        tensor_util.make_tensor_proto(rng.normal(
                            0, 0.1, value.shape).astype(np.float32)))
                continue
            node = graph.node.add(name=jgd.tf1_name_for(path, coll),
                                  op="Const")
            node.attr["value"].tensor.CopyFrom(tensor_util.make_tensor_proto(
                jgd._from_flax_layout(np.asarray(value, np.float32), path)))
    want = jgd.graphdef_to_variables(graph, variables)
    got = gd.graphdef_to_variables(
        gd.GraphDef.FromString(graph.SerializeToString()), variables)
    _assert_same_tree(got, want)
    bn = got["batch_stats"]["Conv2d_1"]["dw_bn"]
    assert (bn["mean"] == 0).all()
    assert (bn["var"] == np.float32(1 - 1e-3)).all()
    # identity BN: its input plus the folded bias, exactly
    # (sqrt(var + eps) rounds to 1)
    from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
    net = variables_from_numpy(get_network("mobilenet_thin").eval(), got)
    bn_mod = net.get_submodule("Conv2d_1.dw_bn")
    x = torch.from_numpy(rng.normal(0, 1, (1, bn_mod.num_features, 8, 8))
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(bn_mod(x), x + bn_mod.bias[:, None, None])


def test_tensorflow_fixture_consts_read_bit_for_bit():
    """``graphdef_tf.pb`` (TensorFlow's graph: a depthwise kernel and
    its /read, a splat, a short float_val, an empty const, int32 / int64
    consts in content and in int_val / int64_val, negative values, and
    string and double consts) -> TensorFlow's ``MakeNdarray`` of every
    float32 / int32 / int64 const, bit for bit, and the same arrays as
    JAX's ``extract_consts``."""
    graph = gd.load_graphdef(GRAPHDEF)
    consts = gd.extract_consts(graph)
    expected = np.load(GRAPHDEF_ARRAYS)
    names = [str(n) for n in expected["names"]]
    assert sorted(consts) == sorted(names)
    for i, name in enumerate(names):
        want = expected[f"a{i}"]
        assert consts[name].dtype == want.dtype, name
        assert consts[name].shape == want.shape, name
        assert consts[name].tobytes() == want.tobytes(), name
    theirs = jgd.extract_consts(jgd.load_graphdef(GRAPHDEF))
    assert set(theirs) - set(consts) == {"a_string", "doubles"}
    for name in consts:
        assert consts[name].tobytes() == np.asarray(theirs[name]).tobytes()
    # the fixture reaches every value encoding the reader has
    by_name = {n.name: n.attr["value"].tensor for n in graph.node
               if n.op == "Const"}
    assert by_name["splat"].float_val == [1.5]
    assert by_name["short"].float_val == [1.0, -2.5]
    assert by_name["neg_int32"].int_val == [-3]
    assert by_name["neg_int64"].int64_val == [-2 ** 40]
    assert by_name["Openpose/Conv2d_1_depthwise/depthwise_weights"
                   ].tensor_content
    ops = {n.name: (n.op, n.input) for n in graph.node}
    assert ops["Openpose/Conv2d_1_depthwise/depthwise_weights/read"] == (
        "Identity", ["Openpose/Conv2d_1_depthwise/depthwise_weights"])


@pytest.mark.parametrize("value, kw", [
    (1.5, dict(shape=[4, 3])),
    (np.float32(-2.0), dict(shape=[2, 1, 3])),
    (np.arange(6, dtype=np.float32).reshape(2, 3), {}),
    (np.array([], np.float32), {}),
    (7, dict(dtype=tf.int32, shape=[3])),
    (np.array([-1, 2 ** 31 - 1, -2 ** 31], np.int32), {}),
    (-(2 ** 50), dict(dtype=tf.int64, shape=[2])),
    (np.array([5, -6], np.int64), {}),
])
def test_make_tensor_proto_consts_read_as_make_ndarray(value, kw):
    proto = tensor_util.make_tensor_proto(value, **kw)
    got = gd.make_ndarray(gd.TensorProto.parse(proto.SerializeToString()))
    want = tensor_util.MakeNdarray(proto)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_unreadable_consts_are_skipped():
    """Where ``MakeNdarray`` raises, the port skips the const as JAX's
    ``extract_consts`` does (more values than the shape holds, content of
    another size); it also skips dtypes other than float32, int32 and
    int64, which the converter never maps."""
    from tensorflow.core.framework import tensor_pb2

    graph = graph_pb2.GraphDef()
    for i, t in enumerate([
            dict(dtype=1, float_val=[1.0, 2.0, 3.0]),
            dict(dtype=3, int_val=[1, 2, 3]),
            dict(dtype=1, tensor_content=b"\x00" * 7),
            dict(dtype=2, tensor_content=b"\x00" * 16)]):
        tensor = tensor_pb2.TensorProto(**t)
        tensor.tensor_shape.dim.add().size = 2
        node = graph.node.add(name=f"c{i}", op="Const")
        node.attr["value"].tensor.CopyFrom(tensor)
    assert set(jgd.extract_consts(graph)) == {"c3"}  # a DT_DOUBLE
    assert gd.extract_consts(gd.GraphDef.FromString(
        graph.SerializeToString())) == {}


@pytest.mark.parametrize("name, ckpt, style", [
    ("mobilenet_thin", "thin160_coco", "flat"),
    ("mobilenet_v2_small", "v2small160_coco", "slim"),
])
def test_convert_pb_file_equals_jax(tmp_path, name, ckpt, style):
    """A trained checkpoint written by JAX's exporter as a frozen graph
    (``Openpose`` scope, ``/read`` nodes) -> ``convert_pb_file``: the
    port's msgpack equals JAX's byte for byte, and the estimator built
    from it finds the JAX estimator's humans."""
    from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
    from tfpose_tpu_torch.cli import convert as convert_cli
    from tfpose_tpu_torch.estimator import TfPoseEstimator

    variables = load_flax_msgpack(os.path.join(_TRAINED, ckpt,
                                               "params.msgpack"))
    pb_path = str(tmp_path / "graph_opt.pb")
    with open(pb_path, "wb") as f:
        f.write(jgd.variables_to_graphdef(
            variables, scope="Openpose", style=style,
            read_nodes=True).SerializeToString())
    ours, theirs = str(tmp_path / "ours.msgpack"), str(tmp_path / "j.msgpack")
    convert_cli.main([pb_path, "--model", name, "--output", ours,
                      "--input-size", "64x64"])
    jgd.convert_pb_file(pb_path, name, theirs, input_size=(64, 64))
    assert open(ours, "rb").read() == open(theirs, "rb").read()

    kw = dict(target_size=(160, 160))
    est = TfPoseEstimator(name, params_path=ours, device="cpu", **kw)
    jax_est = JaxEstimator(name, params_path=theirs, **kw)
    found = 0
    for img in _scenes(2, 160, 160, seed=4):
        got = est.inference(img, upsample_size=4.0)
        _assert_same_humans(got, jax_est.inference(img, upsample_size=4.0))
        found += len(got)
    assert found


def test_checkpoint_cli_prints_run_checkpoints_tree(capsys):
    """``cli/checkpoint.py`` prints what the repo's ``run_checkpoint.py``
    prints (names sorted, shapes, dtypes, totals)."""
    import importlib.util

    from tfpose_tpu_torch.cli import checkpoint as checkpoint_cli

    spec = importlib.util.spec_from_file_location(
        "run_checkpoint_jax", os.path.join(os.path.dirname(__file__), "..",
                                           "run_checkpoint.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    argv = ["--model", "mobilenet_thin", "--checkpoint",
            os.path.join(_TRAINED, "thin160_coco", "params.msgpack")]
    for args in (argv, argv[:2]):
        checkpoint_cli.main(args)
        ours = capsys.readouterr().out
        jax_cli.main(args)
        assert ours == capsys.readouterr().out
    assert "715 tensors, 2,213,850 parameters" in ours


def test_console_scripts():
    """The port's console scripts mirror the JAX package's, one for
    one, plus ``tfpose-torch-parity-sweep`` (the JAX package runs its
    sweep as ``python -m tfpose_tpu.evaluation.parity_sweep``) and the
    counterparts of the repo's tool scripts (``scripts/broadcaster.py``,
    ``visualization.py``, ``sweep_backbones.py``, ``profile_*.py``), and
    each entry function exists."""
    import re

    from tfpose_tpu_torch.cli import entry

    text = open(os.path.join(os.path.dirname(__file__), "..",
                             "pyproject.toml")).read()
    scripts = dict(re.findall(r'^(tfpose-[\w-]+) = "([\w.:]+)"', text, re.M))
    jax_names = {k[len("tfpose-"):] for k in scripts
                 if not k.startswith("tfpose-torch-")}
    ours = {k[len("tfpose-torch-"):] for k in scripts
            if k.startswith("tfpose-torch-")}
    assert ours == jax_names | {"parity-sweep", "broadcaster",
                                "visualization", "sweep-backbones",
                                "profile"}
    for key, target in scripts.items():
        if key.startswith("tfpose-torch-"):
            assert callable(getattr(entry, target.split(":")[1]))
