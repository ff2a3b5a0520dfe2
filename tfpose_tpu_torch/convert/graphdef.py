"""Frozen TF1 ``graph_opt.pb`` (GraphDef) <-> flax variables tree — port
of ``tfpose_tpu/convert/graphdef.py``.

The reference deploys frozen graphs (variables folded into ``Const``
nodes). :func:`graphdef_to_variables` maps every const of such a graph
onto the flax-structured tree of numpy arrays that
``convert/checkpoint.py`` carries (``variables_to_numpy`` /
``variables_from_numpy``), so a converted graph is saved with
``save_flax_msgpack`` and loaded by ``TfPoseEstimator(params_path=...)``;
:func:`variables_to_graphdef` is its inverse. The name tables, the
``/read`` lookup and the folded-BatchNorm stand-in are the JAX module's.

Layouts are flax's: conv kernels HWIO as in TF; a TF depthwise kernel
(H, W, C, 1) is flax's grouped-conv kernel (H, W, 1, C).

The JAX module reads and writes ``.pb`` files with TensorFlow; the port
has its own GraphDef codec over ``compat/wire.py`` (the card machine has
neither TensorFlow nor protobuf). It reads the fields the converter
needs and skips the rest:

* ``GraphDef.node`` (1);
* ``NodeDef``: ``name`` (1), ``op`` (2), ``input`` (3), ``attr`` (5), a
  map whose entries hold the key (1) and an ``AttrValue`` (2);
* ``AttrValue``: ``type`` (6), ``tensor`` (8);
* ``TensorProto``: ``dtype`` (1), ``tensor_shape`` (2, its dims at 2,
  each with its size at 1), ``tensor_content`` (4), ``float_val`` (5),
  ``int_val`` (7), ``int64_val`` (10).

It writes consts as ``tensor_content``; TensorFlow reads the port's
graphs (its map order may differ from TensorFlow's own writer's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from tfpose_tpu_torch.compat import wire

DT_FLOAT, DT_INT32, DT_INT64 = 1, 3, 9
_NP_DTYPES = {DT_FLOAT: np.dtype("<f4"), DT_INT32: np.dtype("<i4"),
              DT_INT64: np.dtype("<i8")}
_TF_DTYPES = {v.str: k for k, v in _NP_DTYPES.items()}


# ---------------------------------------------------------------------------
# the GraphDef subset
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TensorProto:
    """A ``TensorProto``'s dtype, shape and values."""
    dtype: int = 0
    shape: List[int] = dataclasses.field(default_factory=list)
    tensor_content: bytes = b""
    float_val: List[float] = dataclasses.field(default_factory=list)
    int_val: List[int] = dataclasses.field(default_factory=list)
    int64_val: List[int] = dataclasses.field(default_factory=list)

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "TensorProto":
        """A float32, int32 or int64 array as ``tensor_content``."""
        arr = np.asarray(arr)
        key = arr.dtype.newbyteorder("<").str
        if key not in _TF_DTYPES:
            raise ValueError(f"unsupported const dtype {arr.dtype}")
        return cls(dtype=_TF_DTYPES[key], shape=list(arr.shape),
                   tensor_content=np.ascontiguousarray(
                       arr, arr.dtype.newbyteorder("<")).tobytes())

    def serialize(self) -> bytes:
        """dtype, shape and ``tensor_content`` (the writer's consts)."""
        out = bytearray()
        if self.dtype:
            out += wire.varint_field(1, self.dtype)
        shape = b"".join(wire.len_field(2, wire.varint_field(1, d)
                                        if d else b"") for d in self.shape)
        out += wire.len_field(2, shape)
        if self.tensor_content:
            out += wire.len_field(4, self.tensor_content)
        return bytes(out)

    @classmethod
    def parse(cls, buf) -> "TensorProto":
        t = cls()
        for num, wt, val in wire.iter_fields(buf):
            if num == 1 and wt == wire.VARINT:
                t.dtype = val
            elif num == 2 and wt == wire.LEN:
                t.shape = [_dim_size(d) for n, w, d in wire.iter_fields(val)
                           if n == 2 and w == wire.LEN]
            elif num == 4 and wt == wire.LEN:
                t.tensor_content = bytes(val)
            elif num == 5 and wt in (wire.LEN, wire.FIXED32):
                t.float_val += wire.packed_fixed32(val).tolist()
            elif num in (7, 10):
                conv = wire.to_int32 if num == 7 else wire.to_int64
                vals = (wire.packed_varints(val) if wt == wire.LEN
                        else [val] if wt == wire.VARINT else [])
                (t.int_val if num == 7 else t.int64_val).extend(
                    conv(v) for v in vals)
        return t


def _dim_size(buf) -> int:
    size = 0
    for num, wt, val in wire.iter_fields(buf):
        if num == 1 and wt == wire.VARINT:
            size = wire.to_int64(val)
    return size


@dataclasses.dataclass
class AttrValue:
    """An ``AttrValue``'s ``type`` or ``tensor``; other kinds are skipped."""
    type: int = 0
    tensor: Optional[TensorProto] = None

    def serialize(self) -> bytes:
        out = b""
        if self.type:
            out += wire.varint_field(6, self.type)
        if self.tensor is not None:
            out += wire.len_field(8, self.tensor.serialize())
        return out

    @classmethod
    def parse(cls, buf) -> "AttrValue":
        a = cls()
        for num, wt, val in wire.iter_fields(buf):
            if num == 6 and wt == wire.VARINT:
                a.type = val
            elif num == 8 and wt == wire.LEN:
                a.tensor = TensorProto.parse(val)
        return a


@dataclasses.dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    attr: Dict[str, AttrValue] = dataclasses.field(default_factory=dict)

    def serialize(self) -> bytes:
        out = bytearray(wire.len_field(1, self.name.encode()))
        out += wire.len_field(2, self.op.encode())
        for name in self.input:
            out += wire.len_field(3, name.encode())
        for key, value in self.attr.items():
            out += wire.len_field(5, wire.len_field(1, key.encode())
                                  + wire.len_field(2, value.serialize()))
        return bytes(out)

    @classmethod
    def parse(cls, buf) -> "NodeDef":
        n = cls()
        for num, wt, val in wire.iter_fields(buf):
            if wt != wire.LEN:
                continue
            if num == 1:
                n.name = str(val, "utf-8")
            elif num == 2:
                n.op = str(val, "utf-8")
            elif num == 3:
                n.input.append(str(val, "utf-8"))
            elif num == 5:
                key, value = "", AttrValue()
                for k, w, v in wire.iter_fields(val):
                    if k == 1 and w == wire.LEN:
                        key = str(v, "utf-8")
                    elif k == 2 and w == wire.LEN:
                        value = AttrValue.parse(v)
                n.attr[key] = value
        return n


@dataclasses.dataclass
class GraphDef:
    """A ``GraphDef``'s nodes, with ``SerializeToString`` and
    ``ParseFromString`` as protobuf names them."""
    node: List[NodeDef] = dataclasses.field(default_factory=list)

    def SerializeToString(self) -> bytes:
        return b"".join(wire.len_field(1, n.serialize()) for n in self.node)

    def ParseFromString(self, payload) -> int:
        self.node = [NodeDef.parse(val)
                     for num, wt, val in wire.iter_fields(payload)
                     if num == 1 and wt == wire.LEN]
        return len(payload)

    @classmethod
    def FromString(cls, payload) -> "GraphDef":
        gd = cls()
        gd.ParseFromString(payload)
        return gd


def load_graphdef(path: str) -> GraphDef:
    """Parse a frozen .pb file."""
    with open(path, "rb") as f:
        return GraphDef.FromString(f.read())


def make_ndarray(t: TensorProto) -> Optional[np.ndarray]:
    """TensorFlow's ``MakeNdarray`` for DT_FLOAT, DT_INT32 and DT_INT64:
    ``tensor_content`` as raw little-endian values; else the value list,
    a single value filling the shape and a shorter list padded with its
    last value, none giving zeros. None where ``MakeNdarray`` would
    raise (another dtype, more values than the shape holds, content of
    another size)."""
    dtype = _NP_DTYPES.get(t.dtype)
    if dtype is None:
        return None
    shape = tuple(t.shape)
    n = int(np.prod(shape, dtype=np.int64))
    if t.tensor_content:
        if len(t.tensor_content) != n * dtype.itemsize:
            return None
        return np.frombuffer(t.tensor_content, dtype).copy().reshape(shape)
    vals = {DT_FLOAT: t.float_val, DT_INT32: t.int_val,
            DT_INT64: t.int64_val}[t.dtype]
    values = np.asarray(vals, dtype)
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size > n:
        return None
    return np.pad(values, (0, n - values.size), "edge").reshape(shape)


def extract_consts(graphdef: GraphDef) -> Dict[str, np.ndarray]:
    """All Const node tensors that :func:`make_ndarray` reads, keyed by
    node name (the JAX module skips consts ``MakeNdarray`` cannot read)."""
    out = {}
    for node in graphdef.node:
        value = node.attr.get("value")
        if node.op != "Const" or value is None or value.tensor is None:
            continue
        arr = make_ndarray(value.tensor)
        if arr is not None:
            out[node.name] = arr
    return out


# ---------------------------------------------------------------------------
# name mapping (the JAX module's tables)
# ---------------------------------------------------------------------------

def _flatten(tree: Any, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (k,)))
    else:
        flat[prefix] = tree
    return flat


def _unflatten(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


_BN_LEAF = {"scale": "gamma", "bias": "beta",
            "mean": "moving_mean", "var": "moving_variance"}


def tf1_name_for(path: tuple, collection: str, scope: str = "") -> str:
    """The reference-style (flat, ``tf_pose/network_base.py``) TF1 const
    name of a flax variable path, e.g. ``('MConv_Stage1', 'L1_1',
    'depthwise', 'kernel')`` -> ``MConv_Stage1_L1_1_depthwise/
    depthwise_weights``, ``('conv4_3_CPM', 'conv', 'kernel')`` ->
    ``conv4_3_CPM/weights``."""
    *mods, leaf = path
    if mods and mods[-1] in ("depthwise", "pointwise"):
        base = "_".join(mods[:-1]) + "_" + mods[-1]
        sub = "depthwise_weights" if mods[-1] == "depthwise" else "weights"
        name = f"{base}/{sub}"
    elif mods and mods[-1] in ("dw_bn", "pw_bn"):
        side = "depthwise" if mods[-1] == "dw_bn" else "pointwise"
        base = "_".join(mods[:-1]) + "_" + side
        name = f"{base}/BatchNorm/{_BN_LEAF[leaf]}"
    elif mods and mods[-1] == "bn":
        base = "_".join(mods[:-1])
        name = f"{base}/BatchNorm/{_BN_LEAF[leaf]}"
    elif mods and mods[-1] == "conv":
        base = "_".join(mods[:-1])
        name = f"{base}/weights" if leaf == "kernel" else f"{base}/biases"
    elif mods and mods[-1].endswith("_bn"):
        base = "_".join(mods[:-1] + [mods[-1][:-3]])
        name = f"{base}/BatchNorm/{_BN_LEAF[leaf]}"
    else:
        base = "_".join(mods)
        sub = {"kernel": "weights", "bias": "biases"}.get(
            leaf, _BN_LEAF.get(leaf, leaf))
        name = f"{base}/{sub}"
    return f"{scope}/{name}" if scope else name


def tf1_slim_name_for(path: tuple, collection: str) -> Optional[str]:
    """The slim-style nested name of a MobileNet-v2 backbone variable, as
    ``tensorflow/models`` slim graphs name them (the first block
    unindexed): ``('expanded_conv_0', 'depthwise', 'kernel')`` ->
    ``MobilenetV2/expanded_conv/depthwise/depthwise_weights``; None for
    paths outside the v2 backbone (they use the flat style)."""
    *mods, leaf = path
    if not mods:
        return None
    head = mods[0]
    if not (head == "Conv" or head == "Conv_bn"
            or head.startswith("expanded_conv")):
        return None

    parts = ["MobilenetV2"]
    if head == "Conv":
        parts.append("Conv")
        rest = mods[1:]
    elif head == "Conv_bn":
        parts.append("Conv")
        rest = ["bn"] + mods[1:]
    else:
        parts.append("expanded_conv" if head == "expanded_conv_0" else head)
        rest = mods[1:]

    bn_side = {"dw_bn": "depthwise", "pw_bn": "pointwise",
               "expand_bn": "expand", "project_bn": "project"}
    sub = rest[-1] if rest else None
    if sub in bn_side:
        parts += [bn_side[sub], "BatchNorm", _BN_LEAF[leaf]]
    elif sub == "bn" or (sub and sub.endswith("_bn")):
        if sub != "bn":
            parts.append(sub[:-3])
        parts += ["BatchNorm", _BN_LEAF[leaf]]
    elif leaf in _BN_LEAF and collection == "batch_stats":
        parts += (list(rest) + ["BatchNorm", _BN_LEAF[leaf]])
    else:
        parts += list(rest)
        if leaf == "kernel":
            parts.append("depthwise_weights" if parts[-1] == "depthwise"
                         else "weights")
        elif leaf == "bias":
            parts.append("biases")
        else:
            parts.append(_BN_LEAF.get(leaf, leaf))
    return "/".join(parts)


def tf1_name_candidates(path: tuple, collection: str,
                        scope: str = "") -> list:
    """Every plausible const name of a flax path, most likely first: the
    slim and flat styles, each under ``scope``, ``Openpose`` (the
    reference's ``get_network`` scope) and no scope."""
    names = []
    slim = tf1_slim_name_for(path, collection)
    if slim is not None:
        names.append(slim)
    names.append(tf1_name_for(path, collection))
    prefixes = []
    for p in (scope, "Openpose", ""):
        if p not in prefixes:
            prefixes.append(p)
    out = []
    for n in names:
        for p in prefixes:
            full = f"{p}/{n}" if p else n
            if full not in out:
                out.append(full)
    return out


def _to_flax_layout(arr: np.ndarray, path: tuple) -> np.ndarray:
    """TF const -> flax layout: a depthwise (H, W, C, 1) kernel becomes
    the grouped conv's (H, W, 1, C)."""
    if path[-1] == "kernel" and "depthwise" in path:
        if arr.ndim == 4 and arr.shape[3] == 1:
            return np.transpose(arr, (0, 1, 3, 2))
    return arr


def _from_flax_layout(arr: np.ndarray, path: tuple) -> np.ndarray:
    if path[-1] == "kernel" and "depthwise" in path:
        if arr.ndim == 4 and arr.shape[2] == 1:
            return np.transpose(arr, (0, 1, 3, 2))
    return arr


def _lookup(consts: Dict[str, np.ndarray], path: tuple, coll: str,
            scope: str) -> Optional[np.ndarray]:
    for name in tf1_name_candidates(path, coll, scope):
        arr = consts.get(name)
        if arr is None:
            # frozen graphs often read consts via Identity '<n>/read'
            arr = consts.get(name + "/read")
        if arr is not None:
            return arr
    return None


def _folded_bn_value(consts: Dict[str, np.ndarray], path: tuple,
                     coll: str, scope: str, shape) -> Optional[np.ndarray]:
    """Identity BatchNorm for graphs whose BatchNorm was folded into the
    conv (TF's ``fold_batch_norms``: pre-scaled weights and a ``biases``
    const, no BN nodes): mean 0, var ``1 - eps``, scale 1 and bias the
    conv's ``biases``, so that ``sqrt(var + eps) == 1`` for the BNs'
    eps 1e-3 and the output is the folded graph's exactly."""
    *mods, leaf = path
    if leaf not in _BN_LEAF or not mods:
        return None
    bn_mod = mods[-1]
    side = {"dw_bn": "depthwise", "pw_bn": "pointwise"}.get(bn_mod)
    if side is not None:
        conv_path = tuple(mods[:-1]) + (side, "kernel")
    elif bn_mod == "bn":
        conv_path = tuple(mods[:-1]) + ("conv", "kernel")
    elif bn_mod.endswith("_bn"):
        conv_path = tuple(mods[:-1]) + (bn_mod[:-3], "kernel")
    else:
        return None
    bias = None
    for name in tf1_name_candidates(conv_path, "params", scope):
        base = name.rsplit("/", 1)[0]
        bias = consts.get(f"{base}/biases")
        if bias is None:
            bias = consts.get(f"{base}/biases/read")
        if bias is not None:
            break
    if bias is None:
        return None
    bias = np.asarray(bias, np.float32).reshape(-1)
    if bias.shape != tuple(shape):
        return None
    if leaf == "bias":
        return bias
    if leaf == "scale":
        return np.ones_like(bias)
    if leaf == "mean":
        return np.zeros_like(bias)
    return np.full_like(bias, np.float32(1.0 - 1e-3))


def graphdef_to_variables(graphdef: GraphDef, template: Dict[str, Any],
                          scope: str = "") -> Dict[str, Any]:
    """The flax variables tree (numpy float32) of a frozen GraphDef.

    ``template``: a tree with the target structure and shapes, e.g.
    ``variables_to_numpy(get_network(name))``. Every plausible reference
    naming is tried (flat and slim styles, scope prefixes, ``/read``
    forms), then identity BatchNorm for folded graphs; missing or
    mismatched consts raise ``ValueError`` with a report.
    """
    consts = extract_consts(graphdef)
    out_flat: Dict[tuple, np.ndarray] = {}
    missing, mismatched = [], []
    for coll in ("params", "batch_stats"):
        if coll not in template:
            continue
        for path, value in _flatten(template[coll]).items():
            arr = _lookup(consts, path, coll, scope)
            if arr is None:
                arr = _folded_bn_value(consts, path, coll, scope,
                                       value.shape)
                if arr is not None:
                    out_flat[(coll,) + path] = arr
                    continue
            if arr is None:
                missing.append(tf1_name_candidates(path, coll, scope)[0])
                continue
            arr = _to_flax_layout(np.asarray(arr, np.float32), path)
            if arr.shape != value.shape:
                mismatched.append((path, arr.shape, value.shape))
                continue
            out_flat[(coll,) + path] = arr
    if missing or mismatched:
        raise ValueError(
            "GraphDef -> flax conversion failed.\n"
            f"missing consts ({len(missing)}): {missing[:10]}...\n"
            f"shape mismatches: {mismatched[:10]}")
    return _unflatten(out_flat)


def variables_to_graphdef(variables: Dict[str, Any], scope: str = "",
                          style: str = "flat",
                          read_nodes: bool = False) -> GraphDef:
    """A GraphDef of Const nodes with reference-style TF1 names, the
    inverse of :func:`graphdef_to_variables`. ``style='slim'`` names the
    v2 backbone's variables as slim graphs do; ``read_nodes`` adds the
    ``<name>/read`` Identity nodes that frozen graphs carry."""
    gd = GraphDef()
    for coll in ("params", "batch_stats"):
        if coll not in variables:
            continue
        for path, value in _flatten(variables[coll]).items():
            name = tf1_slim_name_for(path, coll) if style == "slim" else None
            if name is None:
                name = tf1_name_for(path, coll, scope)
            elif scope:
                name = f"{scope}/{name}"
            arr = _from_flax_layout(np.asarray(value, np.float32), path)
            gd.node.append(NodeDef(name=name, op="Const", attr={
                "dtype": AttrValue(type=DT_FLOAT),
                "value": AttrValue(tensor=TensorProto.from_array(arr))}))
            if read_nodes:
                gd.node.append(NodeDef(name=name + "/read", op="Identity",
                                       input=[name]))
    return gd


def convert_pb_file(pb_path: str, model_name: str, out_path: str,
                    input_size=(432, 368)) -> None:
    """Frozen pb -> msgpack checkpoint for ``model_name``, in the JAX
    package's format. ``input_size`` is the JAX signature's; the
    variables' shapes do not depend on it."""
    from tfpose_tpu_torch.convert.checkpoint import (
        save_flax_msgpack, variables_to_numpy)
    from tfpose_tpu_torch.models import get_network

    del input_size
    template = variables_to_numpy(get_network(model_name))
    variables = graphdef_to_variables(load_graphdef(pb_path), template,
                                      scope="Openpose")
    save_flax_msgpack(out_path, variables)
