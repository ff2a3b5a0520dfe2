"""Write the conversion fixtures that the port's tests, on the CPU and
on the card, read (run once; committed output under
``tests/fixtures/``). The card machine has neither protobuf nor
TensorFlow, so these are bytes that the JAX package's writer and
TensorFlow wrote, for the port's own codecs to read there.

* ``datum_jax.tpds``: a Datum shard of 4 rendered 64x80 (w x h) samples
  (2, 1, 0 and 3 people, a missing joint in each sample with people),
  written by the JAX package's ``write_datum_shard``: the 4 samples as
  raw records (``encoded=False``), then the same 4 as PNG records;
* ``graphdef_tf.pb``: a GraphDef that TensorFlow built (a placeholder,
  a depthwise kernel with its ``/read`` Identity and the depthwise conv
  that reads it, a pointwise kernel, a splat, a short ``float_val``, an
  empty float const, int32 and int64 consts in ``tensor_content`` and in
  ``int_val`` / ``int64_val`` with negative values, and string and
  double consts, which the port skips);
* ``graphdef_tf.npz``: TensorFlow's ``MakeNdarray`` of each DT_FLOAT,
  DT_INT32 and DT_INT64 const (``names`` and ``a<i>``).

Usage: JAX_PLATFORMS=cpu python tests/make_conversion_fixtures.py
"""

import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
DATUM = os.path.join(FIXTURES, "datum_jax.tpds")
GRAPHDEF = os.path.join(FIXTURES, "graphdef_tf.pb")
GRAPHDEF_ARRAYS = os.path.join(FIXTURES, "graphdef_tf.npz")
DATUM_WH = (64, 80)
PEOPLE = (2, 1, 0, 3)


def datum_samples():
    """The fixture's 4 (image, joints) samples."""
    from tfpose_tpu.utils import synthetic

    w, h = DATUM_WH
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate(PEOPLE):
        people = synthetic.random_people(rng, max(n, 1), h, w,
                                         template=synthetic.SPREAD_TEMPLATE)
        img = synthetic.render_image(people[:n], h, w, rng)
        joints = people[:n].astype(np.float32).astype(np.float64)
        if n:
            joints[0, (3 * i + 1) % 18] = np.nan
        out.append((img, joints))
    return out


def write_datum(tmp):
    from tfpose_tpu.train.lmdb_dataset import write_datum_shard

    samples = datum_samples()
    parts = []
    for encoded in (False, True):
        path = os.path.join(tmp, f"{encoded}.tpds")
        write_datum_shard(path, samples, encoded=encoded)
        with open(path, "rb") as f:
            data = f.read()
        parts.append(data if not parts else data[4:])  # one TPDS header
    with open(DATUM, "wb") as f:
        f.write(b"".join(parts))


def write_graphdef():
    import tensorflow as tf
    from tensorflow.core.framework import tensor_pb2
    from tensorflow.python.framework import tensor_util

    rng = np.random.default_rng(12)
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [1, 8, 8, 8], name="image")
        dw = tf.constant(rng.normal(0, 1, (3, 3, 8, 1)).astype(np.float32),
                         name="Openpose/Conv2d_1_depthwise/depthwise_weights")
        dw_read = tf.identity(
            dw, name="Openpose/Conv2d_1_depthwise/depthwise_weights/read")
        tf.nn.depthwise_conv2d(x, dw_read, [1, 1, 1, 1], "SAME",
                               name="Openpose/Conv2d_1_depthwise/depthwise")
        tf.constant(rng.normal(0, 1, (1, 1, 8, 16)).astype(np.float32),
                    name="Openpose/Conv2d_1_pointwise/weights")
        tf.constant(1.5, shape=[4, 3], dtype=tf.float32, name="splat")
        tf.constant([], dtype=tf.float32, name="empty")
        tf.constant(np.array([1, 46, 54, 57], np.int32), name="shape")
        tf.constant(-3, dtype=tf.int32, name="neg_int32")
        tf.constant(np.array([7, -9, 2 ** 40], np.int64), name="int64s")
        tf.constant(-(2 ** 40), dtype=tf.int64, name="neg_int64")
        tf.constant("Openpose", name="a_string")
        tf.constant(np.arange(3, dtype=np.float64), name="doubles")
    gd = g.as_graph_def()
    # a float_val shorter than the shape: MakeNdarray pads with the last
    short = gd.node.add()
    short.name, short.op = "short", "Const"
    short.attr["dtype"].type = tf.float32.as_datatype_enum
    tensor = tensor_pb2.TensorProto(dtype=tf.float32.as_datatype_enum,
                                    float_val=[1.0, -2.5])
    tensor.tensor_shape.dim.add().size = 5
    short.attr["value"].tensor.CopyFrom(tensor)
    with open(GRAPHDEF, "wb") as f:
        f.write(gd.SerializeToString())

    kept = (tf.float32.as_datatype_enum, tf.int32.as_datatype_enum,
            tf.int64.as_datatype_enum)
    names, arrays = [], {}
    for node in gd.node:
        if node.op == "Const" and node.attr["value"].tensor.dtype in kept:
            arrays[f"a{len(names)}"] = tensor_util.MakeNdarray(
                node.attr["value"].tensor)
            names.append(node.name)
    np.savez(GRAPHDEF_ARRAYS, names=np.asarray(names), **arrays)


def main():
    import tempfile

    os.makedirs(FIXTURES, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        write_datum(tmp)
    write_graphdef()
    for path in (DATUM, GRAPHDEF, GRAPHDEF_ARRAYS):
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
