"""The port's Caffe ``Datum`` records against protobuf and the JAX
package: the wire codec (``compat/wire.py``), ``Datum`` bytes equal to
protobuf's (``tfpose_tpu/compat/datum_pb2.py``), ``TPDS`` shards equal
to the JAX writer's, ``DatumPoseDataset`` batches equal to JAX's bit for
bit, the trainer's ``--datum-shard``, and the committed fixture
``tests/fixtures/datum_jax.tpds`` that ``tests/test_torch_cuda.py``
reads on the card."""

import math
import os
import struct

import numpy as np
import pytest

from make_conversion_fixtures import DATUM, DATUM_WH, PEOPLE, datum_samples
from tfpose_tpu.compat import datum_pb2 as pb
from tfpose_tpu.train import lmdb_dataset as jax_lmdb
from tfpose_tpu.utils import synthetic
from tfpose_tpu_torch.compat import wire
from tfpose_tpu_torch.compat.datum_pb2 import Datum
from tfpose_tpu_torch.train import lmdb_dataset as lmdb_ds
from tfpose_tpu_torch.train.dataset import Annotation, PoseDataset


def _scene(rng, h=64, w=80, n=2):
    people = synthetic.random_people(rng, n, h, w,
                                     template=synthetic.SPREAD_TEMPLATE)
    img = synthetic.render_image(people, h, w, rng)
    # float_data carries fp32: quantise up front, as tests/test_datum.py
    return img, people.astype(np.float32).astype(np.float64)


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value, hexed", [
    (0, "00"), (1, "01"), (127, "7f"), (128, "8001"), (300, "ac02"),
    (2 ** 32, "8080808010"), (2 ** 64 - 1, "ffffffffffffffffff01"),
    (-1, "ffffffffffffffffff01"), (-5, "fbffffffffffffffff01"),
    (-2 ** 31, "80808080f8ffffffff01")])
def test_varint_encoding(value, hexed):
    raw = wire.encode_varint(value)
    assert raw.hex() == hexed
    u, pos = wire.decode_varint(b"\x00" + raw, 1)
    assert pos == 1 + len(raw)
    assert wire.to_int64(u) == value or u == value
    if -2 ** 31 <= value < 2 ** 31:
        assert wire.to_int32(u) == value


def test_varint_rejects_truncated_and_overlong_input():
    with pytest.raises(ValueError, match="truncated"):
        wire.decode_varint(b"\x80\x80", 0)
    with pytest.raises(ValueError, match="10 bytes"):
        wire.decode_varint(b"\xff" * 11, 0)
    with pytest.raises(ValueError, match="64 bits"):
        wire.encode_varint(2 ** 64)


def test_tags_and_fixed_fields():
    assert wire.encode_tag(1, wire.VARINT) == b"\x08"
    assert wire.encode_tag(6, wire.FIXED32) == b"\x35"
    assert wire.encode_tag(16, wire.LEN) == b"\x82\x01"
    assert wire.decode_tag(b"\x82\x01", 0) == (16, wire.LEN, 2)
    with pytest.raises(ValueError, match="field number 0"):
        wire.decode_tag(b"\x00", 0)
    f32 = wire.fixed32_field(3, struct.pack("<f", 2.5))
    f64 = wire.fixed64_field(4, struct.pack("<d", -1.25))
    ln = wire.len_field(5, b"abc")
    fields = list(wire.iter_fields(f32 + f64 + ln))
    assert [(f, t) for f, t, _ in fields] == [
        (3, wire.FIXED32), (4, wire.FIXED64), (5, wire.LEN)]
    assert struct.unpack("<f", fields[0][2])[0] == 2.5
    assert struct.unpack("<d", fields[1][2])[0] == -1.25
    assert bytes(fields[2][2]) == b"abc"
    with pytest.raises(ValueError):
        wire.fixed32_field(1, b"abc")


@pytest.mark.parametrize("unknown", [
    wire.varint_field(9, -7),
    wire.fixed64_field(10, b"12345678"),
    wire.len_field(11, b"skip me"),
    wire.encode_tag(12, wire.START_GROUP) + wire.varint_field(1, 5)
    + wire.encode_tag(13, wire.START_GROUP) + wire.len_field(2, b"x")
    + wire.encode_tag(13, wire.END_GROUP) + wire.encode_tag(12, wire.END_GROUP),
    wire.fixed32_field(14, b"\x00\x00\xc0\x7f"),
], ids=["varint", "fixed64", "len", "group", "fixed32"])
def test_unknown_fields_of_every_wire_type_are_skipped(unknown):
    """A Datum with an unknown field before and after its known ones
    parses as protobuf parses it (protobuf keeps the unknown field; the
    port drops it)."""
    base = pb.Datum(channels=3, label=-2, data=b"xy")
    base.float_data.append(0.5)
    raw = unknown + base.SerializeToString() + unknown
    ours = Datum.FromString(raw)
    theirs = pb.Datum.FromString(raw)
    assert (ours.channels, ours.label, ours.data, ours.float_data) == (
        theirs.channels, theirs.label, theirs.data, list(theirs.float_data))
    assert ours.SerializeToString() == base.SerializeToString()


def test_truncated_messages_raise():
    raw = pb.Datum(data=b"abcdef").SerializeToString()
    for cut in range(1, len(raw)):
        with pytest.raises(ValueError):
            Datum.FromString(raw[:cut])
    with pytest.raises(ValueError, match="end of group"):
        wire.skip_field(wire.encode_tag(2, wire.END_GROUP), 0, 1,
                        wire.START_GROUP)


# ---------------------------------------------------------------------------
# Datum against protobuf
# ---------------------------------------------------------------------------

def test_datum_wire_format_is_caffe_schema():
    """tests/test_datum.py's pins on the port's Datum."""
    d = Datum(channels=3, height=4, width=5, data=b"xyz", label=7,
              encoded=True)
    d.float_data.append(1.5)
    raw = d.SerializeToString()
    assert bytes([1 << 3 | 0]) + b"\x03" in raw
    assert bytes([2 << 3 | 0]) + b"\x04" in raw
    assert bytes([3 << 3 | 0]) + b"\x05" in raw
    assert bytes([4 << 3 | 2]) + b"\x03xyz" in raw
    assert bytes([5 << 3 | 0]) + b"\x07" in raw
    assert bytes([6 << 3 | 5]) + struct.pack("<f", 1.5) in raw
    assert bytes([7 << 3 | 0]) + b"\x01" in raw
    hand = (bytes([1 << 3 | 0]) + b"\x02" + bytes([2 << 3 | 0]) + b"\x08"
            + bytes([3 << 3 | 0]) + b"\x09" + bytes([4 << 3 | 2]) + b"\x02ab")
    e = Datum()
    assert e.ParseFromString(hand) == len(hand)
    assert (e.channels, e.height, e.width, e.data) == (2, 8, 9, b"ab")
    assert not e.encoded and not e.HasField("encoded")


def test_datum_hex_example():
    d = Datum(channels=3, height=2, width=2, encoded=False)
    d.data = b"ab"
    d.label = 0
    d.float_data = [0, float("nan"), 1.5]
    assert d.SerializeToString().hex() == (
        "0803" "1002" "1802" "22026162" "2800" "3500000000" "350000c07f"
        "350000c03f" "3800")


def _random_fields(rng):
    """Random Datum fields: some unset, NaN and negative values,
    ``label=0`` and ``encoded=False`` set explicitly, empty lists."""
    fields = {}
    for name in ("channels", "height", "width", "label"):
        pick = rng.integers(4)
        if pick == 1:
            fields[name] = 0
        elif pick == 2:
            fields[name] = int(rng.integers(-2 ** 31, 2 ** 31))
        elif pick == 3:
            fields[name] = int(rng.integers(0, 300))
    if rng.random() < 0.7:
        fields["data"] = rng.bytes(int(rng.integers(0, 300)))
    if rng.random() < 0.7:
        fields["encoded"] = bool(rng.integers(2))
    n = int(rng.integers(0, 40)) if rng.random() < 0.8 else 0
    floats = rng.normal(0, 100, n).astype(np.float32)
    floats[rng.random(n) < 0.3] = np.nan
    return fields, floats.tolist()


@pytest.mark.parametrize("seed", range(8))
def test_datum_bytes_equal_protobuf(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        fields, floats = _random_fields(rng)
        ours, theirs = Datum(**fields), pb.Datum(**fields)
        ours.float_data.extend(floats)
        theirs.float_data.extend(floats)
        raw = theirs.SerializeToString()
        assert ours.SerializeToString() == raw
        back = Datum.FromString(raw)
        assert back.SerializeToString() == raw
        assert all(back.HasField(k) == theirs.HasField(k) for k in (
            "channels", "height", "width", "data", "label", "encoded"))
        again = pb.Datum.FromString(ours.SerializeToString())
        assert again.SerializeToString() == raw


@pytest.mark.parametrize("packed", [False, True])
def test_float_data_parses_packed_and_unpacked(packed):
    vals = [1.5, float("nan"), -0.0, 3e38]
    f32 = np.asarray(vals, "<f4").tobytes()
    if packed:
        body = wire.len_field(6, f32)
    else:
        body = b"".join(wire.fixed32_field(6, f32[i:i + 4])
                        for i in range(0, 16, 4))
    raw = wire.varint_field(5, 4) + body
    ours, theirs = Datum.FromString(raw), pb.Datum.FromString(raw)
    assert np.asarray(ours.float_data, "<f4").tobytes() == \
        np.asarray(list(theirs.float_data), "<f4").tobytes() == f32
    # either form serializes unpacked, as protobuf writes proto2
    assert ours.SerializeToString() == theirs.SerializeToString()
    with pytest.raises(ValueError, match="multiple of 4"):
        Datum.FromString(wire.len_field(6, b"abc"))


def test_datum_rejects_bad_values():
    with pytest.raises(ValueError, match="int32"):
        Datum(label=2 ** 31)
    with pytest.raises(TypeError):
        Datum(data="text")
    with pytest.raises(AttributeError):
        Datum(colour=1)


# ---------------------------------------------------------------------------
# samples, shards and the dataset against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoded", [True, False])
def test_pack_unpack_roundtrip_against_jax(rng, encoded):
    img, joints = _scene(rng)
    joints[0, 3] = np.nan  # a missing part survives
    d = lmdb_ds.pack_datum(img, joints, encoded=encoded)
    want = jax_lmdb.pack_datum(img, joints, encoded=encoded)
    assert d.SerializeToString() == want.SerializeToString()
    img2, joints2 = lmdb_ds.unpack_datum(d)
    jimg, jjoints = jax_lmdb.unpack_datum(want)
    np.testing.assert_array_equal(img2, img)
    np.testing.assert_array_equal(img2, jimg)
    assert joints2.dtype == jjoints.dtype
    np.testing.assert_array_equal(joints2, jjoints)
    assert np.isnan(joints2[0, 3]).all()
    assert d.label == joints.shape[0]


def test_pack_without_people():
    img = np.zeros((16, 24, 3), np.uint8)
    d = lmdb_ds.pack_datum(img, np.zeros((0, 18, 2)), encoded=False)
    want = jax_lmdb.pack_datum(img, np.zeros((0, 18, 2)), encoded=False)
    assert d.SerializeToString() == want.SerializeToString()
    assert b"\x28\x00" in d.SerializeToString()  # label=0 is written
    _, joints = lmdb_ds.unpack_datum(d)
    assert joints.shape == (0, 18, 2)
    with pytest.raises(ValueError, match="HWC"):
        lmdb_ds.pack_datum(img[..., 0], np.zeros((0, 18, 2)))


@pytest.mark.parametrize("encoded", [True, False])
def test_shard_bytes_equal_jax(tmp_path, rng, encoded):
    samples = [_scene(rng, n=1 + i % 3) for i in range(5)]
    ours, theirs = tmp_path / "p.tpds", tmp_path / "j.tpds"
    assert lmdb_ds.write_datum_shard(str(ours), samples, encoded) == 5
    jax_lmdb.write_datum_shard(str(theirs), samples, encoded)
    assert ours.read_bytes() == theirs.read_bytes()
    reader = lmdb_ds.DatumShardReader(str(theirs))
    assert len(reader) == 5
    for i in [3, 0, 4, 2, 1]:  # random access, out of order
        img, joints = lmdb_ds.unpack_datum(reader.read(i))
        np.testing.assert_array_equal(img, samples[i][0])
        np.testing.assert_array_equal(joints, samples[i][1])
    assert [d.SerializeToString() for d in reader] == [
        d.SerializeToString() for d in jax_lmdb.DatumShardReader(str(ours))]


def test_shard_reader_rejects_bad_files(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"nope")
    with pytest.raises(ValueError, match="not a datum shard"):
        lmdb_ds.DatumShardReader(str(bad))
    good = tmp_path / "good.tpds"
    lmdb_ds.write_datum_shard(str(good), [
        (np.zeros((8, 8, 3), np.uint8), np.zeros((0, 18, 2)))], False)
    raw = good.read_bytes()
    for cut in (len(raw) - 1, 6):
        bad.write_bytes(raw[:cut])
        with pytest.raises(ValueError, match="truncated"):
            lmdb_ds.DatumShardReader(str(bad))


def test_lmdb_is_import_gated():
    """Without the ``lmdb`` module (the card machine has none) the LMDB
    store raises as the JAX one does; with it, this test skips."""
    assert lmdb_ds.HAS_LMDB == jax_lmdb.HAS_LMDB
    if lmdb_ds.HAS_LMDB:
        pytest.skip("lmdb is installed")
    with pytest.raises(ImportError, match="lmdb"):
        lmdb_ds.write_lmdb("unused", [])
    with pytest.raises(ImportError, match="lmdb"):
        lmdb_ds.LmdbDatumReader("unused")


@pytest.mark.parametrize("device_targets", [False, True])
def test_datum_pose_dataset_matches_jax_and_the_file_path(
        tmp_path, rng, device_targets):
    """The port's Datum feed gives JAX's Datum batches bit for bit, and
    the port's file path's (augment off)."""
    import cv2

    samples = [_scene(rng) for _ in range(4)]
    shard = str(tmp_path / "s.tpds")
    lmdb_ds.write_datum_shard(shard, samples)
    anns = []
    for i, (img, joints) in enumerate(samples):
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, img)
        anns.append(Annotation(img_path=p, width=img.shape[1],
                               height=img.shape[0], joints=joints))
    kw = dict(input_size=(64, 64), batch_size=2, augment=False, seed=3,
              device_targets=device_targets)
    ours = list(lmdb_ds.DatumPoseDataset(lmdb_ds.DatumShardReader(shard),
                                         **kw))
    theirs = list(jax_lmdb.DatumPoseDataset(
        jax_lmdb.DatumShardReader(shard), **kw))
    files = list(PoseDataset(anns, **kw))
    assert len(ours) == len(theirs) == len(files) == 2
    for bo, bt, bf in zip(ours, theirs, files):
        assert bo.keys() == bt.keys() == bf.keys()
        for k in bo:
            np.testing.assert_array_equal(bo[k], bt[k])
            np.testing.assert_array_equal(bo[k], bf[k])
    # the augment chain is the JAX one's too
    kw.update(augment=True)
    for bo, bt in zip(lmdb_ds.DatumPoseDataset(
            lmdb_ds.DatumShardReader(shard), **kw),
            jax_lmdb.DatumPoseDataset(jax_lmdb.DatumShardReader(shard), **kw)):
        for k in bo:
            np.testing.assert_array_equal(bo[k], bt[k])


def test_train_cli_datum_shard(tmp_path, rng):
    """``tfpose-torch-train --datum-shard`` on the CPU, in one process
    and with ``--mesh-data 2`` (two gloo ranks; rank 0 reads the shard
    and hands each batch to the other): the same first loss (rtol
    1e-5)."""
    from tfpose_tpu_torch.cli import train as train_cli

    shard = str(tmp_path / "train.tpds")
    lmdb_ds.write_datum_shard(shard, [_scene(rng, h=32, w=32, n=1)
                                      for _ in range(8)])
    argv = ["--model", "mobilenet_thin", "--input-size", "32x32",
            "--batchsize", "4", "--max-steps", "2", "--log-every", "1",
            "--datum-shard", shard, "--device", "cpu"]
    state = train_cli.main(argv)
    assert state.step == 2
    assert all(math.isfinite(h["loss"]) for h in state.history)
    mesh = train_cli.main(argv + ["--mesh-data", "2"])
    assert mesh.step == 2
    assert mesh.history[0]["loss"] == pytest.approx(
        state.history[0]["loss"], rel=1e-5)
    with pytest.raises(ValueError, match="fewer than --batchsize"):
        train_cli.main(argv[:argv.index("--batchsize") + 1] + ["16"]
                       + argv[argv.index("--batchsize") + 2:])


# ---------------------------------------------------------------------------
# the committed fixture (read again on the card by test_torch_cuda.py)
# ---------------------------------------------------------------------------

def test_datum_fixture(tmp_path):
    """``datum_jax.tpds`` is what ``tests/make_conversion_fixtures.py``
    writes with the JAX package; the port parses and re-serializes every
    record byte for byte, its PNG records decode to its raw ones, and
    the port's writer gives its raw half again."""
    raw = open(DATUM, "rb").read()
    samples = datum_samples()
    n = len(PEOPLE)
    reader = lmdb_ds.DatumShardReader(DATUM)
    assert len(reader) == 2 * n
    offsets = reader._offsets
    for i, d in enumerate(reader):
        off, ln = offsets[i]
        assert d.SerializeToString() == raw[off:off + ln]
        assert d.encoded == (i >= n)
        assert d.label == PEOPLE[i % n]
        img, joints = lmdb_ds.unpack_datum(d)
        assert img.shape == (DATUM_WH[1], DATUM_WH[0], 3)
        np.testing.assert_array_equal(img, samples[i % n][0])
        np.testing.assert_array_equal(joints, samples[i % n][1])
    path = str(tmp_path / "raw.tpds")
    lmdb_ds.write_datum_shard(path, samples, encoded=False)
    assert open(path, "rb").read() == raw[:offsets[n][0] - 4]
    path = str(tmp_path / "png.tpds")
    lmdb_ds.write_datum_shard(path, samples, encoded=True)
    assert open(path, "rb").read()[4:] == raw[offsets[n][0] - 4:]
    assert os.path.getsize(DATUM) < 150_000
