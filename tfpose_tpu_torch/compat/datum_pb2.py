"""The Caffe ``Datum`` record — counterpart of
``tfpose_tpu/compat/datum_pb2.py``, the protoc output of the public
schema (proto2, package ``tfpose_tpu``)::

    message Datum {
      optional int32 channels = 1;
      optional int32 height = 2;
      optional int32 width = 3;
      optional bytes data = 4;
      optional int32 label = 5;
      repeated float float_data = 6;
      optional bool encoded = 7 [default = false];
    }

written by hand over ``compat/wire.py``, since the card machine has no
``protobuf``. It serializes as protobuf does, byte for byte: fields in
field-number order; an optional field once it was set (proto2 keeps
presence, so ``label=0`` writes ``28 00`` and ``encoded=False`` writes
``38 00``) and not when it was never set; ``float_data`` unpacked, one
``35 <float32 LE>`` per value. The parser also takes a packed
``float_data``, lets the last of a repeated scalar win, and skips fields
it does not know (they are not kept).
"""

from __future__ import annotations

import numpy as np

from tfpose_tpu_torch.compat import wire

# field name -> (number, kind, default), in field-number order
_FIELDS = {
    "channels": (1, "int32", 0),
    "height": (2, "int32", 0),
    "width": (3, "int32", 0),
    "data": (4, "bytes", b""),
    "label": (5, "int32", 0),
    "float_data": (6, "floats", None),
    "encoded": (7, "bool", False),
}
_BY_NUMBER = {num: (name, kind) for name, (num, kind, _) in _FIELDS.items()}


def _check(name: str, kind: str, value):
    if kind == "int32":
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise TypeError(f"Datum.{name} takes an int, got {value!r}")
        if not -2 ** 31 <= int(value) < 2 ** 31:
            raise ValueError(f"Datum.{name}={value} is out of int32 range")
        return int(value)
    if kind == "bytes":
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"Datum.{name} takes bytes, got {type(value)}")
        return bytes(value)
    return bool(value)


class Datum:
    """One Caffe ``Datum``: ``channels``, ``height``, ``width``,
    ``data``, ``label``, ``float_data`` (a list of floats) and
    ``encoded``, with ``SerializeToString`` / ``ParseFromString``."""

    def __init__(self, **fields):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "float_data", [])
        for name, value in fields.items():
            setattr(self, name, value)

    def __getattr__(self, name):
        if name in _FIELDS:
            return self._values.get(name, _FIELDS[name][2])
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name not in _FIELDS:
            raise AttributeError(f"Datum has no field {name!r}")
        if name == "float_data":
            object.__setattr__(self, name, [float(v) for v in value])
        else:
            self._values[name] = _check(name, _FIELDS[name][1], value)

    def HasField(self, name: str) -> bool:
        """Whether an optional field was set (or parsed)."""
        if name not in _FIELDS or name == "float_data":
            raise ValueError(f"{name!r} is not an optional field of Datum")
        return name in self._values

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for name, (num, kind, _) in _FIELDS.items():
            if kind == "floats":
                raw = np.asarray(self.float_data, "<f4").tobytes()
                tag = wire.encode_tag(num, wire.FIXED32)
                for i in range(0, len(raw), 4):
                    out += tag + raw[i:i + 4]
            elif name in self._values:
                value = self._values[name]
                out += (wire.len_field(num, value) if kind == "bytes"
                        else wire.varint_field(num, int(value)))
        return bytes(out)

    def ParseFromString(self, payload) -> int:
        """Replace this record's fields by the message in ``payload``;
        returns its length, as protobuf does."""
        self._values.clear()
        floats = []
        for num, wire_type, value in wire.iter_fields(payload):
            name, kind = _BY_NUMBER.get(num, (None, None))
            if kind == "floats" and wire_type in (wire.FIXED32, wire.LEN):
                if len(value) % 4:  # a packed run of floats
                    raise ValueError("packed float_data is not a multiple "
                                     "of 4 bytes")
                floats.append(bytes(value))
            elif kind == "bytes" and wire_type == wire.LEN:
                self._values[name] = bytes(value)
            elif kind == "int32" and wire_type == wire.VARINT:
                self._values[name] = wire.to_int32(value)
            elif kind == "bool" and wire_type == wire.VARINT:
                self._values[name] = value != 0
        object.__setattr__(self, "float_data", np.frombuffer(
            b"".join(floats), "<f4").tolist())
        return len(payload)

    @classmethod
    def FromString(cls, payload) -> "Datum":
        d = cls()
        d.ParseFromString(payload)
        return d
