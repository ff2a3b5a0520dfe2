"""Protocol-buffers wire format, the subset the port reads and writes.

The card machine has neither ``protobuf`` nor TensorFlow, so the port
encodes its two protobuf formats itself: the Caffe ``Datum``
(``compat/datum_pb2.py``) and the TF1 ``GraphDef`` of a frozen graph
(``convert/graphdef.py``). A message is a sequence of fields, each a tag
(``field_number << 3 | wire_type``, a varint) and a value:

* wire type 0: a varint, little-endian base-128 (an int32 or int64 below
  zero takes ten bytes, its 64-bit two's complement);
* 1: eight bytes (fixed64, double);
* 2: a varint length, then that many bytes (bytes, strings, messages and
  packed repeated scalars);
* 3 / 4: the start and end of a group (proto2's deprecated groups);
* 5: four bytes (fixed32, float).

:func:`iter_fields` walks a message and skips groups; readers skip the
fields they do not know, as protobuf's parsers do.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple, Union

import numpy as np

VARINT, FIXED64, LEN, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5
_MASK64 = (1 << 64) - 1

Buffer = Union[bytes, bytearray, memoryview]


def encode_varint(value: int) -> bytes:
    """A varint of ``value``; a negative value is written as its 64-bit
    two's complement (ten bytes), as protobuf writes int32 and int64."""
    if value < 0:
        value &= _MASK64
    if value > _MASK64:
        raise ValueError(f"varint {value} exceeds 64 bits")
    out = bytearray()
    while value > 0x7F:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_varint(buf: Buffer, pos: int) -> Tuple[int, int]:
    """(unsigned value, position after it) of the varint at ``pos``."""
    value = shift = 0
    for i in range(10):
        if pos + i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos + i]
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value & _MASK64, pos + i + 1
        shift += 7
    raise ValueError("varint longer than 10 bytes")


def to_int32(value: int) -> int:
    """A decoded varint as protobuf's int32 (its low 32 bits, signed)."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def to_int64(value: int) -> int:
    """A decoded varint as protobuf's int64."""
    return value - (1 << 64) if value >= 1 << 63 else value


def encode_tag(field: int, wire_type: int) -> bytes:
    return encode_varint(field << 3 | wire_type)


def decode_tag(buf: Buffer, pos: int) -> Tuple[int, int, int]:
    """(field number, wire type, position after the tag)."""
    tag, pos = decode_varint(buf, pos)
    field, wire_type = tag >> 3, tag & 7
    if field == 0:
        raise ValueError("field number 0")
    return field, wire_type, pos


def varint_field(field: int, value: int) -> bytes:
    return encode_tag(field, VARINT) + encode_varint(value)


def len_field(field: int, data: Buffer) -> bytes:
    """A length-delimited field: bytes, a string or a nested message."""
    return encode_tag(field, LEN) + encode_varint(len(data)) + bytes(data)


def fixed32_field(field: int, data: bytes) -> bytes:
    if len(data) != 4:
        raise ValueError("fixed32 needs 4 bytes")
    return encode_tag(field, FIXED32) + data


def fixed64_field(field: int, data: bytes) -> bytes:
    if len(data) != 8:
        raise ValueError("fixed64 needs 8 bytes")
    return encode_tag(field, FIXED64) + data


def _take(buf: Buffer, pos: int, n: int) -> int:
    if n < 0 or pos + n > len(buf):
        raise ValueError("truncated field")
    return pos + n


def skip_field(buf: Buffer, pos: int, field: int, wire_type: int) -> int:
    """The position after the value of a field whose tag ended at
    ``pos``; a group is skipped up to its matching end tag."""
    if wire_type == VARINT:
        return decode_varint(buf, pos)[1]
    if wire_type == FIXED64:
        return _take(buf, pos, 8)
    if wire_type == FIXED32:
        return _take(buf, pos, 4)
    if wire_type == LEN:
        n, pos = decode_varint(buf, pos)
        return _take(buf, pos, n)
    if wire_type == START_GROUP:
        while True:
            inner, wt, pos = decode_tag(buf, pos)
            if wt == END_GROUP:
                if inner != field:
                    raise ValueError("mismatched end of group")
                return pos
            pos = skip_field(buf, pos, inner, wt)
    raise ValueError(f"unexpected wire type {wire_type}")


def iter_fields(buf: Buffer) -> Iterator[Tuple[int, int, Union[int,
                                                               memoryview]]]:
    """(field number, wire type, value) of each field of a message:
    the unsigned integer of a varint, else the value's bytes (a
    memoryview into ``buf``). Groups are skipped."""
    mv = memoryview(buf)
    pos = 0
    while pos < len(mv):
        field, wire_type, pos = decode_tag(mv, pos)
        if wire_type == VARINT:
            value, pos = decode_varint(mv, pos)
            yield field, wire_type, value
        elif wire_type == LEN:
            n, start = decode_varint(mv, pos)
            pos = _take(mv, start, n)
            yield field, wire_type, mv[start:pos]
        elif wire_type in (FIXED32, FIXED64):
            start = pos
            pos = _take(mv, pos, 4 if wire_type == FIXED32 else 8)
            yield field, wire_type, mv[start:pos]
        elif wire_type == START_GROUP:
            pos = skip_field(mv, pos, field, wire_type)
        else:
            raise ValueError(f"unexpected wire type {wire_type}")


def packed_varints(data: Buffer) -> List[int]:
    """The unsigned values of a packed repeated varint field."""
    out, pos = [], 0
    while pos < len(data):
        value, pos = decode_varint(data, pos)
        out.append(value)
    return out


def packed_fixed32(data: Buffer, dtype: str = "<f4") -> np.ndarray:
    """A packed repeated fixed32 field (floats by default)."""
    if len(data) % 4:
        raise ValueError("packed fixed32 field not a multiple of 4 bytes")
    return np.frombuffer(bytes(data), dtype)
