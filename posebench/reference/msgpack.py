"""A frozen copy of the program's reader of flax msgpack checkpoints
(``tfpose_tpu_torch/convert/checkpoint.py``: ``_Reader`` and
``load_flax_msgpack``), so that the reference reads the raw weights
file itself and shares no code with the program under test.

The file is what ``flax.serialization.to_bytes`` writes: msgpack maps
keyed by module name, every array packed as msgpack ext type 1 holding
the triple ``(shape, dtype_name, bytes)``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1  # flax _MsgpackExtType.ndarray


class _Reader:
    """Decodes the msgpack subset flax writes: maps, arrays, str, bin,
    ints, floats, nil/bool and ext type 1. Anything else raises."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", self._bin), 0xC5: (">H", self._bin),
            0xC6: (">I", self._bin),
            0xD9: (">B", self._str), 0xDA: (">H", self._str),
            0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if b in sized:
            fmt, fn = sized[b]
            return fn(self._unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self._unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self._ext(self._unpack(ext[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            if not isinstance(key, str):
                raise ValueError(f"non-string map key {key!r}")
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _bin(self, n: int) -> memoryview:
        return self._take(n)

    def _ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        triple = inner.read()
        if inner.pos != len(payload) or not (
                isinstance(triple, list) and len(triple) == 3):
            raise ValueError("malformed ndarray ext payload")
        shape, dtype_name, data = triple
        dtype = np.dtype(dtype_name)
        if dtype.hasobject:
            raise ValueError(f"unsupported array dtype {dtype_name!r}")
        return np.frombuffer(data, dtype=dtype).reshape(shape)


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by ``flax.serialization.to_bytes`` into
    nested dicts of numpy arrays (what ``msgpack_restore`` returns).
    Arrays are read-only views into the file's bytes: no per-byte copy."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    reader = _Reader(buf)
    tree = reader.read()
    if reader.pos != len(buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: top level is not a map")
    _reject_chunked(tree)
    return tree


def _reject_chunked(tree: Dict[str, Any]) -> None:
    for key, val in tree.items():
        if key == "__msgpack_chunked_array__":
            raise ValueError("chunked flax arrays (> 1 GiB) are not supported")
        if isinstance(val, dict):
            _reject_chunked(val)
