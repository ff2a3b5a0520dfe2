"""Checkpoints of the port, in the JAX package's format.

The JAX package saves a flax variables pytree with
``flax.serialization.to_bytes`` (``tfpose_tpu/convert/checkpoint.py``):
msgpack maps keyed by module name (sorted, as JAX's tree map leaves
them), with every array packed as msgpack ext type 1 holding the msgpack
triple ``(shape, dtype_name, bytes)``. :func:`load_flax_msgpack` decodes
that format with its own small msgpack reader and
:func:`save_flax_msgpack` writes it (numpy only: the port needs neither
flax nor the ``msgpack`` package). :func:`variables_from_numpy` copies
the nested dict (``params``, ``batch_stats`` and the int8 backbone's
``quant``) into the port's ``nn.Module``, whose submodules carry the
flax module names one to one; :func:`variables_to_numpy` is its inverse.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

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


# flax leaf name -> torch state_dict suffix, per variable collection
_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "alpha"): "weight",   # a PReLU's slopes (BODY_25)
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("quant", "in_absmax"): "in_absmax",
}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def variables_from_numpy(net: nn.Module,
                         variables: Dict[str, Any]) -> nn.Module:
    """Copy a flax variables tree (``{"params": ..., "batch_stats":
    ..., "quant": ...}`` of numpy arrays) into ``net`` in place and
    return it.

    Conv kernels go HWIO -> OIHW (a depthwise kernel (kh, kw, 1, C) thus
    becomes (C, 1, kh, kw)); BN scale/bias/mean/var and a conv's
    ``in_absmax`` (a network in a quantisation mode) map one to one. A
    leaf with no counterpart in ``net``, a parameter or buffer left
    unfilled, or a shape mismatch raises ``KeyError``/``ValueError``.
    """
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    filled = {}
    for collection, tree in variables.items():
        for path, arr in _flatten(tree):
            suffix = _LEAF_NAMES.get((collection, path[-1]))
            key = ".".join(path[:-1] + (suffix or path[-1],))
            if suffix is None or key not in state:
                raise KeyError(f"no counterpart for {collection}/"
                               f"{'/'.join(path)} in {type(net).__name__}")
            arr = np.array(arr, np.float32)  # writable copy
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"module shape {tuple(state[key].shape)}")
            filled[key] = torch.from_numpy(np.array(arr, order="C"))
    missing = sorted(set(state) - set(filled))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} entries, "
                       f"e.g. {missing[:3]}")
    with torch.no_grad():
        for key, val in filled.items():
            state[key].copy_(val)
    return net


def variables_to_numpy(net: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`variables_from_numpy`: ``net``'s weights as
    the flax variables tree of float32 numpy arrays, ``params`` (conv
    kernels OIHW -> HWIO), ``batch_stats`` and, where the convs carry
    ``in_absmax``, ``quant``."""
    from tfpose_tpu_torch.models.layers import SameConv2d

    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {},
                                      "quant": {}}
    covered = set()

    def put(collection, path, leaf, tensor):
        node = out[collection]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = tensor.detach().float().cpu().numpy().copy()

    for name, mod in net.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, SameConv2d):
            put("params", path, "kernel", mod.weight.permute(2, 3, 1, 0))
            if mod.bias is not None:
                put("params", path, "bias", mod.bias)
            if "in_absmax" in mod._buffers:
                put("quant", path, "in_absmax", mod.in_absmax)
        elif isinstance(mod, nn.BatchNorm2d):
            put("params", path, "scale", mod.weight)
            put("params", path, "bias", mod.bias)
            put("batch_stats", path, "mean", mod.running_mean)
            put("batch_stats", path, "var", mod.running_var)
        elif isinstance(mod, nn.PReLU):
            put("params", path, "alpha", mod.weight)
        else:
            continue
        covered.update(f"{name}.{k}" for k, _ in mod.named_parameters(
            recurse=False))
    left = {k for k, _ in net.named_parameters()} - covered
    if left:
        raise KeyError(f"no flax counterpart for {sorted(left)[:3]}")
    return {k: v for k, v in out.items() if v}


def _pack(obj: Any, out: bytearray) -> None:
    """Append ``obj`` in the msgpack encoding that flax's ``to_bytes``
    produces (msgpack-python with ``use_bin_type``): the shortest header
    for each map, array, str, bin, int and ext; dict keys sorted."""
    def header(n, fix, fix_max, codes):
        if fix is not None and n <= fix_max:
            out.append(fix | n)
            return
        for code, fmt, top in codes:
            if n <= top:
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError("msgpack object too large")

    sized = ((">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF))
    if isinstance(obj, dict):
        header(len(obj), 0x80, 15, [(0xDE, ">H", 0xFFFF),
                                    (0xDF, ">I", 0xFFFFFFFF)])
        for key in sorted(obj):
            _pack(str(key), out)
            _pack(obj[key], out)
    elif isinstance(obj, (list, tuple)):
        header(len(obj), 0x90, 15, [(0xDC, ">H", 0xFFFF),
                                    (0xDD, ">I", 0xFFFFFFFF)])
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        header(len(data), 0xA0, 31,
               [(c, f, t) for c, (f, t) in zip((0xD9, 0xDA, 0xDB), sized)])
        out.extend(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        header(len(data), None, 0,
               [(c, f, t) for c, (f, t) in zip((0xC4, 0xC5, 0xC6), sized)])
        out.extend(data)
    elif isinstance(obj, (int, np.integer)) and not isinstance(obj, bool):
        n = int(obj)
        if 0 <= n <= 0x7F or -32 <= n < 0:
            out.extend(struct.pack(">b" if n < 0 else ">B", n))
        elif n > 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 2 ** 64 - 1)):
                if n <= top:
                    out.append(code)
                    out.extend(struct.pack(fmt, n))
                    break
        else:
            for code, fmt, lo in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                                  (0xD2, ">i", -2 ** 31),
                                  (0xD3, ">q", -2 ** 63)):
                if n >= lo:
                    out.append(code)
                    out.extend(struct.pack(fmt, n))
                    break
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError(f"unsupported array dtype {obj.dtype}")
        if obj.nbytes > 2 ** 30:
            raise ValueError("arrays over 1 GiB are chunked by flax; "
                             "not supported")
        inner = bytearray()
        _pack([list(obj.shape), obj.dtype.name,
               np.ascontiguousarray(obj).tobytes()], inner)
        n = len(inner)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            header(n, None, 0,
                   [(c, f, t) for c, (f, t) in zip((0xC7, 0xC8, 0xC9), sized)])
        out.extend(struct.pack(">b", _EXT_NDARRAY))
        out.extend(inner)
    else:
        raise ValueError(f"cannot pack {type(obj).__name__}")


def save_flax_msgpack(path: str, variables: Dict[str, Any]) -> None:
    """Write a variables tree of numpy arrays as the JAX package's
    ``save_params`` does (``flax.serialization.to_bytes``), so that its
    ``load_params`` and :func:`load_flax_msgpack` read it back."""
    buf = bytearray()
    _pack(variables, buf)
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with open(path, "wb") as f:
        f.write(buf)
