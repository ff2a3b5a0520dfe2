"""Legacy Caffe ``Datum`` records as training data — port of
``tfpose_tpu/train/lmdb_dataset.py`` (the reference's LMDB COCO packing,
``tf_pose/datum_pb2.py``).

- :func:`pack_datum` / :func:`unpack_datum` turn one training sample
  (BGR image + per-person 18-part joints) into a ``Datum`` and back. The
  image rides ``data``: PNG when ``encoded``, raw CHW planes otherwise;
  the joints ride ``float_data`` as ``[n_people, 18*2*n_people floats
  row-major, NaN for missing]``.
- :func:`write_datum_shard` / :class:`DatumShardReader`: one file,
  ``TPDS`` then length-prefixed ``Datum`` payloads (byte for byte the
  JAX writer's).
- :func:`write_lmdb` / :class:`LmdbDatumReader`: real LMDB, where the
  ``lmdb`` module exists (``HAS_LMDB``).
- :class:`DatumPoseDataset`: :class:`PoseDataset` fed from a reader.

``Datum`` is the port's own codec (``compat/datum_pb2.py``), not
protobuf's. cv2 is imported only to encode and decode PNG records
(:func:`_png_encode`, :func:`_png_decode`), so raw records need no cv2.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Tuple

import numpy as np

from tfpose_tpu_torch.compat.datum_pb2 import Datum
from tfpose_tpu_torch.train.dataset import PoseDataset

try:  # pragma: no cover - exercised only where lmdb exists
    import lmdb  # type: ignore

    HAS_LMDB = True
except ImportError:  # pragma: no cover
    lmdb = None
    HAS_LMDB = False


def _png_encode(img_bgr: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", img_bgr)
    if not ok:
        raise ValueError("png encode failed")
    return buf.tobytes()


def _png_decode(data: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("image decode failed")
    return img


def pack_datum(img_bgr: np.ndarray, joints: np.ndarray,
               encoded: bool = True) -> Datum:
    """(H, W, 3) uint8 BGR + (n_people, 18, 2) float joints -> Datum."""
    if img_bgr.dtype != np.uint8 or img_bgr.ndim != 3:
        raise ValueError("expected HWC uint8 BGR image")
    h, w, c = img_bgr.shape
    d = Datum(channels=c, height=h, width=w, encoded=encoded)
    if encoded:
        d.data = _png_encode(img_bgr)
    else:  # Caffe raw layout: CHW planes
        d.data = np.ascontiguousarray(img_bgr.transpose(2, 0, 1)).tobytes()
    joints = np.asarray(joints, dtype=np.float32)
    if joints.size and joints.shape[1:] != (18, 2):
        raise ValueError("joints must be (n_people, 18, 2)")
    n = int(joints.shape[0]) if joints.size else 0
    d.label = n
    d.float_data = [float(n)] + joints.ravel().tolist()
    return d


def unpack_datum(d: Datum) -> Tuple[np.ndarray, np.ndarray]:
    """Datum -> ((H, W, 3) uint8 BGR, (n_people, 18, 2) float64 joints)."""
    if d.encoded:
        img = _png_decode(d.data)
    else:
        img = np.ascontiguousarray(np.frombuffer(d.data, np.uint8).reshape(
            d.channels, d.height, d.width).transpose(1, 2, 0))
    fd = np.asarray(d.float_data, dtype=np.float32)
    if fd.size == 0:
        return img, np.zeros((0, 18, 2), np.float32)
    n = int(fd[0])
    return img, fd[1:1 + n * 36].reshape(n, 18, 2).astype(np.float64)


_MAGIC = b"TPDS"  # shard header


def write_datum_shard(path: str,
                      samples: Iterable[Tuple[np.ndarray, np.ndarray]],
                      encoded: bool = True) -> int:
    """Write (img, joints) samples as a length-prefixed Datum shard;
    returns the number of records."""
    n = 0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        for img, joints in samples:
            payload = pack_datum(img, joints,
                                 encoded=encoded).SerializeToString()
            f.write(struct.pack("<I", len(payload)))
            f.write(payload)
            n += 1
    return n


class DatumShardReader:
    """Random-access reader over a length-prefixed Datum shard file."""

    def __init__(self, path: str):
        self.path = path
        self._offsets: List[Tuple[int, int]] = []
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if f.read(4) != _MAGIC:
                raise ValueError(f"{path}: not a datum shard")
            pos = 4
            while pos < size:
                hdr = f.read(4)
                (ln,) = struct.unpack("<I", hdr) if len(hdr) == 4 else (-1,)
                if ln < 0 or pos + 4 + ln > size:
                    raise ValueError(f"{path}: truncated record at {pos}")
                self._offsets.append((pos + 4, ln))
                pos += 4 + ln
                f.seek(pos)

    def __len__(self) -> int:
        return len(self._offsets)

    def read(self, i: int) -> Datum:
        off, ln = self._offsets[i]
        with open(self.path, "rb") as f:
            f.seek(off)
            payload = f.read(ln)
        return Datum.FromString(payload)

    def __iter__(self) -> Iterator[Datum]:
        for i in range(len(self)):
            yield self.read(i)


def write_lmdb(path: str,
               samples: Iterable[Tuple[np.ndarray, np.ndarray]],
               encoded: bool = True,
               map_size: int = 1 << 30) -> int:  # pragma: no cover
    """Write samples into a real LMDB (requires the lmdb module)."""
    if not HAS_LMDB:
        raise ImportError("lmdb is not available in this environment; "
                          "use write_datum_shard instead")
    env = lmdb.open(path, map_size=map_size)
    n = 0
    with env.begin(write=True) as txn:
        for img, joints in samples:
            key = f"{n:08d}".encode()
            txn.put(key, pack_datum(img, joints,
                                    encoded=encoded).SerializeToString())
            n += 1
    env.close()
    return n


class LmdbDatumReader:  # pragma: no cover - needs the lmdb module
    """Sequential-key LMDB reader matching ``write_lmdb``'s layout."""

    def __init__(self, path: str):
        if not HAS_LMDB:
            raise ImportError("lmdb is not available in this environment")
        self.env = lmdb.open(path, readonly=True, lock=False)
        with self.env.begin() as txn:
            self._n = txn.stat()["entries"]

    def __len__(self) -> int:
        return self._n

    def read(self, i: int) -> Datum:
        with self.env.begin() as txn:
            payload = txn.get(f"{i:08d}".encode())
        return Datum.FromString(payload)

    def __iter__(self) -> Iterator[Datum]:
        for i in range(len(self)):
            yield self.read(i)


class DatumPoseDataset(PoseDataset):
    """:class:`PoseDataset` fed from Datum records (a shard or LMDB
    reader): the same augment chain and rasterisers, with images and
    joints decoded from the records instead of read from disk."""

    def __init__(self, reader, **kwargs):
        self.reader = reader
        super().__init__(annotations=list(range(len(reader))), **kwargs)

    def _load_one(self, idx: int):  # type: ignore[override]
        img, joints = unpack_datum(self.reader.read(idx))
        return self._prepare(img, joints.copy())
