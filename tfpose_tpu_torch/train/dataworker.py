"""Remote data workers — port of ``tfpose_tpu/train/dataworker.py``
(the same wire format, so a worker of either package feeds a trainer of
either), reference ``tf_pose/pose_dataworker.py``
(tensorpack ``send_dataflow_zmq``: augmentation on other hosts
streaming batches to the trainer over ZMQ; SURVEY.md §2.5).

Without the tensorpack/ZMQ dependency: a
length-prefixed TCP batch stream (npz payloads). Run ``serve_batches``
on CPU hosts next to the data; the trainer consumes ``RemoteBatches``
and overlaps host->device transfer with compute.
"""

from __future__ import annotations

import io
import logging
import socket
import struct
import threading
from typing import Dict, Iterable, Iterator

import numpy as np

logger = logging.getLogger("tfpose_tpu_torch.dataworker")


def _pack(batch: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **batch)
    return buf.getvalue()


def _unpack(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def serve_batches(batches: Iterable[Dict[str, np.ndarray]],
                  host: str = "127.0.0.1", port: int = 0):
    """Worker side: stream batches to whoever connects. Returns
    (address, stop_fn); serving happens on a daemon thread."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(4)
    address = srv.getsockname()
    stop = threading.Event()

    def run():
        while not stop.is_set():
            try:
                srv.settimeout(0.5)
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            try:
                for batch in batches:
                    if stop.is_set():
                        break
                    data = _pack(batch)
                    conn.sendall(struct.pack(">I", len(data)) + data)
            except (BrokenPipeError, ConnectionError):
                pass
            finally:
                conn.close()
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    logger.info("data worker serving on %s:%d", *address)
    return address, stop.set


class RemoteBatches:
    """Trainer side: iterate batches from one or more workers
    (round-robin), the ``RemoteDataZMQ`` analogue."""

    def __init__(self, addresses):
        self.socks = [socket.create_connection(a) for a in addresses]

    def _recv(self, sock) -> Dict[str, np.ndarray]:
        hdr = b""
        while len(hdr) < 4:
            chunk = sock.recv(4 - len(hdr))
            if not chunk:
                raise ConnectionError("worker closed")
            hdr += chunk
        (length,) = struct.unpack(">I", hdr)
        buf = bytearray()
        while len(buf) < length:
            chunk = sock.recv(min(1 << 20, length - len(buf)))
            if not chunk:
                raise ConnectionError("worker closed")
            buf.extend(chunk)
        return _unpack(bytes(buf))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self._recv(self.socks[i % len(self.socks)])
            i += 1

    def close(self):
        for s in self.socks:
            s.close()
