"""Pose estimation network service — port of
``tfpose_tpu/serving/service.py``, the transport-agnostic equivalent of
the reference ROS node (``scripts/broadcaster_ros.py``: subscribe image
topic -> inference -> publish ``Persons``).

Protocol (TCP, length-prefixed), the JAX package's byte for byte, so a
client of either package talks to a server of the other:
  request:  4-byte big-endian length + payload
            payload = 1-byte format tag ('J' jpeg | 'R' raw) +
            for raw: 4B h, 4B w, then h*w*3 uint8 BGR; for jpeg: bytes
  response: 4-byte length + UTF-8 JSON of Persons.to_dict(), or of
            ``{"error": reason}`` for a payload that cannot be decoded

A threaded server wraps one estimator. The estimator keeps per-call
state (``heatMat``, ``pafMat``, ``last_peak_saturated``) and the kernel
wrappers count launches, so handler threads call it one at a time: under
a lock at ``max_batch=1``, through the batcher's single worker thread
above it. A JPEG payload needs cv2, imported when one arrives; without
cv2 the reply is an error that names the reason.
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from tfpose_tpu_torch.serving.batcher import DynamicBatcher
from tfpose_tpu_torch.serving.messages import Persons, humans_to_msg

logger = logging.getLogger("tfpose_tpu_torch.serving")


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _decode_payload(payload: bytes) -> np.ndarray:
    """A request payload -> (H, W, 3) uint8 BGR; ``ValueError`` naming
    the reason when it cannot be decoded."""
    tag = payload[:1]
    if tag == b"R":
        if len(payload) < 9:
            raise ValueError("raw payload shorter than its 8-byte header")
        h, w = struct.unpack(">II", payload[1:9])
        if len(payload) - 9 < h * w * 3:
            raise ValueError(f"raw payload holds {len(payload) - 9} bytes, "
                             f"want {h}x{w}x3")
        # a writable copy: the estimator hands it to torch
        return np.frombuffer(payload, np.uint8, h * w * 3, 9).reshape(
            h, w, 3).copy()
    if tag == b"J":
        try:
            import cv2
        except ImportError:
            raise ValueError("a JPEG payload needs cv2, which this server "
                             "lacks; send raw frames (tag 'R')") from None
        img = cv2.imdecode(np.frombuffer(payload[1:], np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("the JPEG payload could not be decoded")
        return img
    raise ValueError("bad payload (tag must be 'J' or 'R')")


class PoseService:
    """TCP server around a TfPoseEstimator."""

    def __init__(self, estimator, host: str = "127.0.0.1", port: int = 0,
                 upsample_size: float = 4.0, max_batch: int = 1,
                 max_wait_ms: float = 5.0):
        self.estimator = estimator
        self.ratio = upsample_size
        self._lock = threading.Lock()
        self._batcher = None
        if max_batch > 1:
            self._batcher = DynamicBatcher(
                estimator, max_batch=max_batch, max_wait_ms=max_wait_ms,
                upsample_size=upsample_size)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        (length,) = struct.unpack(
                            ">I", _recv_exact(self.request, 4))
                        payload = _recv_exact(self.request, length)
                    except (ConnectionError, struct.error):
                        return
                    resp = outer._process(payload)
                    data = json.dumps(resp).encode()
                    self.request.sendall(struct.pack(">I", len(data)) + data)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _process(self, payload: bytes) -> dict:
        try:
            img = _decode_payload(payload)
        except ValueError as exc:
            return {"error": str(exc)}
        if self._batcher is not None:
            # concurrent client threads coalesce into one device batch
            humans = self._batcher.submit(img).result()
        else:
            with self._lock:
                humans = self.estimator.inference(
                    img, resize_to_default=True, upsample_size=self.ratio)
        msg = humans_to_msg(humans, img.shape[1], img.shape[0],
                            self.estimator.skeleton)
        return msg.to_dict()

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        logger.info("PoseService on %s:%d", *self.address)
        return self.address

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._batcher is not None:
            self._batcher.stop()


class PoseClient:
    """Client for PoseService."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))

    def infer_raw(self, img: np.ndarray) -> Persons:
        h, w = img.shape[:2]
        payload = (b"R" + struct.pack(">II", h, w)
                   + np.ascontiguousarray(img, np.uint8).tobytes())
        return self._roundtrip(payload)

    def infer_jpeg(self, jpeg_bytes: bytes) -> Persons:
        return self._roundtrip(b"J" + jpeg_bytes)

    def _roundtrip(self, payload: bytes) -> Persons:
        self._sock.sendall(struct.pack(">I", len(payload)) + payload)
        (length,) = struct.unpack(">I", _recv_exact(self._sock, 4))
        d = json.loads(_recv_exact(self._sock, length))
        if "error" in d:
            raise ValueError(d["error"])
        return Persons.from_dict(d)

    def close(self):
        self._sock.close()
