"""Dynamic micro-batching for the serving stack — port of
``tfpose_tpu/serving/batcher.py``.

The reference ROS node (``scripts/broadcaster_ros.py``) processes one
frame per callback; with many publishers the estimator serialises. The
backbone amortises with batch on the card (PERF.md §5: thin at B=8 costs
about the device time of two single images), so the service coalesces
concurrent requests into one ``inference_batch`` call.

``DynamicBatcher`` collects requests from any number of threads and
flushes a batch when either ``max_batch`` requests are waiting or the
oldest has waited ``max_wait_ms``. With ``pad_to_max`` a batch is padded
to ``max_batch`` by repeating its last frame, so the card sees one batch
shape (one set of cuDNN algorithm choices and allocations), and the pad
results are dropped before the futures resolve. One worker thread makes
every estimator call, so the estimator's per-call state is never shared
between calls in flight.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List

import numpy as np

logger = logging.getLogger("tfpose_tpu_torch.serving")


class DynamicBatcher:
    """Coalesce concurrent inference requests into padded batches.

    ``submit(img)`` returns a Future resolving to ``List[Human]``.
    """

    def __init__(self, estimator, max_batch: int = 8,
                 max_wait_ms: float = 5.0, upsample_size: float = 4.0,
                 pad_to_max: bool = True):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.estimator = estimator
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.ratio = upsample_size
        self.pad_to_max = pad_to_max
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # observability: batch-size histogram {size: count}
        self.batch_sizes: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, img: np.ndarray) -> "Future":
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        fut: Future = Future()
        self._q.put((img, fut))
        return fut

    def _collect(self) -> List:
        """Block for one request, then gather until full or deadline."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._collect()
            if not items:
                continue
            imgs = [im for im, _ in items]
            n = len(imgs)
            if self.pad_to_max and n < self.max_batch:
                imgs = imgs + [imgs[-1]] * (self.max_batch - n)
            try:
                results = self.estimator.inference_batch(
                    imgs, upsample_size=self.ratio)
            except Exception as exc:  # resolve, don't wedge clients
                logger.exception("inference_batch of %d frames failed", n)
                for _, fut in items:
                    fut.set_exception(exc)
                continue
            self.batch_sizes[n] = self.batch_sizes.get(n, 0) + 1
            for (_, fut), humans in zip(items, results):
                fut.set_result(humans)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail anything still queued
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("batcher stopped"))
