"""Pipelined streaming inference — port of
``tfpose_tpu/pipeline/video.py``.

The reference webcam/video loop is fully serial (capture -> forward ->
C++ decode -> draw, ``run_webcam.py``). Here the host keeps ``depth``
frames in flight: while the card runs the forward of frame N+depth, the
host decodes frame N. Each frame goes the JAX pipeline's way
(``_pipeline(..., batched=False, return_maps=False)``): resize to the
network size (on the device by :func:`prepare`, equal to cv2's
``INTER_AREA``), forward, :func:`decode` without escalation, and the
estimator's saturation note.

In JAX the overlap comes from asynchronous dispatch. In PyTorch the
decode syncs the host in each greedy and assembly round, so a forward
queued on the same stream would hold every such sync back until it
ends. On the card the forwards therefore run on a stream of their own:
each frame is uploaded from pinned host memory with ``non_blocking``,
its ``concat_stage7`` is handed to the decode on the current stream
through a CUDA event, and ``record_stream`` tells the caching allocator
that the decode's stream uses it. The decode kernels launch on the
current stream. The humans are those of a serial loop of forward and
decode, bit for bit, at any depth; on the CPU ``depth`` only changes
the order of the work.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.core.types import Human
from tfpose_tpu_torch.ops.assemble import Assembled
from tfpose_tpu_torch.ops.decode import decode


class VideoPipeline:
    def __init__(self, estimator, upsample_size: float = 4.0,
                 depth: int = 2):
        self.e = estimator
        self.ratio = upsample_size
        self.depth = max(1, depth)
        self._stream = (torch.cuda.Stream(estimator.device)
                        if estimator.device.type == "cuda" else None)

    def _dispatch(self, frame: np.ndarray):
        """Queue one frame's upload and forward; returns what
        :meth:`_collect` needs: (concat_stage7, its event or None)."""
        w, h = self.e.target_size
        if self._stream is None:
            return self.e._forward(frame[None], h, w)[0], None
        # PyTorch's caching host allocator keeps the pinned buffer until
        # the copy that reads it has run, so it may be dropped at once
        host = torch.from_numpy(np.ascontiguousarray(frame)).pin_memory()
        with torch.cuda.stream(self._stream):
            x = host.to(self.e.device, non_blocking=True)
            net = self.e._forward_uint8(x[None], h, w)[0]
            done = torch.cuda.Event()
            done.record()
        return net, done

    def _collect(self, net: torch.Tensor, done) -> List[Human]:
        """Decode one dispatched frame on the current stream."""
        if done is not None:
            stream = torch.cuda.current_stream(self.e.device)
            stream.wait_event(done)
            net.record_stream(stream)
        w, h = self.e.target_size
        out = decode(net, int(h / 8 * self.ratio), int(w / 8 * self.ratio),
                     self.e.decode_params)
        arrays = Assembled(*(t.cpu().numpy() for t in out))
        self.e._note_saturation(arrays.peak_saturated)
        return self.e._humans(arrays)

    def run(self, frames: Iterable[np.ndarray]
            ) -> Iterator[Tuple[np.ndarray, List[Human]]]:
        """Yields (original_frame, humans) in order, ``depth`` frames of
        latency behind the input."""
        inflight = collections.deque()
        for frame in frames:
            inflight.append((frame, self._dispatch(frame)))
            if len(inflight) > self.depth:
                f, out = inflight.popleft()
                yield f, self._collect(*out)
        while inflight:
            f, out = inflight.popleft()
            yield f, self._collect(*out)
