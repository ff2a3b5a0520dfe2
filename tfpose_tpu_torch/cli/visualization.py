"""Visualization client — counterpart of ``scripts/visualization.py``
(reference ``scripts/visualization.py``, which subscribes to ``Persons``
and the image and draws the skeletons again): sends a video's frames to
a running broadcaster (``tfpose-torch-broadcaster``) and writes the
annotated frames.

    tfpose-torch-visualization --video in.mp4 --port 5555 --output out.mp4

Reading and writing the video needs cv2, imported in :func:`main`;
:func:`annotate` draws with the port's own ``draw_humans``.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Tuple

import numpy as np

from tfpose_tpu_torch.cli.common import setup_logging
from tfpose_tpu_torch.core.types import BodyPart, Human
from tfpose_tpu_torch.serving import PoseClient, Persons
from tfpose_tpu_torch.utils.draw import draw_humans

logger = logging.getLogger("visualization")


def msg_to_humans(msg: Persons) -> List[Human]:
    """``Persons`` -> ``Human`` list, part ids ``f"{person}-{part}"``."""
    humans = []
    for pi, person in enumerate(msg.persons):
        h = Human()
        for bp in person.body_part:
            h.body_parts[bp.part_id] = BodyPart(
                f"{pi}-{bp.part_id}", bp.part_id, bp.x, bp.y,
                bp.confidence)
        humans.append(h)
    return humans


def annotate(client: PoseClient, frame: np.ndarray
             ) -> Tuple[List[Human], np.ndarray]:
    """One BGR frame through the broadcaster: (its humans, a copy of the
    frame with their skeletons drawn)."""
    humans = msg_to_humans(client.infer_raw(frame))
    return humans, draw_humans(frame, humans, imgcopy=True)


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch visualization client")
    parser.add_argument("--video", type=str, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--output", type=str, default="")
    parser.add_argument("--max-frames", type=int, default=0)
    args = parser.parse_args(argv)

    import cv2

    client = PoseClient(args.host, args.port)
    cap = cv2.VideoCapture(args.video)
    writer = None
    n = 0
    try:
        while not args.max_frames or n < args.max_frames:
            ret, frame = cap.read()
            if not ret:
                break
            _, img = annotate(client, frame)
            if args.output:
                if writer is None:
                    writer = cv2.VideoWriter(
                        args.output, cv2.VideoWriter_fourcc(*"mp4v"),
                        cap.get(cv2.CAP_PROP_FPS) or 25.0,
                        (img.shape[1], img.shape[0]))
                writer.write(img)
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
        client.close()
    logger.info("visualized %d frames", n)
    return n


if __name__ == "__main__":
    main()
