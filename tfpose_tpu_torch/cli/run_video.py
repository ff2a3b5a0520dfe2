"""Video-file inference CLI — counterpart of the repo's ``run_video.py``:
the frames of ``--video`` through :class:`VideoPipeline` (``--depth``
frames in flight), the skeletons drawn, optionally written to
``--output`` or shown. Reading, writing and showing video needs cv2."""

from __future__ import annotations

import argparse
import logging
import time

from tfpose_tpu_torch.cli.common import (
    add_device_flag,
    network_size,
    setup_logging,
)
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.pipeline.video import VideoPipeline

logger = logging.getLogger("TfPoseEstimatorVideo")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch video run")
    parser.add_argument("--video", type=str, required=True)
    parser.add_argument("--model", type=str, default="mobilenet_v2_large")
    parser.add_argument("--resize", type=str, default="432x368")
    parser.add_argument("--resize-out-ratio", type=float, default=4.0)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--show", action="store_true",
                        help="cv2.imshow preview (needs a display)")
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--depth", type=int, default=2,
                        help="frames in flight (pipeline depth)")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    import cv2

    w, h = network_size(args.resize)
    e = TfPoseEstimator(args.model, target_size=(w, h), dtype=args.dtype,
                        device=args.device)

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        logger.error("cannot open video %s", args.video)
        return
    writer = None
    pipe = VideoPipeline(e, upsample_size=args.resize_out_ratio,
                         depth=args.depth)
    n, t0 = 0, time.time()
    try:
        for frame, humans in pipe.run(_frames(cap, args.max_frames)):
            image = TfPoseEstimator.draw_humans(frame, humans, imgcopy=False)
            if args.output:
                if writer is None:
                    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                    writer = cv2.VideoWriter(
                        args.output, fourcc,
                        cap.get(cv2.CAP_PROP_FPS) or 25.0,
                        (image.shape[1], image.shape[0]))
                writer.write(image)
            if args.show:
                cv2.imshow("tfpose_tpu_torch video", image)
                if cv2.waitKey(1) == 27:
                    break
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    dt = time.time() - t0
    logger.info("processed %d frames in %.2fs (%.1f FPS)", n, dt,
                n / max(dt, 1e-6))


def _frames(cap, max_frames):
    n = 0
    while True:
        ret, frame = cap.read()
        if not ret or (max_frames and n >= max_frames):
            return
        n += 1
        yield frame


if __name__ == "__main__":
    main()
