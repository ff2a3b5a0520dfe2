"""Webcam inference CLI — counterpart of the repo's ``run_webcam.py``:
camera frames through :class:`VideoPipeline`, the skeletons and an FPS
overlay drawn and shown in a window (cv2)."""

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

logger = logging.getLogger("TfPoseEstimatorWebCam")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch webcam run")
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--resize", type=str, default="432x368")
    parser.add_argument("--resize-out-ratio", type=float, default=4.0)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--depth", type=int, default=2,
                        help="frames in flight (pipeline depth)")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    import cv2

    w, h = network_size(args.resize)
    e = TfPoseEstimator(args.model, target_size=(w, h), dtype=args.dtype,
                        device=args.device)

    cam = cv2.VideoCapture(args.camera)
    if not cam.isOpened():
        logger.error("cannot open camera %d", args.camera)
        return
    pipe = VideoPipeline(e, upsample_size=args.resize_out_ratio,
                         depth=args.depth)
    fps_time = time.time()

    def frames():
        while True:
            ret, frame = cam.read()
            if not ret:
                return
            yield frame

    try:
        for frame, humans in pipe.run(frames()):
            image = TfPoseEstimator.draw_humans(frame, humans, imgcopy=False)
            now = time.time()
            cv2.putText(image, "FPS: %f" % (1.0 / max(now - fps_time, 1e-6)),
                        (10, 10), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        (0, 255, 0), 2)
            fps_time = now
            cv2.imshow("tf-pose-estimation result", image)
            if cv2.waitKey(1) == 27:
                break
    finally:
        cam.release()
        cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
