"""Single-image inference CLI — counterpart of the repo's ``run.py``
(reference flags ``--image --model --resize --resize-out-ratio``, plus
``--dtype``, ``--output`` and ``--device``).

    tfpose-torch-run --image images/p1.jpg --output out.jpg

``--output`` writes the image with the skeletons drawn (cv2). The JAX
script draws a matplotlib panel of the maps there when matplotlib is
installed; the port imports no plotting package, so it writes the
annotated image, which is the JAX script's own fallback.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from tfpose_tpu_torch.cli.common import (
    add_device_flag,
    network_size,
    setup_logging,
)
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.utils.imload import read_imgfile

logger = logging.getLogger("TfPoseEstimatorRun")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch single-image run")
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--model", type=str, default="mobilenet_thin",
                        help="cmu / mobilenet / mobilenet_thin / "
                             "mobilenet_v2_large / mobilenet_v2_small")
    parser.add_argument("--resize", type=str, default="432x368",
                        help="network input resolution, e.g. 432x368")
    parser.add_argument("--resize-out-ratio", type=float, default=4.0,
                        help="upsample ratio before decoding")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--output", type=str, default=None,
                        help="write the annotated image here")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    w, h = network_size(args.resize)
    e = TfPoseEstimator(args.model, target_size=(w, h), dtype=args.dtype,
                        device=args.device)

    image = read_imgfile(args.image, None, None)
    if image is None:
        logger.error("Image can not be read, path=%s", args.image)
        sys.exit(-1)

    t = time.time()
    humans = e.inference(image, resize_to_default=True,
                         upsample_size=args.resize_out_ratio)
    elapsed = time.time() - t
    logger.info("inference image: %s in %.4f seconds.", args.image, elapsed)
    logger.info("%d humans detected", len(humans))
    for i, hum in enumerate(humans):
        logger.info("human %d: score=%.3f parts=%d", i, hum.score,
                    hum.part_count())

    image = TfPoseEstimator.draw_humans(image, humans, imgcopy=False)
    if args.output:
        import cv2
        cv2.imwrite(args.output, image)
        logger.info("annotated image written to %s", args.output)
    return humans


if __name__ == "__main__":
    main()
