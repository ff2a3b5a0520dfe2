"""Pose broadcaster daemon — counterpart of ``scripts/broadcaster.py``
(the reference ROS node ``scripts/broadcaster_ros.py`` rebuilt on the
TCP :class:`PoseService`): serves pose estimation for the frames that
clients push (``tfpose-torch-visualization``, or a ``PoseClient`` of
either package; the two packages speak one protocol).

    tfpose-torch-broadcaster --model mobilenet_thin --port 5555

The estimator loads the model's converted checkpoint,
``$TFPOSE_TPU_MODEL_DIR/jax/<model>/params.msgpack``, as the JAX
script's does, and runs with seeded random weights where there is none.
``--max-batch`` above 1 coalesces concurrent requests into one device
batch. The daemon runs until SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import logging
import signal

from tfpose_tpu_torch.cli.common import add_device_flag, setup_logging
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import model_wh
from tfpose_tpu_torch.serving import PoseService

logger = logging.getLogger("broadcaster")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch pose broadcaster")
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--resolution", type=str, default="432x368")
    parser.add_argument("--resize-out-ratio", type=float, default=4.0)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--max-batch", type=int, default=1,
                        help=">1 coalesces concurrent requests into "
                             "one device batch (dynamic batching)")
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    add_device_flag(parser)
    return parser.parse_args(argv)


def build_service(args: argparse.Namespace) -> PoseService:
    """The service of ``parse_args``'s flags, not started."""
    w, h = model_wh(args.resolution)
    e = TfPoseEstimator(args.model, target_size=(w, h), device=args.device)
    return PoseService(e, host=args.host, port=args.port,
                       upsample_size=args.resize_out_ratio,
                       max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms)


def main(argv=None):
    setup_logging()
    svc = build_service(parse_args(argv))
    # blocked before the server's threads start, which inherit the mask,
    # so that the signals wait for ``sigwait`` here
    stop_on = {signal.SIGINT, signal.SIGTERM}
    signal.pthread_sigmask(signal.SIG_BLOCK, stop_on)
    svc.start()
    try:
        logger.info("broadcasting pose estimation on %s:%d", *svc.address)
        got = signal.sigwait(stop_on)
        logger.info("%s: stopping", signal.Signals(got).name)
    finally:
        svc.stop()


if __name__ == "__main__":
    main()
