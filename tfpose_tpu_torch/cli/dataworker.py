"""Worker-side data server CLI — counterpart of the repo's
``dataworker.py`` (reference ``tf_pose/pose_dataworker.py``).

Runs the CPU-heavy part of the input pipeline (image read, augment,
rasterize) on this host and streams batches to ``tfpose-torch-train
--remote-data <host:port>[,...]`` (or to the JAX ``train.py``: the wire
format is the JAX package's). No card is needed.

    python -m tfpose_tpu_torch.cli.dataworker --coco-json ann.json \\
        --img-dir imgs --input-size 368x368 --batchsize 16 --port 5577
    python -m tfpose_tpu_torch.cli.dataworker --synthetic --port 5577
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from tfpose_tpu_torch.cli.common import setup_logging

logger = logging.getLogger("tfpose_tpu_torch.dataworker_cli")


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("--coco-json", type=str, default="")
    parser.add_argument("--img-dir", type=str, default="")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--input-size", type=str, default="368x368")
    parser.add_argument("--batchsize", type=int, default=16)
    parser.add_argument("--sigma", type=float, default=8.0)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5577)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from tfpose_tpu_torch.models import model_wh
    from tfpose_tpu_torch.train.dataworker import serve_batches

    w, h = model_wh(args.input_size)
    if args.coco_json:
        from tfpose_tpu_torch.train.dataset import (
            PoseDataset,
            load_coco_annotations,
        )
        anns = load_coco_annotations(args.coco_json, args.img_dir)
        logger.info("%d annotated images", len(anns))
        ds = PoseDataset(anns, (w, h), args.batchsize,
                         sigma=args.sigma, seed=args.seed)

        def batches():
            while True:
                yield from ds
    else:
        from tfpose_tpu_torch.cli.train import synthetic_batches

        rng = np.random.default_rng(args.seed)

        def batches():
            yield from synthetic_batches(args.batchsize, (w, h), rng,
                                         sigma=args.sigma)

    address, stop = serve_batches(batches(), host=args.host,
                                  port=args.port)
    logger.info("serving %dx%d b=%d batches on %s:%d",
                w, h, args.batchsize, address[0], address[1])
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop()


if __name__ == "__main__":
    main()
