"""Frozen-graph converter CLI — counterpart of the repo's ``convert.py``:
a reference ``graph_opt.pb`` -> msgpack checkpoint that
``TfPoseEstimator(params_path=...)`` (either package's) loads.

    tfpose-torch-convert models/graph/mobilenet_thin/graph_opt.pb \\
        --model mobilenet_thin --output thin.msgpack

Flat and slim names, the ``Openpose`` scope, ``/read`` Identities and
folded BatchNorm all resolve (``convert/graphdef.py``). The conversion
moves numpy arrays on the host: no device, no TensorFlow.
"""

from __future__ import annotations

import argparse
import logging

from tfpose_tpu_torch.cli.common import setup_logging


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser()
    parser.add_argument("pb_path")
    parser.add_argument("--model", required=True,
                        help="cmu | mobilenet | mobilenet_thin | "
                             "mobilenet_v2_large | mobilenet_v2_small")
    parser.add_argument("--output", required=True,
                        help="msgpack output path")
    parser.add_argument("--input-size", type=str, default="432x368")
    args = parser.parse_args(argv)

    from tfpose_tpu_torch.convert.graphdef import convert_pb_file
    from tfpose_tpu_torch.models import model_wh

    w, h = model_wh(args.input_size)
    convert_pb_file(args.pb_path, args.model, args.output,
                    input_size=(w, h))
    logging.getLogger("tfpose_tpu_torch.convert").info("wrote %s",
                                                       args.output)


if __name__ == "__main__":
    main()
