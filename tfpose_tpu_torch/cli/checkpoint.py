"""Checkpoint inspector — counterpart of the repo's ``run_checkpoint.py``
(reference ``tf_pose/run_checkpoint.py``): builds a model, optionally
loads a msgpack checkpoint into it, and prints its variables tree (name,
shape, dtype; sorted as JAX's tree flattening sorts) and the totals.

    python -m tfpose_tpu_torch.cli.checkpoint --model mobilenet_thin \\
        --checkpoint models/trained/thin368_coco/params.msgpack
"""

from __future__ import annotations

import argparse


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), tree[key]


def main(argv=None):
    parser = argparse.ArgumentParser(description="inspect model params")
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--input-size", type=str, default="432x368")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="msgpack params file to inspect")
    args = parser.parse_args(argv)

    import torch

    from tfpose_tpu_torch.convert.checkpoint import (
        load_flax_msgpack, variables_from_numpy, variables_to_numpy)
    from tfpose_tpu_torch.models import get_network, model_wh
    from tfpose_tpu_torch.models.layers import init_weights

    model_wh(args.input_size)  # the variables' shapes do not depend on it
    net = init_weights(get_network(args.model),
                       torch.Generator().manual_seed(0))
    if args.checkpoint:
        variables_from_numpy(net, load_flax_msgpack(args.checkpoint))
        print(f"loaded {args.checkpoint}")

    total = 0
    flat = list(_leaves(variables_to_numpy(net)))
    for name, leaf in flat:
        print(f"{name:80s} {str(leaf.shape):20s} {leaf.dtype}")
        total += leaf.size
    print(f"\n{args.model}: {len(flat)} tensors, {total:,} parameters "
          f"({total * 4 / 1e6:.1f} MB fp32)")


if __name__ == "__main__":
    main()
