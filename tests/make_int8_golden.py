"""Record the JAX package's int8 estimator on three rendered 160x160
scenes (run once; committed output ``fixtures/int8_thin160_jax.npz``).

The JAX int8 convolution runs on the CPU at about 40 s per 160x160
image, too slow for every test run, so ``tests/test_torch_quantize.py``
holds the port against this record of the JAX package's output: the
calibrated ``quant`` collection, the int8 ``concat_stage7`` maps and
humans of ``TfPoseEstimator("mobilenet_thin", (160, 160),
quantize=True)`` with the ``thin160_coco`` checkpoint, on the scenes
that ``eval.py --synthetic-e2e 3 --resize 160x160`` renders, and that
command's statistics with ``--quantize``.

Usage: JAX_PLATFORMS=cpu python tests/make_int8_golden.py  (about 6 min)
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tfpose_tpu.estimator import TfPoseEstimator  # noqa: E402
from tfpose_tpu.pipeline.preprocess import normalize  # noqa: E402
from tfpose_tpu.utils import synthetic  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "fixtures",
                   "int8_thin160_jax.npz")
CKPT = os.path.join(ROOT, "models", "trained", "thin160_coco",
                    "params.msgpack")
ARGV = ["--synthetic-e2e", "3", "--resize", "160x160", "--params", CKPT,
        "--quantize"]


def eval_scenes(n, w=160, h=160):
    """The scenes of ``eval.py --synthetic-e2e`` (``default_rng(7)``)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 3)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, h, w, rng))
    return out


def main():
    import importlib.util

    est = TfPoseEstimator("mobilenet_thin", target_size=(160, 160),
                          params_path=CKPT, quantize=True)
    arrays = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            est.variables["quant"])[0]:
        key = "/".join(str(k.key) for k in path)
        arrays["absmax/" + key] = np.asarray(leaf, np.float32)
    scenes = eval_scenes(3)
    arrays["maps"] = np.asarray(jax.jit(
        lambda v, x: est.net.apply(v, x, train=False)["concat_stage7"])(
            est.variables, normalize(jnp.asarray(np.stack(scenes)))),
        np.float32)
    rows = []
    for i, img in enumerate(scenes):
        humans = est.inference(img, resize_to_default=True,
                               upsample_size=4.0)
        for j, hu in enumerate(humans):
            for part, bp in sorted(hu.body_parts.items()):
                rows.append((i, j, part, bp.x, bp.y, bp.score, hu.score))
    arrays["humans"] = np.asarray(rows, np.float64).reshape(-1, 7)

    spec = importlib.util.spec_from_file_location(
        "eval_cli_jax", os.path.join(ROOT, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    arrays["eval_stats_json"] = np.asarray(json.dumps(mod.main(ARGV)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) // 1024} KB)")


if __name__ == "__main__":
    main()
