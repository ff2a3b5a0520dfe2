"""BASELINE config 5 as one command — counterpart of
``scripts/sweep_backbones.py``: "COCO keypoint eval sweep across all 4
backbones, bf16 batched inference".

For each row of :data:`ZOO` whose committed checkpoint is present under
``<root>/models/trained/``, the bf16 :class:`BatchedEvaluator` (the
backbone and ``decode_batch`` on the card, one batch at a time) loads
the checkpoint at the resolution it was trained for, scores the same
held-out rendered scenes as the always-on gates (:func:`make_scenes`:
OKS AP and the mean keypoint deviation), and measures throughput with
``utils/profiling.amortized_ms`` (CUDA events, the slope between 8 and
2 distinct batches of forward and decode).

    tfpose-torch-sweep-backbones [--scenes 50] [--out PATH]

A missing checkpoint raises ``FileNotFoundError`` unless
``--allow-missing`` is given. The document goes to ``--out``
(``tfpose_tpu_torch/_build/sweep_backbones.json`` by default) and to
standard output; its ``device`` names the card and its power limit, as
``nvidia-smi`` reports them, beside which every time in it was taken.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import add_device_flag, setup_logging
from tfpose_tpu_torch.evaluation.coco_eval import (
    evaluate_oks_ap,
    mean_keypoint_deviation,
    person_to_gt,
)
from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
from tfpose_tpu_torch.utils import synthetic
from tfpose_tpu_torch.utils.profiling import amortized_ms, card_name_and_power

logger = logging.getLogger("tfpose_tpu_torch.backbone_sweep")

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PACKAGE)
DEFAULT_OUT = os.path.join(PACKAGE, "_build", "sweep_backbones.json")

# (model, committed checkpoint, eval WxH, batch): each family at the
# resolution its checkpoint was trained for (models/trained/*/README.md).
# The first four are the families config 5 names (the reference's
# models/graph/); mobilenet (v1 width 1.0) is a fifth row, for which the
# reference ships no weights.
ZOO = [
    ("cmu", "cmu160_coco", (160, 160), 8),
    ("mobilenet_thin", "thin368_coco", (432, 368), 8),
    ("mobilenet_v2_large", "v2large160_coco", (160, 160), 8),
    ("mobilenet_v2_small", "v2small160_coco", (160, 160), 8),
    ("mobilenet", "v1full160_coco", (160, 160), 8),
]


def make_scenes(n: int, w: int, h: int
                ) -> Tuple[List[np.ndarray], Dict[int, List[dict]]]:
    """The held-out scenes of ``eval --synthetic-e2e`` (seed 7, 1-2
    separated ``SPREAD_TEMPLATE`` people): ``n`` w x h uint8 images and
    their COCO ground truth by index, so that the sweep's AP is the
    per-backbone gates' AP."""
    rng = np.random.default_rng(7)
    imgs, gts = [], {}
    for idx in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 3)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        imgs.append(synthetic.render_image(people, h, w, rng))
        gts[idx] = [person_to_gt(p) for p in people]
    return imgs, gts


def throughput_img_s(ev: BatchedEvaluator, imgs: List[np.ndarray]) -> float:
    """Amortized ms per image of forward + decode over 8 distinct batches
    of ``imgs`` (``amortized_ms``: CUDA events, the slope between 8 and 2
    batches). Each batch's human scores are summed into the timed
    result, so the decode runs to its end. Needs the card."""
    b = ev.batch
    pool = [imgs[i % len(imgs)] for i in range(b * 8)]
    xs = torch.as_tensor(np.stack([np.stack(pool[i * b:(i + 1) * b])
                                   for i in range(8)]), device=ev.device)
    ms_per_batch = amortized_ms(
        lambda batch: ev.forward_decode(batch).human_scores.sum(), xs)
    return ms_per_batch / b


def main(argv=None) -> dict:
    setup_logging()
    parser = argparse.ArgumentParser(
        description="BASELINE config 5: the bf16 eval sweep over the "
                    "trained backbones")
    parser.add_argument("--scenes", type=int, default=50)
    parser.add_argument("--batch", type=int, default=0,
                        help="override batch size for ALL backbones")
    parser.add_argument("--models", type=str, default="",
                        help="comma-separated subset")
    parser.add_argument("--skip-throughput", action="store_true")
    parser.add_argument("--allow-missing", action="store_true")
    parser.add_argument("--root", type=str, default=ROOT,
                        help="the tree whose models/trained/ holds the "
                             "checkpoints (default: this checkout)")
    parser.add_argument("--out", type=str, default=DEFAULT_OUT)
    add_device_flag(parser)
    args = parser.parse_args(argv)

    zoo = ZOO
    if args.models:
        wanted = set(args.models.split(","))
        zoo = [z for z in ZOO if z[0] in wanted]

    def checkpoint(name):
        return os.path.join(args.root, "models", "trained", name,
                            "params.msgpack")

    missing = [c for _, c, _, _ in zoo if not os.path.exists(checkpoint(c))]
    if missing and not args.allow_missing:
        raise FileNotFoundError(
            f"committed checkpoints missing: {missing} — the config-5 "
            "sweep is only meaningful over the full trained zoo "
            "(pass --allow-missing to run the rest)")

    device = torch.device(args.device or "cuda")
    doc = {"config": ("BASELINE config 5: keypoint eval sweep across "
                      "all 4 backbones, bf16 batched inference"),
           "zoo_note": ("rows 1-4 are the deployed families config 5 "
                        "names (the reference's models/graph/); the "
                        "'mobilenet' row is a fifth family, for which "
                        "the reference ships no weights"),
           "device": card_name_and_power(device),
           "scenes": args.scenes,
           "dtype": "bfloat16 (network compute; the decode in fp32, "
                    "ops/decode.py casts)",
           "mesh": "one card, unsharded",
           "throughput_method": ("utils.profiling.amortized_ms: CUDA "
                                 "events, the slope between 8 and 2 "
                                 "distinct batches of forward + decode"),
           "backbones": {}}
    for model, ckpt, (w, h), batch in zoo:
        batch = args.batch or batch
        path = checkpoint(ckpt)
        if not os.path.exists(path):
            logger.warning("skipping %s (missing %s)", model, ckpt)
            continue
        logger.info("%s (%s, %dx%d, b=%d, bf16)", model, ckpt, w, h, batch)
        ev = BatchedEvaluator(model, (w, h), batch_size=batch,
                              dtype="bfloat16", device=args.device)
        ev.load_params(path)
        imgs, gts = make_scenes(args.scenes, w, h)
        dets = ev.evaluate((idx, img, (w, h))
                           for idx, img in enumerate(imgs))
        stats = evaluate_oks_ap(gts, dets)
        stats.update(mean_keypoint_deviation(gts, dets))
        row = {"checkpoint": f"models/trained/{ckpt}",
               "resolution": f"{w}x{h}", "batch": batch,
               "AP": round(stats["AP"], 4),
               "AP50": round(stats["AP50"], 4),
               "AP75": round(stats.get("AP75", 0.0), 4),
               "AR": round(stats["AR"], 4),
               "mean_px_deviation": round(stats["mean_px_deviation"], 3),
               "matched_keypoints": stats["matched_keypoints"]}
        if not args.skip_throughput:
            ms = throughput_img_s(ev, imgs)
            row["amortized_ms_per_img"] = round(ms, 4)
            row["img_per_s"] = round(1000.0 / ms, 1)
        doc["backbones"][model] = row
        logger.info("%s: %s", model, json.dumps(row))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
