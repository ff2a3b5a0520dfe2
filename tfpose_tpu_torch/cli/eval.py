"""COCO keypoint evaluation CLI — counterpart of the repo's ``eval.py``
(reference ``tf_pose/eval.py`` flags ``--model --resize
--resize-out-ratio --coco-dir --coco-json --data-idx``, plus
``--synthetic N``, ``--synthetic-e2e N``, ``--params``,
``--assert-ap50`` and ``--device``).

* ``--synthetic N``: the port's decode on N rendered scenes' maps (no
  backbone);
* ``--synthetic-e2e N``: the full estimator on N rendered scenes
  (:func:`coco_eval.synthetic_e2e`), the trained-checkpoint gate;
* ``--coco-json``: images read with cv2 from ``--coco-dir`` through
  ``inference`` (``inference_windowed`` for images over 1.5x the network
  size with ``--multi-scale``), scored by pycocotools where it is
  installed, else by the port's OKS AP.

``--quantize`` runs the int8 backbone (calibrated post-training
quantisation, ``TfPoseEstimator(quantize=True)``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import (
    add_device_flag,
    network_size,
    setup_logging,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.types import PoseArrays
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.evaluation.coco_eval import (
    evaluate_oks_ap,
    evaluate_with_pycocotools,
    humans_to_detections,
    mean_keypoint_deviation,
    person_to_gt,
    synthetic_e2e,
)
from tfpose_tpu_torch.models import model_wh
from tfpose_tpu_torch.ops.assemble import Assembled
from tfpose_tpu_torch.ops.decode import decode
from tfpose_tpu_torch.utils import synthetic

logger = logging.getLogger("tfpose_tpu_torch.eval")


def eval_coco(args, e):
    from tfpose_tpu_torch.utils.imload import read_imgfile

    with open(args.coco_json) as f:
        coco = json.load(f)
    images = coco["images"]
    if args.data_idx > 0:
        images = images[:args.data_idx]
    gts = {}
    for ann in coco["annotations"]:
        if ann.get("num_keypoints", 0) == 0:
            continue
        gts.setdefault(ann["image_id"], []).append(
            {"keypoints": ann["keypoints"], "area": ann["area"]})
    dets = []
    t0 = time.time()
    for i, im in enumerate(images):
        path = os.path.join(args.coco_dir, im["file_name"])
        img = read_imgfile(path, None, None)
        if img is None:
            continue
        if args.multi_scale and (img.shape[0] > 1.5 * e.target_size[1]
                                 or img.shape[1] > 1.5 * e.target_size[0]):
            humans = e.inference_windowed(
                img, upsample_size=args.resize_out_ratio)
        else:
            humans = e.inference(img, resize_to_default=True,
                                 upsample_size=args.resize_out_ratio)
        dets.extend(humans_to_detections(
            humans, im["id"], im["width"], im["height"]))
        if (i + 1) % 100 == 0:
            logger.info("%d/%d images (%.2f img/s)", i + 1, len(images),
                        (i + 1) / (time.time() - t0))
    with open(args.write_json, "w") as f:
        json.dump(dets, f)
    stats = evaluate_with_pycocotools(args.coco_json, dets)
    if stats is None:
        stats = evaluate_oks_ap(gts, dets)
    stats.update(mean_keypoint_deviation(gts, dets))
    return stats


def eval_synthetic(args):
    """Rendered scenes' maps at the network-output resolution through
    the port's decode at 4x, scored with OKS AP: the decode's hermetic
    regression gate (the JAX script's scenes, ``default_rng(123)``)."""
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card available; pass --device cpu")
    rng = np.random.default_rng(123)
    params = DecodeParams()
    h, w = 46, 54
    up_h, up_w = h * 4, w * 4
    gts, dets = {}, []
    for idx in range(args.synthetic):
        n_people = int(rng.integers(1, 4))
        people = synthetic.random_people(rng, n_people, h, w,
                                         separated=True)
        heat = synthetic.render_heatmap(people, h, w)
        pafm = synthetic.render_paf(people, h, w)
        net = np.concatenate([heat, pafm], axis=2).astype(np.float32)
        out = decode(torch.from_numpy(net).to(device), up_h, up_w, params)
        humans = PoseArrays.of(
            Assembled(*(t.cpu().numpy() for t in out))).to_humans()
        dets.extend(humans_to_detections(humans, idx, up_w, up_h))
        # ground truth in the upsampled coordinates
        gts[idx] = [person_to_gt(person * 4) for person in people]
    stats = evaluate_oks_ap(gts, dets)
    stats.update(mean_keypoint_deviation(gts, dets))
    return stats


def eval_synthetic_e2e(args):
    """End-to-end learning gate: rendered part-colour-coded images ->
    the full estimator (backbone + decode) -> OKS AP against the
    ground-truth skeletons (mean keypoint deviation in input pixels
    beside it). With ``--params`` pointing at a trained checkpoint it
    shows the checkpoint detects people; with random init it scores
    about 0."""
    w, h = model_wh(args.resize)
    w, h = w or 96, h or 96
    e = TfPoseEstimator(args.model, target_size=(w, h), dtype=args.dtype,
                        params_path=args.params or None,
                        quantize=args.quantize, device=args.device)
    stats, _ = synthetic_e2e(e, args.synthetic_e2e, w, h,
                             upsample_size=args.resize_out_ratio)
    return stats


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(
        description="tfpose_tpu_torch COCO keypoint evaluation")
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--resize", type=str, default="432x368")
    parser.add_argument("--resize-out-ratio", type=float, default=4.0)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--coco-dir", type=str, default="")
    parser.add_argument("--coco-json", type=str, default="")
    parser.add_argument("--data-idx", type=int, default=0,
                        help="evaluate only the first N images")
    parser.add_argument("--multi-scale", action="store_true",
                        help="sliding-window inference for images "
                             "larger than the network input "
                             "(reference --multi-scale)")
    parser.add_argument("--write-json", type=str,
                        default=os.path.join(tempfile.gettempdir(),
                                             "tfpose_tpu_torch_eval.json"))
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate the decode on N synthetic scenes "
                             "instead of COCO (no backbone involved)")
    parser.add_argument("--synthetic-e2e", type=int, default=0,
                        help="evaluate the FULL estimator (backbone + "
                             "decode) on N rendered scenes — the "
                             "trained-checkpoint learning gate")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 PTQ backbone (calibrated on rendered "
                             "scenes at the network size)")
    parser.add_argument("--params", type=str, default="",
                        help="msgpack params for --synthetic-e2e / "
                             "--coco-json (trained checkpoint export)")
    parser.add_argument("--assert-ap50", type=float, default=None,
                        help="exit nonzero unless AP50 >= this value "
                             "(hard regression gate)")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    if args.synthetic_e2e:
        stats = eval_synthetic_e2e(args)
    elif args.synthetic:
        stats = eval_synthetic(args)
    elif args.coco_json:
        w, h = network_size(args.resize)
        e = TfPoseEstimator(args.model, target_size=(w, h),
                            dtype=args.dtype,
                            params_path=args.params or None,
                            quantize=args.quantize, device=args.device)
        stats = eval_coco(args, e)
    else:
        parser.error("need --coco-json, --synthetic N, or "
                     "--synthetic-e2e N")
    print(json.dumps(stats))
    if args.assert_ap50 is not None:
        ap50 = stats.get("AP50", stats.get("ap50", 0.0))
        if ap50 < args.assert_ap50:
            raise SystemExit(
                f"AP50 gate failed: {ap50:.3f} < {args.assert_ap50}")
    return stats


if __name__ == "__main__":
    main()
