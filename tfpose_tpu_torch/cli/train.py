"""Training CLI — counterpart of the repo's ``train.py`` (reference
``tf_pose/train.py``): ``--model --batchsize --lr --max-steps
--checkpoint-dir``, data from COCO (``--coco-json --img-dir``), a Caffe
Datum record shard (``--datum-shard``), remote data workers
(``--remote-data``) or ``--synthetic`` rendered scenes, on the CUDA
cards by default (``--device cpu``: the CPU).

    tfpose-torch-train --synthetic --input-size 368x368 --batchsize 16 \\
        --max-steps 1000 --checkpoint-dir ckpt

``--mesh-data`` and ``--mesh-spatial`` mean what they mean in JAX: the
batch split over ``--mesh-data`` ranks (0: every card divided by
``--mesh-spatial``) and the image height over ``--mesh-spatial``
(``parallel/mesh.py``). A grid of more than one rank runs one process
per rank (``launch``), over NCCL on the visible cards, or over gloo on
the CPU with ``--device cpu``; a grid larger than the cards raises JAX's
message. Rank 0 alone reads each global batch, from every source, and
hands it to the others; rank 0 alone logs, writes summaries and
checkpoints, and exports; ``--resume`` loads on every rank. After the
last step the ranks' states are checked equal bit for bit.

The flags and defaults are the JAX script's. What differs:

  * a ``--datum-shard`` with fewer records than ``--batchsize`` raises
    (it would yield no batch);
  * ``--checkpoint-dir`` keeps the train state (step, parameters, BN
    statistics, Adam moments) as ``torch.save`` files ``<step>.pt``, the
    last three, in place of orbax; ``--resume`` takes a step number or
    ``latest``. At the end the inference weights are exported to
    ``<checkpoint-dir>/params.msgpack`` in the JAX package's flax msgpack
    format, which both packages' estimators load;
  * the network starts from seeded random weights
    (``models/layers.py:init_weights``, seed 0), not flax's init bits.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import time

import numpy as np
import torch

from tfpose_tpu_torch.cli.common import add_device_flag, setup_logging

logger = logging.getLogger("tfpose_tpu_torch.train")


def _normalize(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 256.0 - 0.5


def synthetic_joint_batches(batch_size, wh, rng, max_people=8,
                            style_randomize=False, uint8_feed=False):
    """Stream of {'image', 'joints'} batches for ``--device-targets``:
    rendered scenes with their NaN-padded stride-8 joints; ``uint8_feed``
    ships the raw uint8 frames (normalised on the device)."""
    from tfpose_tpu_torch.utils import synthetic

    w, h = wh
    while True:
        imgs, joints = [], []
        for _ in range(batch_size):
            n = int(rng.integers(1, 4))
            people = synthetic.random_people(
                rng, n, h, w, template=synthetic.SPREAD_TEMPLATE)
            style = (synthetic.random_style(rng)
                     if style_randomize else {})
            img = synthetic.render_image(people, h, w, rng, **style)
            padded = np.full((max_people, 18, 2), np.nan, np.float32)
            padded[:n] = people / 8.0  # stride-8 coords
            imgs.append(img if uint8_feed else _normalize(img))
            joints.append(padded)
        yield {"image": np.stack(imgs), "joints": np.stack(joints)}


def synthetic_batches(batch_size, wh, rng, sigma=8.0,
                      style_randomize=False):
    """Endless stream of rendered scenes as training batches: part-
    colour-coded joint images (the convention the e2e eval gate renders)
    with stride-8 heatmap/PAF targets."""
    from tfpose_tpu_torch.train.dataset import get_heatmap, get_vectormap
    from tfpose_tpu_torch.utils import synthetic

    w, h = wh
    hs, ws = h // 8, w // 8
    while True:
        imgs, heats, pafs = [], [], []
        for _ in range(batch_size):
            n = int(rng.integers(1, 4))
            people = synthetic.random_people(
                rng, n, h, w, template=synthetic.SPREAD_TEMPLATE)
            style = (synthetic.random_style(rng)
                     if style_randomize else {})
            img = synthetic.render_image(people, h, w, rng, **style)
            heats.append(get_heatmap(people / 8.0, hs, ws,
                                     sigma=sigma / 8.0))
            pafs.append(get_vectormap(people / 8.0, hs, ws, threshold=1.0))
            imgs.append(_normalize(img))
        yield {"image": np.stack(imgs), "heat": np.stack(heats),
               "paf": np.stack(pafs)}


def epochs(make_dataset):
    """Endless batches of ``make_dataset(seed)``, the seed advancing per
    epoch: a fixed seed would replay identical augmentations and order
    every pass."""
    ep = 0
    while True:
        yield from make_dataset(ep)
        ep += 1


class Checkpoints:
    """Train states as ``<dir>/<step>.pt`` (``torch.save`` of
    ``TrainState.state_dict``), keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def steps(self):
        return sorted(int(os.path.basename(p)[:-3]) for p in glob.glob(
            os.path.join(self.dir, "*.pt"))
            if os.path.basename(p)[:-3].isdigit())

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state) -> None:
        path = os.path.join(self.dir, f"{state.step}.pt")
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.dir, f"{old}.pt"))

    def restore(self, step: int, state) -> None:
        sd = torch.load(os.path.join(self.dir, f"{step}.pt"),
                        map_location=next(state.net.parameters()).device,
                        weights_only=True)
        state.load_state_dict(sd)


def predict_heat(net, image) -> np.ndarray:
    """The inference-mode heat channels (N, H/8, W/8, 19) of a batch's
    image (float, or uint8 normalised on the device), as numpy."""
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.train.state import to_device_batch

    x = to_device_batch({"image": image},
                        next(net.parameters()).device)["image"]
    net.eval()
    try:
        return run_backbone(net, x)[..., :19].cpu().numpy()
    finally:
        net.train()


def main(argv=None):
    setup_logging()
    parser = argparse.ArgumentParser(description="tfpose_tpu_torch trainer")
    parser.add_argument("--model", type=str, default="mobilenet_thin")
    parser.add_argument("--input-size", type=str, default="368x368")
    parser.add_argument("--batchsize", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max-steps", type=int, default=100)
    parser.add_argument("--decay-steps", type=int, default=10000)
    parser.add_argument("--decay-rate", type=float, default=0.33)
    parser.add_argument("--checkpoint-dir", type=str, default="")
    parser.add_argument("--save-every", type=int, default=1000)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--coco-json", type=str, default="")
    parser.add_argument("--img-dir", type=str, default="")
    parser.add_argument("--datum-shard", type=str, default="",
                        help="train from a Caffe-Datum record shard "
                             "(train/lmdb_dataset.py write_datum_shard)")
    parser.add_argument("--no-augment", action="store_true",
                        help="disable the pose_augment chain (fixed "
                             "resize only)")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--style-randomize", action="store_true",
                        help="domain-randomise the synthetic render "
                             "style (synthetic.random_style)")
    parser.add_argument("--uint8-feed", action="store_true",
                        help="ship raw uint8 frames and normalize on "
                             "the device (1/4 the host->device bytes)")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed-precision training: bf16 compute in "
                             "the network, fp32 params/optimizer/BN "
                             "statistics/loss")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host-side batch prefetch depth (0 = off)")
    parser.add_argument("--device-targets", action="store_true",
                        help="rasterise heatmap/PAF targets on the "
                             "device inside the step (host ships joint "
                             "coords only)")
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="0 = all cards on the data axis")
    parser.add_argument("--mesh-spatial", type=int, default=1,
                        help=">1 shards image/target height over the "
                             "mesh 'spatial' axis (row halo exchanges)")
    parser.add_argument("--remote-data", type=str, default="",
                        help="comma-separated worker host:port list; "
                             "consume batches from remote dataworkers")
    parser.add_argument("--logdir", type=str, default="",
                        help="TensorBoard log dir (scalars + rendered "
                             "predictions); default <checkpoint-dir>/"
                             "logs when checkpointing")
    parser.add_argument("--image-summary-every", type=int, default=200)
    parser.add_argument("--resume", type=str, default="")
    add_device_flag(parser)
    args = parser.parse_args(argv)

    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if cpu:
        n_data = args.mesh_data or 1
        devices = ["cpu"] * (n_data * args.mesh_spatial)
    else:
        from tfpose_tpu_torch.parallel.mesh import visible_cards
        devices = visible_cards()
        n_data = args.mesh_data or max(len(devices) // args.mesh_spatial, 1)
    from tfpose_tpu_torch.parallel.mesh import check_grid, launch
    check_grid(n_data, args.mesh_spatial, len(devices))
    size = n_data * args.mesh_spatial
    if size == 1:
        return train(args)
    out = launch(_train_rank, size, devices[:size], "gloo" if cpu else "nccl",
                 args, n_data, devices[:size])
    return _state_on_cpu(args, *out[0])


def _train_rank(args, n_data, devices):
    """One rank of a mesh run: rank 0 returns its final train state's
    ``state_dict`` and log on the CPU, the others None."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data, args.mesh_spatial, devices)
    state = train(args, mesh)
    if mesh.rank:
        return None
    sd = state.state_dict()
    cpu = {"step": sd["step"], "net": {k: v.cpu() for k, v in
                                       sd["net"].items()},
           "mu": {k: v.cpu() for k, v in sd["mu"].items()},
           "nu": {k: v.cpu() for k, v in sd["nu"].items()}}
    return cpu, state.history


def _state_on_cpu(args, sd, history):
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.train.state import TrainState, make_optimizer

    net = get_network(args.model, dtype=torch.bfloat16 if args.bf16
                      else torch.float32)
    state = TrainState.create(net, make_optimizer(
        args.lr, args.decay_rate, args.decay_steps))
    state.load_state_dict(sd)
    state.history = history
    return state


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def train(args, mesh=None):
    """The training loop of ``main``'s ``args`` on one device, or on
    this rank of ``mesh``. Returns the final train state."""
    from tfpose_tpu_torch.convert.checkpoint import (
        save_flax_msgpack, variables_to_numpy)
    from tfpose_tpu_torch.core.topology import require_coco18
    from tfpose_tpu_torch.models import get_network, model_wh, skeleton_of
    from tfpose_tpu_torch.models.layers import init_weights
    from tfpose_tpu_torch.parallel.mesh import (
        assert_replicas_equal, broadcast_batch, replicated)
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step, replica_tensors)

    # the data, targets and loss are COCO-18's (BODY_25 needs 25-part labels)
    require_coco18(skeleton_of(args.model), "training")
    chief = mesh is None or mesh.rank == 0
    device = mesh.device if mesh else torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card available; pass --device cpu")
    w, h = model_wh(args.input_size)
    # --bf16: the parameters (and so the Adam moments) stay fp32; only
    # the layers compute in bf16. The loss and targets stay fp32
    # (stage_l2_loss upcasts), BatchNorm computes its statistics in fp32,
    # and bf16 shares fp32's exponent range, so no loss scaling.
    net = get_network(args.model, dtype=torch.bfloat16 if args.bf16
                      else torch.float32)
    init_weights(net, torch.Generator().manual_seed(0))
    net.to(device)
    if mesh is not None:
        replicated(mesh, net)
    tx = make_optimizer(args.lr, args.decay_rate, args.decay_steps)
    state = TrainState.create(net, tx)
    train_step = make_train_step(rasterize=args.device_targets, mesh=mesh)

    ckpts = None
    if args.checkpoint_dir:
        ckpts = Checkpoints(args.checkpoint_dir)
        if args.resume:
            # a step number, 'latest', or (for convenience) the
            # checkpoint dir itself
            step0 = (int(args.resume) if args.resume.isdigit()
                     else ckpts.latest_step())
            if step0 is None:
                raise SystemExit(f"no checkpoints in {ckpts.dir}")
            ckpts.restore(step0, state)
            logger.info("resumed from step %s", step0)
    if chief:
        logger.info("training %s at %dx%d on %s%s", args.model, w, h, device,
                    f", mesh {mesh.shape}" if mesh else "")

    batches = _batches(args, (w, h)) if chief else None
    from tfpose_tpu_torch.train.summaries import (
        make_writer, write_prediction_panel, write_scalars)
    logdir = args.logdir or (args.checkpoint_dir + "/logs"
                             if args.checkpoint_dir else "")
    writer = make_writer(logdir if chief else "")

    base = state.step  # nonzero after --resume: steps continue
    t0 = time.time()
    step = 0
    while base + step < args.max_steps:
        gstep = base + step + 1
        batch = next(batches, None) if chief else None
        if mesh is not None:
            batch = broadcast_batch(mesh, batch)
        if batch is None:
            break
        state, metrics = train_step(state, batch)
        step += 1
        if not chief:
            continue
        if gstep % args.log_every == 0:
            loss = float(metrics["loss"])
            now = time.time()
            rate = step * args.batchsize / (now - t0)
            logger.info("step %d loss=%.1f (%.1f img/s)", gstep, loss, rate)
            state.history.append({"step": gstep, "loss": loss,
                                  "images_per_sec": rate, "time": now})
            write_scalars(writer, gstep, {f"train/{k}": float(v)
                                          for k, v in metrics.items()})
            writer.scalar("train/images_per_sec", rate, gstep)
        if (args.image_summary_every and logdir
                and gstep % args.image_summary_every == 0):
            sample = _host(batch["image"][:1])
            heat_pred = predict_heat(state.net, sample)[0]
            heat_gt = (_host(batch["heat"][0]) if "heat" in batch else None)
            write_prediction_panel(writer, gstep, sample[0], heat_pred,
                                   heat_gt)
        if ckpts and gstep % args.save_every == 0:
            ckpts.save(state)
    if mesh is not None:
        assert_replicas_equal(mesh, replica_tensors(state))
    if not chief:
        return state
    writer.flush()
    if ckpts:
        if ckpts.latest_step() != state.step:
            ckpts.save(state)
        logger.info("final checkpoint saved")
        # export the inference weights in the JAX package's format
        out = variables_to_numpy(state.net)
        out.pop("quant", None)
        save_flax_msgpack(os.path.join(ckpts.dir, "params.msgpack"), out)
        logger.info("inference params exported")
    return state


def _batches(args, wh):
    """The iterator of global batches that ``args`` names."""
    w, h = wh
    rng = np.random.default_rng(0)
    dataset_kw = dict(input_size=(w, h), batch_size=args.batchsize,
                      augment=not args.no_augment,
                      device_targets=args.device_targets,
                      uint8=args.uint8_feed)
    prefetch_wrap = False
    if args.remote_data:
        from tfpose_tpu_torch.train.dataworker import RemoteBatches
        addrs = [(hp.rsplit(":", 1)[0], int(hp.rsplit(":", 1)[1]))
                 for hp in args.remote_data.split(",")]
        batches = iter(RemoteBatches(addrs))
        logger.info("consuming remote batches from %s", addrs)
    elif args.datum_shard:
        from tfpose_tpu_torch.train.lmdb_dataset import (
            DatumPoseDataset, DatumShardReader)
        reader = DatumShardReader(args.datum_shard)
        logger.info("%d datum records", len(reader))
        if len(reader) < args.batchsize:
            raise ValueError(f"{args.datum_shard}: {len(reader)} records, "
                             f"fewer than --batchsize {args.batchsize}")
        batches = epochs(lambda ep: DatumPoseDataset(reader, seed=ep,
                                                     **dataset_kw))
        prefetch_wrap = True
    elif args.synthetic or not args.coco_json:
        if args.device_targets:
            batches = synthetic_joint_batches(
                args.batchsize, (w, h), rng,
                style_randomize=args.style_randomize,
                uint8_feed=args.uint8_feed)
        else:
            batches = synthetic_batches(
                args.batchsize, (w, h), rng,
                style_randomize=args.style_randomize)
        prefetch_wrap = True
    else:
        from tfpose_tpu_torch.train.dataset import (
            PoseDataset, load_coco_annotations)
        anns = load_coco_annotations(args.coco_json, args.img_dir)
        logger.info("%d annotated images", len(anns))
        batches = epochs(lambda ep: PoseDataset(anns, seed=ep, **dataset_kw))
        prefetch_wrap = True
    if prefetch_wrap and args.prefetch:
        # overlap host-side rendering / image read + augment + rasterize
        # with the device step
        from tfpose_tpu_torch.train.dataset import PrefetchIterator
        batches = iter(PrefetchIterator(batches, depth=args.prefetch))
    return batches


if __name__ == "__main__":
    main()
