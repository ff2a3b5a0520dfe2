"""Cases and comparators that the port's tests share: the CPU tests and
the ``cuda``-marked card tests.

Not a test module (pytest collects ``test_*.py`` only). It imports the
standard library, numpy, torch and ``tfpose_tpu_torch`` only, since the
card machine has no jax, cv2 or tensorboard. Its ``rank_*`` functions are
top-level so that a rank spawned by ``parallel/mesh.py:launch`` can
import them.
"""

from __future__ import annotations

import functools
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "models", "trained", "thin368_coco",
                          "params.msgpack")
V2_CHECKPOINTS = {
    name: os.path.join(ROOT, "models", "trained", ckpt, "params.msgpack")
    for name, ckpt in (("mobilenet_v2_small", "v2small160_coco"),
                       ("mobilenet_v2_large", "v2large160_coco"))}
# the node of the NVIDIA driver, present on every machine with a card
NVIDIA_DEVICE = "/dev/nvidiactl"


def card(n: int = 1):
    """The card tests' one decision, made inside their fixtures: skip
    where the machine has no NVIDIA device, fail where it has one but
    torch reaches no card (a broken card must not pass as skips), skip
    where it has fewer than ``n`` cards. Returns the first card."""
    import pytest
    import torch

    if not os.path.exists(NVIDIA_DEVICE):
        pytest.skip("needs a CUDA card")
    if not torch.cuda.is_available():
        pytest.fail(f"{NVIDIA_DEVICE} is present, but torch reaches no "
                    f"CUDA card")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    return torch.device("cuda:0")


@functools.lru_cache(maxsize=None)
def thin368(device: str):
    """thin368_coco at 432x368 on ``device``, one estimator a device for
    every test module of a run."""
    from tfpose_tpu_torch.estimator import TfPoseEstimator

    return TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                           params_path=CHECKPOINT, device=device)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k2_compare(got, want, what: str) -> None:
    """K2 against its plain version: bit for bit (both blur in tap order
    with every product and sum rounded, then the same 3x3 NMS), plateaus
    included."""
    import torch

    check(torch.equal(got, want), f"K2 differs from its plain version on "
          f"{what}: {int((got != want).sum())} values")


def k3_compare(got, want, what: str) -> None:
    """K3 against its plain version: ``ok`` and ``score`` bit for bit
    (the kernel rounds every step as the PyTorch ops do)."""
    import torch

    check(torch.equal(got.ok, want.ok), f"K3 ok differs on {what}: "
          f"{int((got.ok != want.ok).sum())} candidates")
    check(torch.equal(got.score, want.score), f"K3 score differs on {what}: "
          f"max |d| {(got.score - want.score).abs().max().item():.3g}")


def heat8_of(net_b):
    """(B, h8, w8, 57) -> the (h8, w8, B*18) part planes, as decode_batch
    flattens them for K1."""
    h8, w8 = net_b.shape[1:3]
    return net_b[..., :18].permute(1, 2, 0, 3).reshape(h8, w8, -1)


def peaks_of(s, i, b, up_w):
    """The top-K kernels' (scores, flat indices) of b * 18 planes as the
    Peaks (b, 18, K) that decode_batch scores."""
    from tfpose_tpu_torch.ops.nms import Peaks

    s, i = s.reshape(b, 18, -1), i.reshape(b, 18, -1).clamp(min=0)
    return Peaks(x=i % up_w, y=i // up_w, score=s, valid=s > 0.05)


def k4_compare(got, want):
    """K4 against its plain version: indices exact, scores within 1e-6
    (both sum the taps in one order with no fused multiply-add).
    Returns max |d| of the scores."""
    import torch

    (s, i), (s0, i0) = got, want
    check(torch.equal(i, i0), "K4 indices differ from the plain version's")
    d = (s - s0).abs().max().item() if s.numel() else 0.0
    check(d <= 1e-6, f"K4 scores max |d| {d:.3g} > 1e-6")
    return d


def k5_compare(got, want, what: str) -> None:
    """K5 against its plain version: every field of ``Assembled`` bit for
    bit (fixed-order or exact arithmetic at every step)."""
    import torch

    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w),
              f"K5 {name} differs from its plain version on {what}: "
              f"{tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}"
              + (f", {int((g != w).sum())} values" if g.shape == w.shape
                 else ""))


def assembly_inputs(net_b, up_h, up_w, params, skeleton=None):
    """(peaks, connections) that ``decode_batch`` hands the assembly for
    (B, h8, w8, C) net outputs of ``skeleton`` (COCO-18's 57 channels by
    default), on their device."""
    from tfpose_tpu_torch.core.topology import COCO18
    from tfpose_tpu_torch.ops import assemble, decode

    skeleton = skeleton or COCO18
    seen = []

    def keep(pk, conns, p, size=None, sk=COCO18):
        seen.append((pk, conns))
        return assemble.assemble_dense_plain(pk, conns, p, sk)

    decode.assemble_dense = keep
    try:
        decode.decode_batch(net_b, up_h, up_w, params, skeleton)
    finally:
        decode.assemble_dense = assemble.assemble_dense
    return seen[0]


# the walk case's parts and pairs per image: image 0 on the right side
# (the redundant pair 17, shoulder 2 -> ear 16), image 1 on the left (18)
_WALK_SIDES = (
    dict(sh=2, el=3, wr=4, eye=14, ear=16, pairs=dict(
        nk_sh=0, nk_other=1, sh_el=2, el_wr=3, nose_eye=13, eye_ear=14,
        sh_ear=17)),
    dict(sh=5, el=6, wr=7, eye=15, ear=17, pairs=dict(
        nk_sh=1, nk_other=0, sh_el=4, el_wr=5, nose_eye=15, eye_ear=16,
        sh_ear=18)))


def walk_case(k: int = 16):
    """Peaks (2, 18, k) and connections (2, 19, k) on which the
    redundant-pair walk takes each branch once per image, in slot order:
    slot 0 extends a row with an ear no row holds, slot 1 fuses a row
    with a part-disjoint row that holds the ear, slot 2 attaches an ear
    to the earlier-created of two rows that share the neck. Part p's slot
    s lies at x = 8p + s, y = 4s + p + 1 with score 0.9 (slots 0-3 valid);
    every connection scores 0.8. See :func:`walk_branches`."""
    import torch

    from tfpose_tpu_torch.ops.nms import Peaks
    from tfpose_tpu_torch.ops.paf import Connections

    parts = torch.arange(18, dtype=torch.int32)[:, None]
    slots = torch.arange(k, dtype=torch.int32)[None, :]
    valid = (slots < 4).expand(18, k)
    pk = Peaks(x=(8 * parts + slots).expand(2, 18, k).contiguous(),
               y=(4 * slots + parts + 1).expand(2, 18, k).contiguous(),
               score=torch.where(valid, 0.9, 0.0).expand(2, 18, k)
               .contiguous(),
               valid=valid.expand(2, 18, k).contiguous())
    a_slot = torch.full((2, 19, k), -1, dtype=torch.int32)
    b_slot = a_slot.clone()
    for img, side in enumerate(_WALK_SIDES):
        p = side["pairs"]
        for pair, conns in (
                (p["nk_sh"], [(0, 0), (1, 1), (2, 2)]),
                (p["nk_other"], [(0, 0)]),
                (p["sh_el"], [(0, 0), (1, 1), (2, 2)]),
                (p["el_wr"], [(0, 0), (1, 1), (2, 2)]),
                (12, [(3, 3)]),                        # neck -> nose
                (p["nose_eye"], [(1, 1), (3, 3)]),
                (p["eye_ear"], [(1, 1), (3, 3)]),
                (p["sh_ear"], [(0, 0), (1, 1), (2, 3)])):
            for t, (a, b) in enumerate(conns):
                a_slot[img, pair, t], b_slot[img, pair, t] = a, b
    c_valid = a_slot >= 0
    return pk, Connections(a_slot=a_slot, b_slot=b_slot,
                           score=torch.where(c_valid, 0.8, 0.0),
                           valid=c_valid)


def random_assembly_case(skeleton, b: int = 8, k: int = 8, seed: int = 0):
    """Peaks (b, parts, k) and greedy-shaped connections (b, limbs, k) of
    ``skeleton``, drawn from ``seed``: a random number of valid peaks a
    part (a prefix of the slots, at distinct places), and on every limb
    a random one-to-one matching of valid slots in its first m slots, so
    that rows fuse, attach and extend often. Scores in (0.3, 1)."""
    import numpy as np
    import torch

    from tfpose_tpu_torch.ops.nms import Peaks
    from tfpose_tpu_torch.ops.paf import Connections

    rng = np.random.default_rng(seed)
    parts, limbs = skeleton.num_parts, skeleton.num_pairs
    n_valid = rng.integers(1, k + 1, (b, parts))
    valid = np.arange(k)[None, None, :] < n_valid[..., None]
    flat = rng.permutation(10_000)[:b * parts * k].reshape(b, parts, k)
    a_slot = np.full((b, limbs, k), -1, np.int32)
    b_slot = a_slot.copy()
    for i in range(b):
        for lim, (pa, pb) in enumerate(skeleton.pairs):
            na, nb = n_valid[i, pa], n_valid[i, pb]
            m = int(rng.integers(0, min(na, nb) + 1))
            a_slot[i, lim, :m] = rng.permutation(na)[:m]
            b_slot[i, lim, :m] = rng.permutation(nb)[:m]
    c_valid = a_slot >= 0
    pk = Peaks(x=torch.from_numpy((flat % 100).astype(np.int32)),
               y=torch.from_numpy((flat // 100).astype(np.int32)),
               score=torch.from_numpy(np.where(valid, rng.uniform(
                   0.3, 1.0, valid.shape), 0.0).astype(np.float32)),
               valid=torch.from_numpy(valid))
    return pk, Connections(
        a_slot=torch.from_numpy(a_slot), b_slot=torch.from_numpy(b_slot),
        score=torch.from_numpy(np.where(c_valid, rng.uniform(
            0.3, 1.0, c_valid.shape), 0.0).astype(np.float32)),
        valid=torch.from_numpy(c_valid))


def walk_branches(out, img: int):
    """The branches of the redundant-pair walk that the assembly ``out``
    of :func:`walk_case` shows in image ``img`` (coordinates in heatmap
    pixels): "extend" (the slot-0 shoulder's human has the slot-0 ear),
    "fuse" (one human has the slot-1 nose and the slot-1 wrist),
    "attach" (two humans have the slot-3 ear)."""
    side = _WALK_SIDES[img]
    coords = out.coords[img].cpu()
    valid = out.part_valid[img].cpu()
    human = out.human_valid[img].cpu()

    def at(h, part, slot):
        return bool(valid[h, part]) and coords[h, part].tolist() == [
            8 * part + slot, 4 * slot + part + 1]

    humans = [h for h in range(len(human)) if human[h]]
    found = set()
    if any(at(h, side["sh"], 0) and at(h, side["ear"], 0) for h in humans):
        found.add("extend")
    if any(at(h, 0, 1) and at(h, side["wr"], 1) for h in humans):
        found.add("fuse")
    if sum(at(h, side["ear"], 3) for h in humans) == 2:
        found.add("attach")
    return found


def k1_phase_reference(heat8, fy, fx, k_top, thresh, kernlen=25, nsig=3.0):
    """The raw-grid top-K's own arithmetic in PyTorch, one op at a time:
    the vertical phase sums V, then the smoothed values S, each summed in
    tap order with taps t > 0 of weight 0 skipped, then the plain
    version's 3x3 NMS, threshold and stable top-K. (h8, w8, C) ->
    (scores, idx). Unlike the plain version (a blur of the replicated
    plane), it rounds as the kernel does, so the kernel equals it bit for
    bit, on a plateau too, where the two summation orders pick other
    peaks among equal values."""
    import torch
    import torch.nn.functional as F

    from tfpose_tpu_torch.ops.gaussian import gauss_kernel_1d
    from tfpose_tpu_torch.ops.kernels.smooth_nms import (
        _phase_weights, topk_of_smoothed)

    p = kernlen // 2
    kern = gauss_kernel_1d(kernlen, nsig)
    wv, dvmin, _ = _phase_weights(kern, fy, p)
    wh, dhmin, _ = _phase_weights(kern, fx, p)
    h8, w8, c = heat8.shape
    nv, nh = wv.shape[1], wh.shape[1]
    x = F.pad(heat8.permute(2, 0, 1).float(), (-dhmin, nh, -dvmin, nv))

    def taps_sum(w, view):
        acc = float(w[0]) * view(0)
        for t in range(1, len(w)):
            if w[t] != 0:
                acc = acc + float(w[t]) * view(t)
        return acc

    vw = w8 + nh - 1
    v = torch.stack([taps_sum(wv[a], lambda t: x[:, t:t + h8, :vw])
                     for a in range(fy)], 2).reshape(c, fy * h8, vw)
    sm = torch.stack([taps_sum(wh[b], lambda t: v[:, :, t:t + w8])
                      for b in range(fx)], 3).reshape(c, fy * h8, fx * w8)
    return topk_of_smoothed(sm, k_top, thresh)


def planes_up(net_b, up_h, up_w):
    """(B, h8, w8, 57) -> the (up_h, up_w, B*18) view of channel-first
    area-upsampled part planes that decode_batch gives K4."""
    from tfpose_tpu_torch.ops import resize

    heat = resize.resize_area(net_b[..., :19], up_h, up_w)[..., :18]
    return heat.permute(0, 3, 1, 2).reshape(-1, up_h, up_w).permute(1, 2, 0)


def scene_nets(seed, people, h8, w8):
    """Rendered (len(people), h8, w8, 57) net outputs of people[i]
    people each."""
    import numpy as np

    from tfpose_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    return np.stack([synthetic.render_scene(rng, n, h8, w8)[0]
                     for n in people])


# a BODY_25 person's parts about the neck, in stride-8 cells (x, y)
BODY25_POSE = (
    (0, -4), (0, 0), (-3, 0), (-4, 4), (-5, 8), (3, 0), (4, 4), (5, 8),
    (0, 9), (-2, 9), (-2, 14), (-2, 19), (2, 9), (2, 14), (2, 19),
    (-1, -5), (1, -5), (-2.5, -4), (2.5, -4), (3, 21.5), (4.5, 21.5),
    (1.5, 20.5), (-3, 21.5), (-4.5, 21.5), (-1.5, 20.5))


def body25_maps(people, h8=46, w8=82):
    """(h8, w8, 78) BODY_25 maps of planted people: ``people`` is a list
    of (neck (x, y) in cells, parts to leave out, limbs to leave out).
    Each part a Gaussian (sigma one cell, its centre off the cell grid so
    that the blurred peak is unique) in its heat channel, the background
    1 - their max, and each limb's unit vector within 1.5 cells of its
    segment in the limb's own PAF channels (BODY_25's map-index order)."""
    import numpy as np

    from tfpose_tpu_torch.core.topology import BODY25

    sk = BODY25
    yy, xx = np.mgrid[0:h8, 0:w8].astype(np.float64)
    maps = np.zeros((h8, w8, sk.out_ch))
    for neck, drop_parts, drop_limbs in people:
        parts = np.asarray(BODY25_POSE) + np.asarray(neck) + (0.3, 0.2)
        for p, (x, y) in enumerate(parts):
            if p not in drop_parts:
                g = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 2.0)
                maps[..., p] = np.maximum(maps[..., p], g)
        for i, ((a, b), (cx, cy)) in enumerate(zip(sk.pairs,
                                                   sk.paf_channels)):
            if i in drop_limbs or a in drop_parts or b in drop_parts:
                continue
            d = parts[b] - parts[a]
            length = np.hypot(*d)
            u = d / length
            rx, ry = xx - parts[a][0], yy - parts[a][1]
            along = rx * u[0] + ry * u[1]
            across = np.abs(rx * u[1] - ry * u[0])
            on = (along >= -1) & (along <= length + 1) & (across <= 1.5)
            maps[on, sk.heat_ch + cx] = u[0]
            maps[on, sk.heat_ch + cy] = u[1]
    maps[..., sk.num_parts] = 1.0 - maps[..., :sk.num_parts].max(-1)
    return maps.astype(np.float32)


# three planted BODY_25 people: one whole; one without its right eye, so
# that its right ear joins through the redundant RShoulder-REar limb
# alone; one whose Neck-Nose limb is missing, so that its head is a row
# of its own until LShoulder-LEar and RShoulder-REar fuse it to the body
BODY25_PEOPLE = (((14, 10), (), ()),
                 ((40, 11), (15,), ()),
                 ((66, 9), (), (13,)))


def body25_scenes(n=16):
    """``n`` planted BODY_25 scenes (46x82 maps, stacked): the people of
    ``BODY25_PEOPLE`` shifted along the frame, some dropped."""
    import numpy as np

    out = []
    for i in range(n):
        people = [(((nx + i) % 70 + 6, ny), dp, dl)
                  for j, ((nx, ny), dp, dl) in enumerate(BODY25_PEOPLE)
                  if (i + j) % 4]
        out.append(body25_maps(people))
    return np.stack(out)


def humans_of(out, skeleton=None):
    """A batched decode result -> a list of human lists (COCO-18's parts
    unless ``skeleton`` says otherwise)."""
    from tfpose_tpu_torch.core.topology import COCO18
    from tfpose_tpu_torch.core.types import PoseArrays
    from tfpose_tpu_torch.ops.assemble import Assembled

    arrays = Assembled(*(t.cpu().numpy() for t in out))
    return [PoseArrays.of(Assembled(*(a[i] for a in arrays)),
                          skeleton or COCO18).to_humans()
            for i in range(arrays.coords.shape[0])]


def render_frames(rng, n, h, w):
    """``n`` rendered frames of 1-3 separated people at (h, w)."""
    from tfpose_tpu_torch.utils import synthetic

    out = []
    for _ in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 4)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append(synthetic.render_image(people, h, w, rng))
    return out


def video_serial(est, frames, upsample_size: float = 4.0):
    """The serial loop that ``VideoPipeline`` must equal bit for bit:
    each frame's forward, then its decode without escalation, on the
    current stream, one frame after the other."""
    from tfpose_tpu_torch.core.types import PoseArrays
    from tfpose_tpu_torch.ops.assemble import Assembled
    from tfpose_tpu_torch.ops.decode import decode

    w, h = est.target_size
    out = []
    for frame in frames:
        net = est._forward(frame[None], h, w)[0]
        res = decode(net, int(h / 8 * upsample_size),
                     int(w / 8 * upsample_size), est.decode_params,
                     est.skeleton)
        out.append(est._humans(PoseArrays.of(
            Assembled(*(t.cpu().numpy() for t in res)), est.skeleton)))
    return out


def rendered_coco(n, w, h, seed=7):
    """``synthetic_e2e``'s scenes as ``BatchedEvaluator.evaluate`` takes
    them: ([(image_id, image, (w, h)), ...], COCO ground truth by id)."""
    import numpy as np

    from tfpose_tpu_torch.evaluation.coco_eval import person_to_gt
    from tfpose_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    items, gts = [], {}
    for idx in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 3)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        items.append((idx, synthetic.render_image(people, h, w, rng),
                      (w, h)))
        gts[idx] = [person_to_gt(p) for p in people]
    return items, gts


def same_persons(got, want, what: str) -> None:
    """Equal ``Persons`` except the stamp: part ids exact, x and y within
    1e-6, confidences within 1e-4."""
    check((got.image_w, got.image_h) == (want.image_w, want.image_h),
          f"{what}: image size")
    g = [[(b.part_id, b.x, b.y, b.confidence) for b in p.body_part]
         for p in got.persons]
    w = [[(b.part_id, b.x, b.y, b.confidence) for b in p.body_part]
         for p in want.persons]
    check([[b[0] for b in p] for p in g] == [[b[0] for b in p] for p in w],
          f"{what}: part ids differ")
    for pg, pw in zip(g, w):
        for bg, bw in zip(pg, pw):
            check(abs(bg[1] - bw[1]) <= 1e-6 and abs(bg[2] - bw[2]) <= 1e-6
                  and abs(bg[3] - bw[3]) <= 1e-4,
                  f"{what}: part {bg[0]} {bg[1:]} vs {bw[1:]}")


def humans_key(humans):
    return [(h.score, {p: (b.x, b.y, b.score) for p, b in
                       h.body_parts.items()}) for h in humans]


def same_humans(got, want, what: str) -> None:
    """Same humans, same part sets, coords within 1e-6, scores 1e-4."""
    g, w = humans_key(got), humans_key(want)
    check(len(g) == len(w), f"{what}: {len(g)} humans on the card, "
          f"{len(w)} on the CPU")
    for (s1, p1), (s2, p2) in zip(g, w):
        check(p1.keys() == p2.keys(), f"{what}: part sets differ")
        check(abs(s1 - s2) <= 1e-4, f"{what}: human score {s1} vs {s2}")
        for k in p1:
            check(abs(p1[k][0] - p2[k][0]) <= 1e-6
                  and abs(p1[k][1] - p2[k][1]) <= 1e-6,
                  f"{what}: part {k} coords {p1[k][:2]} vs {p2[k][:2]}")
            check(abs(p1[k][2] - p2[k][2]) <= 1e-4,
                  f"{what}: part {k} score {p1[k][2]} vs {p2[k][2]}")


def same_human_lists(got, want, what: str) -> None:
    """``same_humans`` image by image, and at least one human in all."""
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} images")
    check(sum(len(h) for h in got) > 0, f"{what}: no humans found")
    for i, (g, w) in enumerate(zip(got, want)):
        same_humans(g, w, f"{what} image {i}")


# ---- the mesh: rank bodies, and what they share with the unsharded runs

def counted(run):
    """``run()`` with every kernel's launch count set to 0 just before it
    and read just after: (its result, {kernel: launches})."""
    import torch

    from tfpose_tpu_torch.ops.kernels import wrappers

    kernels = wrappers()
    for fn in kernels.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in kernels.items()}


def train_steps(batches, mesh=None, device=None):
    """``len(batches)`` train steps of the seeded thin at lr 1e-4 (on
    ``mesh``, or unsharded on ``device``): (losses, the state's tensors
    as numpy, one dict: parameters and buffers by name, then 'mu/...'
    and 'nu/...')."""
    import torch

    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.models.layers import init_weights
    from tfpose_tpu_torch.parallel.mesh import (
        assert_replicas_equal, replicated)
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step, replica_tensors)

    net = init_weights(get_network("mobilenet_thin"),
                       torch.Generator().manual_seed(0))
    net = net.to(mesh.device if mesh else device)
    if mesh is not None:
        replicated(mesh, net)
    state = TrainState.create(net, make_optimizer(1e-4))
    step = make_train_step(mesh=mesh)
    losses = [float(step(state, b)[1]["loss"]) for b in batches]
    if mesh is not None:
        assert_replicas_equal(mesh, replica_tensors(state))
    out = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    for which in ("mu", "nu"):
        out.update({f"{which}/{k}": v.cpu().numpy()
                    for k, v in getattr(state, which).items()})
    return losses, out


def state_diff(got, want):
    """A train state against the unsharded one's (``train_steps``): (max
    |d| of parameters; the BN statistics' worst |d| over 1e-7 + 1e-5
    |want|, rtol 1e-5 as allclose; max |d| of mu over the largest
    |mu|)."""
    import numpy as np

    par = [k for k in want if not k.startswith(("mu/", "nu/"))
           and "running" not in k and "num_batches" not in k]
    bn = [k for k in want if "running" in k]
    mu = [k for k in want if k.startswith("mu/")]
    top = max(np.abs(want[k]).max() for k in mu)
    return (max(np.abs(got[k] - want[k]).max() for k in par),
            max((np.abs(got[k] - want[k])
                 / (1e-7 + 1e-5 * np.abs(want[k]))).max() for k in bn),
            max(np.abs(got[k] - want[k]).max() for k in mu) / top)


def evaluate_on(mesh, items, device=None, spatial=False):
    """thin368_coco's ``BatchedEvaluator`` (fp32, batch 8) on ``items``
    (on ``mesh``, its rows split too with ``spatial``, or unsharded on
    ``device``): (the human lists of each batch, their COCO
    detections)."""
    import numpy as np

    from tfpose_tpu_torch.evaluation.coco_eval import humans_to_detections
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator

    kw = (dict(mesh=mesh, spatial=spatial) if mesh is not None
          else dict(device=device))
    ev = BatchedEvaluator("mobilenet_thin", (432, 368), batch_size=8,
                          dtype="float32", **kw)
    ev.load_params(CHECKPOINT)
    humans = [ev.run_batch(np.stack([img for _, img, _ in items[i:i + 8]]))
              for i in range(0, len(items), 8)]
    dets = [d for hs, (image_id, _, (w, h)) in zip(
        [h for batch in humans for h in batch], items)
        for d in humans_to_detections(hs, image_id, w, h)]
    return humans, dets


def sharded_forward(mesh, imgs):
    """thin368_coco on ``mesh`` and a function that runs its forward of
    the uint8 ``imgs`` (rows and batch split as the mesh says) and
    gathers the whole (N, H/8, W/8, 57) maps on every rank."""
    import numpy as np
    import torch

    from tfpose_tpu_torch.convert.checkpoint import (
        load_flax_msgpack, variables_from_numpy)
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.parallel.halo import row_bounds
    from tfpose_tpu_torch.parallel.mesh import (
        gather_blocks, replicated, shard_batch, sharded)
    from tfpose_tpu_torch.pipeline.preprocess import normalize

    net = get_network("mobilenet_thin")
    variables_from_numpy(net, load_flax_msgpack(CHECKPOINT))
    replicated(mesh, net.eval().to(mesh.device))
    x = torch.as_tensor(np.stack(imgs), device=mesh.device)
    n, h, w = x.shape[:3]

    def forward():
        with sharded(mesh, image_hw=(h, w)):
            local = run_backbone(net, normalize(shard_batch(mesh, x)))
        local = gather_blocks(local, row_bounds(-(-h // 8), mesh.n_spatial),
                              mesh.spatial_index, mesh.spatial, dim=1)
        return gather_blocks(local, row_bounds(n, mesh.n_data),
                             mesh.data_index, mesh.data)

    return forward


def rank_nccl(items, batches):
    """NCCL, one rank on the card, with cuDNN's deterministic algorithms
    as the unsharded references take them: an ``all_reduce`` of
    ``arange(5)`` on the mesh's world group, the evaluator on
    ``make_mesh()`` and ``len(batches)`` train steps on it."""
    import torch
    import torch.distributed as dist

    from tfpose_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.deterministic = True
    mesh = make_mesh()
    t = torch.arange(5, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(t, group=mesh.world)
    (humans, dets), launches = counted(lambda: evaluate_on(mesh, items))
    losses, state = train_steps(batches, mesh)
    return {"backend": dist.get_backend(), "device": str(mesh.device),
            "shape": mesh.shape, "all_reduce": t.cpu().numpy(),
            "humans": humans, "dets": dets, "losses": losses,
            "state": state, "launches": launches}


def rank_gloo2(imgs, items, devices):
    """Gloo, two ranks sharing ``devices``: the thin368_coco forward of
    ``imgs`` on a (1 x 2) mesh, gathered; the evaluator on (2 x 1)."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    maps, fwd = counted(sharded_forward(make_mesh(1, 2, devices), imgs))
    (humans, dets), ev = counted(
        lambda: evaluate_on(make_mesh(2, 1, devices), items))
    return {"maps": maps.cpu().numpy(), "humans": humans, "dets": dets,
            "launches": {"forward": fwd, "eval": ev}}


def rank_train(batches, devices):
    """One train step of the seeded thin on a (2 x 2) mesh of four
    ranks over ``devices`` (its end checks the four states equal bit for
    bit); rank 0 returns its state."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, devices)
    losses, state = train_steps(batches, mesh)
    return losses, state if mesh.rank == 0 else None


def rank_cards(items, imgs, batches, devices):
    """Four ranks on four cards: ``rank_train``'s step, the evaluator on
    (4 x 1) and on (2 x 2) with rows split, and the rows-sharded forward
    on (1 x 4)."""
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    out = dict(zip(("losses", "state"), rank_train(batches, devices)))
    for grid, (data, rows) in (("4x1", (4, 1)), ("2x2", (2, 2))):
        (out[f"humans_{grid}"], _), out[f"launches_{grid}"] = counted(
            lambda: evaluate_on(make_mesh(data, rows, devices), items,
                                spatial=rows > 1))
    maps = sharded_forward(make_mesh(1, 4, devices), imgs)()
    out["maps"] = maps.cpu().numpy()
    return out
