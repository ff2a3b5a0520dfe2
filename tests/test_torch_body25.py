"""OpenPose BODY_25 on the port's normal path, on the CPU: the network
against the benchmark's plain reference (``posebench/reference/archs/
body25.py``) on seeded weights, K6's plain version against ``F.prelu``
and ``torch.cat``, the 25-part decode against the reference decoder
(``posebench/reference/decode.py``) on planted humans and the assembly
against its sequential loop, the API's entry points returning BODY_25
humans, their drawing and their messages, and the clear errors of what
knows only COCO-18. Small sizes throughout (the suite's time limit)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (
    BODY25_PEOPLE,
    BODY25_POSE,
    body25_maps,
    random_assembly_case,
)
from posebench.lib import weights
from posebench.lib.cell import humans_px
from posebench.lib.check import humans_gap
from posebench.reference import decode as ref_decode
from posebench.reference import models as ref_models
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import (
    BODY25,
    COCO18,
    Body25Part,
    Skeleton,
)
from tfpose_tpu_torch.core.types import BodyPart, Human, PoseArrays
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import get_network, skeleton_of
from tfpose_tpu_torch.ops.assemble import Assembled, assemble_dense
from tfpose_tpu_torch.ops.decode import decode_batch
from tfpose_tpu_torch.ops.kernels.bias_prelu import bias_prelu
from tfpose_tpu_torch.utils.draw import draw_humans

H8, W8 = 46, 82           # BODY_25's stride-8 grid at 656x368
UP_H, UP_W = 4 * H8, 4 * W8


@pytest.fixture(scope="module")
def tree():
    """The benchmark's seeded BODY_25 tree, with biases and PReLU slopes
    drawn too, so that the forward shows that both reach the program."""
    t = weights.seeded_tree("body25", 2 ** 31 + 5, "cpu")
    gen = torch.Generator().manual_seed(1)

    def draw(node):
        for key, val in node.items():
            if isinstance(val, dict):
                draw(val)
            elif key in ("bias", "alpha"):
                val.copy_(torch.rand(val.shape, generator=gen) * 0.5 - 0.1)

    draw(t)
    return t


def test_fp32_network_matches_the_plain_reference(tree):
    """The port's fp32 BODY_25 with the seeded tree at 64x96, B=2, TF32
    off, against the reference's plain fp32 forward: within 1e-5 of the
    largest map value. Both run each conv without its bias and then the
    bias and the PReLU in fp32, so only the summation order of oneDNN's
    convs on differently laid-out inputs (the program's concat buffers
    are channels-last) may differ; they read bit for bit equal here."""
    net = get_network("body25").eval()
    weights.load_into(net, tree, "body25")
    x = torch.rand((2, 64, 96, 3),
                   generator=torch.Generator().manual_seed(2)) - 0.5
    with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        got = net(x)["concat_stage7"]
        ref = ref_models.forward("body25", tree, x)
    assert got.shape == ref.shape == (2, 8, 12, 78)
    scale = float(ref.abs().max())
    assert scale > 0.1
    assert float((got - ref).abs().max()) <= 1e-5 * scale


def test_bf16_network_rounds_no_worse_than_the_reference(tree):
    """In bf16 the port rounds a conv's output once and its bias and
    PReLU once (K6 works in fp32); the reference in bf16 rounds the bias
    and the slopes too. Its gap to the fp32 reference is thus no larger
    than the bf16 reference's own (the benchmark's ``maps_rms_ratio``),
    with 10 % of room for other summation orders."""
    net = get_network("body25", torch.bfloat16).eval()
    weights.load_into(net, tree, "body25")
    x = torch.rand((1, 64, 96, 3),
                   generator=torch.Generator().manual_seed(3)) - 0.5
    with torch.no_grad():
        got = net(x)["concat_stage7"]
        ref = ref_models.forward("body25", tree, x)
        low = ref_models.forward("body25", tree, x, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ratio = float((got.float() - ref).norm() / (low - ref).norm())
    assert 0 < ratio <= 1.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous_format"])
def test_k6_plain_equals_prelu_and_cat(dtype, layout):
    """K6's plain version (the CPU path of ``bias_prelu``): three
    channels-last convs' outputs, the first two written in place and into
    their slices of a concat buffer, the last into its slice alone, equal
    ``F.prelu(y + bias)`` in fp32 rounded once and ``torch.cat`` of the
    three, bit for bit. The same in NCHW (``contiguous_format``), the
    layout the kernel does not take, is refused with nothing written, on
    the CPU as on the card."""
    fmt = getattr(torch, layout)
    gen = torch.Generator().manual_seed(4)
    ys = [torch.randn((2, 16, 5, 7), generator=gen).to(dtype)
          .contiguous(memory_format=fmt) for _ in range(3)]
    bias = [torch.randn(16, generator=gen) for _ in range(3)]
    alpha = [torch.rand(16, generator=gen) - 0.2 for _ in range(3)]
    want = [F.prelu(y.float() + b[:, None, None], a).to(dtype)
            for y, b, a in zip(ys, bias, alpha)]
    buf = torch.zeros((2, 48, 5, 7), dtype=dtype).contiguous(
        memory_format=fmt)
    bias_prelu.launches = 0
    for i, (y, b, a) in enumerate(zip(ys, bias, alpha)):
        outs = [buf[:, 16 * i:16 * (i + 1)]]
        if i < 2:
            outs.insert(0, y)
        if layout == "contiguous_format":
            with pytest.raises(ValueError, match="channels-last"):
                bias_prelu(y, b, a, outs)
            continue
        bias_prelu(y, b, a, outs)
    assert bias_prelu.launches == 0
    if layout == "contiguous_format":
        assert not buf.any()
        return
    assert torch.equal(buf, torch.cat(want, 1))
    assert torch.equal(ys[0], want[0]) and torch.equal(ys[1], want[1])


def test_k6_launch_plan():
    """What the kernel is launched with: a channels-last conv output and
    its slice of a channels-last concat buffer give the sizes (N, H, W,
    C) and each tensor's N, H, W strides, the channel stride being 1;
    the third stride set is 0 where there is one output."""
    from tfpose_tpu_torch.ops.kernels.bias_prelu import _layout

    def plan(y, *outs):
        sizes, strides = _layout(tuple(y.shape), y.element_size(),
                                 tuple(t.stride() for t in (y, *outs)))
        return list(sizes), list(strides)

    cl = torch.channels_last
    y = torch.empty((2, 96, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=cl)
    buf = torch.empty((2, 288, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=cl)
    assert plan(y, y, buf[:, 96:192]) == (
        [2, 5, 7, 96],
        [3360, 672, 96, 3360, 672, 96, 10080, 2016, 288])
    assert plan(y, y) == ([2, 5, 7, 96], [3360, 672, 96] * 2 + [0] * 3)


def test_k6_wrapper_rejects_what_the_kernel_does_not_take():
    y = torch.zeros((1, 4, 2, 2)).contiguous(memory_format=torch.channels_last)
    ok = torch.zeros(4)
    bias_prelu(y, ok, ok, [y])
    for args in ((y.double(), ok, ok, [y.double()]),
                 (y, torch.zeros(3), ok, [y]),
                 (y, ok, ok.double(), [y]),
                 (y, ok, ok, []),
                 (y, ok, ok, [y, y, y]),
                 (y, ok, ok, [torch.zeros((1, 4, 2, 3))])):
        with pytest.raises(ValueError, match="bias_prelu"):
            bias_prelu(*args)


def _off_layout(case):
    cl = torch.channels_last
    if case == "nchw":
        y = torch.zeros((2, 16, 5, 7), dtype=torch.bfloat16)
        return y, [y]
    if case == "c52-bf16":       # 104 bytes of channels: no 16-byte steps
        y = torch.zeros((2, 52, 5, 7), dtype=torch.bfloat16).contiguous(
            memory_format=cl)
        return y, [y]
    if case == "c6-fp32":
        y = torch.zeros((2, 6, 5, 7)).contiguous(memory_format=cl)
        return y, [y]
    # a slice 4 bf16 channels (8 bytes) into a concat buffer
    y = torch.zeros((2, 16, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=cl)
    buf = torch.zeros((2, 48, 5, 7), dtype=torch.bfloat16).contiguous(
        memory_format=cl)
    return y, [y, buf[:, 4:20]]


@pytest.mark.parametrize("case", ["nchw", "c52-bf16", "c6-fp32",
                                  "unaligned-slice"])
def test_k6_refuses_layouts_off_its_path(case):
    """The kernel moves 16 bytes of channels a step in channels-last
    tensors; any other layout is refused on every device, with nothing
    written."""
    y, outs = _off_layout(case)
    ones = torch.ones(y.shape[1])
    y.fill_(1.0)
    with pytest.raises(ValueError, match="channels-last"):
        bias_prelu(y, ones, ones, outs)
    assert bool((y == 1).all())
    assert not any(bool(out.any()) for out in outs[1:])


def test_the_skeleton_tables():
    """BODY_25's tables, OpenPose's: 25 parts and the background, 26
    limbs whose PAF channels are not in limb order, the shoulder-ear
    limbs redundant in the middle; a table that is no tree grown in
    order is refused."""
    assert (BODY25.num_parts, BODY25.heat_ch, BODY25.paf_ch,
            BODY25.out_ch) == (25, 26, 52, 78)
    assert [BODY25.pairs[i] for i in BODY25.redundant] == [(2, 17), (5, 18)]
    assert BODY25.paf_channels[1] == (14, 15)
    assert len(BODY25.render_pairs) == 24 == len(BODY25.colors) - 1
    assert Body25Part(BODY25.index("LBigToe")).name == "LBigToe"
    assert skeleton_of("body25") is BODY25
    assert skeleton_of("mobilenet_thin") is skeleton_of("vgg") is COCO18
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "posebench", "reference",
            "skeletons", "body25.json")) as f:
        doc = json.load(f)
    assert [tuple(p) for p in doc["pairs"]] == list(BODY25.pairs)
    assert [tuple(p) for p in doc["paf_channels"]] == list(
        BODY25.paf_channels)
    assert tuple(doc["redundant"]) == BODY25.redundant
    bad = dict(pairs=BODY25.pairs[:20] + ((19, 14),) + BODY25.pairs[21:])
    with pytest.raises(ValueError, match="tree grown in order"):
        dataclasses.replace(BODY25, **bad)
    with pytest.raises(ValueError, match="tree grown in order"):
        dataclasses.replace(BODY25, redundant=(18, 20))


@pytest.fixture(scope="module")
def planted():
    """The planted people's maps (46x82), their humans from the port's
    batched decode (CPU: every kernel's plain version) and from the
    reference decoder, both at the 4x decode size."""
    maps = body25_maps(BODY25_PEOPLE)
    out = decode_batch(torch.from_numpy(maps)[None], UP_H, UP_W,
                       DecodeParams(), BODY25)
    humans = PoseArrays.of(Assembled(*(t[0].numpy() for t in out)),
                           BODY25).to_humans()
    ref = ref_decode.decode(torch.from_numpy(maps), UP_H, UP_W,
                            skeleton=ref_decode.skeleton("body25"))
    return maps, humans, ref


def test_decode_of_planted_people_equals_the_reference(planted):
    """Three planted people, their PAF channels in BODY_25's map-index
    order: one whole, one whose right ear joins through the redundant
    RShoulder-REar limb alone (no right eye), one whose head joins its
    body through the redundant limbs only (no Neck-Nose limb). The port's
    humans are the reference decoder's, parts in place and scores within
    1e-4 (the benchmark's ``humans_gap`` limit)."""
    _, humans, ref = planted
    counts = sorted(len(h.body_parts) for h in humans)
    assert counts == sorted(len(p) for p, _ in ref) == [24, 25, 25]
    assert all(h.skeleton is BODY25 for h in humans)
    no_eye = [h for h in humans if len(h.body_parts) == 24][0]
    assert 15 not in no_eye.body_parts and 17 in no_eye.body_parts
    assert humans_gap(ref, humans_px(humans, UP_W, UP_H)) <= 1e-4


@pytest.mark.parametrize("seed", range(6))
def test_assembly_equals_the_sequential_loop(seed):
    """Random BODY_25 connections (rows fuse, attach and extend through
    the redundant limbs, foot limbs after them): the port's assembly
    equals the reference decoder's sequential loop over the limbs in
    their order, humans and scores."""
    pk, conns = random_assembly_case(BODY25, b=4, k=6, seed=seed)
    params = DecodeParams(max_humans=64)
    out = assemble_dense(pk, conns, params, skeleton=BODY25)
    k = pk.x.shape[2]
    sk = ref_decode.skeleton("body25")
    for i in range(pk.x.shape[0]):
        by_limb = []
        for lim, (pa, pb) in enumerate(BODY25.pairs):
            cs = []
            for t in range(k):
                if not bool(conns.valid[i, lim, t]):
                    break
                a, b = int(conns.a_slot[i, lim, t]), int(conns.b_slot[i, lim, t])
                cs.append(ref_decode.Connection(
                    float(conns.score[i, lim, t]), pa * k + a, pb * k + b,
                    float(pk.score[i, pa, a]), float(pk.score[i, pb, b])))
            by_limb.append(cs)
        ref = []
        for row in ref_decode.assemble(by_limb, ref_decode.PARAMS, sk):
            parts = {}
            for p in range(25):
                if row[p] >= 0:
                    q, s = divmod(int(row[p]), k)
                    parts[p] = (int(pk.x[i, q, s]), int(pk.y[i, q, s]),
                                float(pk.score[i, q, s]))
            ref.append((parts, row[25] / row[26]))
        got = humans_px(PoseArrays.of(
            Assembled(*(t[i].numpy() for t in out)), BODY25).to_humans(), 1, 1)
        assert len(ref) > 0
        assert humans_gap(ref, got) <= 1e-5


class _PlantedNet(torch.nn.Module):
    """Stands in for a network: every image's maps are the planted ones."""

    def __init__(self, maps):
        super().__init__()
        self.maps = torch.from_numpy(maps)

    def forward(self, x):
        return {"concat_stage7": self.maps.expand(x.shape[0], -1, -1, -1)}


def test_entry_points_return_body25_humans(planted):
    """``TfPoseEstimator("body25")`` at 656x368 in bf16 (its network's maps
    replaced by the planted ones): ``inference``, ``inference_batch``,
    ``VideoPipeline`` and ``BatchedEvaluator.run_batch`` return the
    planted people as BODY_25 humans with named parts."""
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.pipeline.video import VideoPipeline

    maps, want, _ = planted
    est = TfPoseEstimator("body25", target_size=(656, 368), dtype="bfloat16",
                          device="cpu")
    assert est.skeleton is BODY25
    est.net = _PlantedNet(maps)
    img = np.zeros((368, 656, 3), np.uint8)
    key = sorted(sorted(h.body_parts) for h in want)
    single = est.inference(img, upsample_size=4.0)
    batch = est.inference_batch([img, img], upsample_size=4.0)
    video = [h for _, h in VideoPipeline(est, 4.0, depth=2).run([img])]
    ev = BatchedEvaluator("body25", (656, 368), batch_size=2, device="cpu")
    ev.net = _PlantedNet(maps)
    swept = ev.run_batch(np.stack([img, img]))
    for humans in [single, *batch, *video, *swept]:
        assert sorted(sorted(h.body_parts) for h in humans) == key
        for h in humans:
            assert h.skeleton is BODY25
            bp = h.body_parts[22]
            assert bp.get_part_name() is Body25Part.RBigToe
    assert est.heatMat.shape == (UP_H, UP_W, 26)
    assert est.pafMat.shape == (UP_H, UP_W, 52)


def _body25_human():
    pose = (np.asarray(BODY25_POSE) + (20, 8)) / (48, 40)
    h = Human(skeleton=BODY25)
    for p, (x, y) in enumerate(pose):
        h.body_parts[p] = BodyPart(f"0-{p}", p, float(x), float(y), 0.8,
                                   BODY25)
    return h


def test_a_body25_human_is_drawn_and_serialised():
    """Drawn: a ring in each part's colour and a line per render pair,
    the toes included; serialised: the message names its skeleton, reads
    back as the same BODY_25 human, and a COCO-18 message has no such
    key (the JAX package's format)."""
    from tfpose_tpu_torch.cli.visualization import msg_to_humans
    from tfpose_tpu_torch.serving.messages import Persons, humans_to_msg

    h = _body25_human()
    img = draw_humans(np.zeros((320, 384, 3), np.uint8), [h])
    for p in (0, 19, 24):
        cx = int(h.body_parts[p].x * 384 + 0.5)
        cy = int(h.body_parts[p].y * 320 + 0.5)
        ring = img[cy - 5:cy + 6, cx - 5:cx + 6].reshape(-1, 3)
        assert (ring == BODY25.colors[p]).all(1).any()
    assert len({tuple(c) for c in img.reshape(-1, 3)}) > 10
    d = humans_to_msg([h], 384, 320, BODY25).to_dict()
    assert d["skeleton"] == "body25"
    back = msg_to_humans(Persons.from_dict(json.loads(json.dumps(d))))
    assert back[0].skeleton is BODY25
    assert {p: (b.x, b.y) for p, b in back[0].body_parts.items()} == {
        p: (b.x, b.y) for p, b in h.body_parts.items()}
    assert "skeleton" not in humans_to_msg([], 4, 4).to_dict()
    box = h.get_upper_body_box(384, 320)
    assert box is not None and h.get_face_box(384, 320) is not None


def test_coco_only_paths_refuse_body25():
    """COCO keypoint evaluation and training know COCO-18's parts only:
    BODY_25 is refused with a clear error, not mapped as COCO."""
    from tfpose_tpu_torch.evaluation.coco_eval import write_coco_json
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.train.state import batch_loss

    with pytest.raises(NotImplementedError, match="COCO-18"):
        write_coco_json(_body25_human(), 100, 100)
    ev = BatchedEvaluator("body25", (64, 64), batch_size=1, device="cpu")
    with pytest.raises(NotImplementedError, match="COCO-18"):
        ev.evaluate([])
    with pytest.raises(NotImplementedError, match="BODY_25"):
        batch_loss(get_network("body25"), {})
    assert isinstance(BODY25, Skeleton)
