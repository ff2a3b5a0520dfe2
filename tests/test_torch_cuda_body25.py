"""OpenPose BODY_25 on the card: K6 against its plain version, K1, K3 and
K5 with BODY_25's 25 parts and 26 limbs against theirs, the decode of
planted people against the CPU's, and the bf16 network against the
benchmark's plain reference.

Marked ``cuda``: without a card they skip (decided inside the fixture,
``torch_cases.card``).
On the card they run with the other card tests (README.md, "PyTorch / CUDA
port").
"""

import contextlib

import numpy as np
import pytest
import torch

import torch_cases
from torch_cases import (
    assembly_inputs,
    body25_scenes,
    counted,
    k1_phase_reference,
    k3_compare,
    k5_compare,
    random_assembly_case,
    same_humans,
)
from posebench.lib import weights
from posebench.reference import models as ref_models
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import BODY25
from tfpose_tpu_torch.core.types import PoseArrays
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.ops.assemble import (
    Assembled,
    assemble_dense,
    assemble_dense_plain,
)
from tfpose_tpu_torch.ops.decode import decode_batch
from tfpose_tpu_torch.ops.kernels.bias_prelu import (
    bias_prelu,
    bias_prelu_plain,
)
from tfpose_tpu_torch.ops.kernels.paf_score import (
    score_candidates_raw,
    score_candidates_raw_plain,
)
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    smooth_nms_topk_raw,
    smooth_nms_topk_raw_plain,
)
from tfpose_tpu_torch.ops.nms import Peaks

pytestmark = pytest.mark.cuda
H8, W8 = 46, 82


@pytest.fixture(scope="module")
def card():
    dev = torch_cases.card()
    torch.backends.cudnn.allow_tf32 = False
    return dev


@pytest.fixture(scope="module")
def scenes(card):
    return torch.from_numpy(body25_scenes()).to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [96, 128, 256, 512])
def test_k6_equals_its_plain_version(card, dtype, c):
    """At BODY_25's B=16 grid, channels last as the network holds its
    activations: a block's three convs into a concat buffer (two also in
    place), and a whole tensor in place (Mconv6 and the CPM convs at 256
    and 512), bit for bit against the plain version."""
    cl = torch.channels_last
    gen = torch.Generator(device=card).manual_seed(c)
    ys = [torch.randn((16, c, H8, W8), generator=gen, device=card)
          .to(dtype).contiguous(memory_format=cl) for _ in range(3)]
    bias = torch.randn(c, generator=gen, device=card)
    alpha = torch.rand(c, generator=gen, device=card) - 0.2
    buf = torch.zeros((16, 3 * c, H8, W8), dtype=dtype, device=card
                      ).contiguous(memory_format=cl)
    ref = buf.cpu()
    ys_ref = [y.cpu() for y in ys]
    for i in range(3):
        outs = [buf[:, i * c:(i + 1) * c]]
        outs_ref = [ref[:, i * c:(i + 1) * c]]
        if i < 2:
            outs.insert(0, ys[i])
            outs_ref.insert(0, ys_ref[i])
        n = bias_prelu.launches
        bias_prelu(ys[i], bias, alpha, outs)
        assert bias_prelu.launches == n + 1
        bias_prelu_plain(ys_ref[i], bias.cpu(), alpha.cpu(), outs_ref)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), ref)
    for y, y_ref in zip(ys, ys_ref):
        assert torch.equal(y.cpu(), y_ref)
    whole = ys[2].clone(memory_format=cl)
    bias_prelu(whole, bias, alpha, [whole])
    bias_prelu_plain(ys_ref[2], bias.cpu(), alpha.cpu(), [ys_ref[2]])
    assert torch.equal(whole.cpu(), ys_ref[2])


def test_k6_refuses_layouts_off_its_path(card):
    """NCHW, 52 bf16 channels (no 16-byte steps) and a slice 8 bytes
    into a buffer are refused on the card too, with nothing launched."""
    cl = torch.channels_last
    y = torch.ones((16, 96, H8, W8), dtype=torch.bfloat16, device=card)
    y52 = torch.ones((16, 52, H8, W8), dtype=torch.bfloat16,
                     device=card).contiguous(memory_format=cl)
    buf = torch.zeros((16, 288, H8, W8), dtype=torch.bfloat16,
                      device=card).contiguous(memory_format=cl)
    n = bias_prelu.launches
    for t, outs in ((y, [y]), (y52, [y52]),
                    (y.contiguous(memory_format=cl), [buf[:, 4:100]])):
        ones = torch.ones(t.shape[1], device=card)
        with pytest.raises(ValueError, match="channels-last"):
            bias_prelu(t, ones, ones, outs)
    assert bias_prelu.launches == n and not bool(buf.any())


def test_k1_with_25_parts(scenes):
    """The 16 x 25 heat planes: K1 against its plain version (indices
    exact, scores rtol 1e-5) and bit for bit against its own arithmetic."""
    heat8 = scenes[..., :25].permute(1, 2, 0, 3).reshape(H8, W8, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), 4, 4, 32, 0.05)
    s0, i0 = smooth_nms_topk_raw_plain(heat8, 4, 4, 32, 0.05)
    assert torch.equal(i, i0)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    s1, i1 = k1_phase_reference(heat8, 4, 4, 32, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)
    assert int((s > 0.05).sum()) > 16 * 25


def _peaks(scenes):
    heat8 = scenes[..., :25].permute(1, 2, 0, 3).reshape(H8, W8, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), 4, 4, 32, 0.05)
    s, i = s.reshape(16, 25, -1), i.reshape(16, 25, -1).clamp(min=0)
    return Peaks(x=i % (4 * W8), y=i // (4 * W8), score=s, valid=s > 0.05)


def test_k3_with_26_limbs(scenes):
    """K3 on the 26 limbs' raw PAF (BODY_25's map-index channels) bit for
    bit against its plain version."""
    pk = _peaks(scenes)
    paf = scenes[..., 26:]
    got = score_candidates_raw(pk, paf, 4 * H8, 4 * W8, DecodeParams(),
                               skeleton=BODY25)
    want = score_candidates_raw_plain(pk, paf, 4 * H8, 4 * W8,
                                      DecodeParams(), skeleton=BODY25)
    assert got.score.shape == (16, 26, 32, 32)
    k3_compare(got, want, "BODY_25 planted scenes")
    assert int(got.ok.sum()) > 16 * 20


def test_k5_with_25_parts(scenes, card):
    """K5 with BODY_25's redundant limbs in the middle of its limb order:
    on the planted scenes' assembly inputs and on random connections
    (rows fuse, attach and extend), every field bit for bit against the
    plain version."""
    params = DecodeParams()
    pk, conns = assembly_inputs(scenes, 4 * H8, 4 * W8, params, BODY25)
    k5_compare(assemble_dense(pk, conns, params, skeleton=BODY25),
               assemble_dense_plain(pk, conns, params, BODY25),
               "BODY_25 planted scenes")
    wide = DecodeParams(max_humans=64)
    for seed in range(3):
        pk, conns = random_assembly_case(BODY25, b=16, k=8, seed=seed)
        got = assemble_dense(Peaks(*(t.to(card) for t in pk)),
                             type(conns)(*(t.to(card) for t in conns)),
                             wide, skeleton=BODY25)
        want = assemble_dense_plain(pk, conns, wide, BODY25)
        k5_compare(Assembled(*(t.cpu() for t in got)), want,
                   f"random BODY_25 connections, seed {seed}")


def test_decode_on_the_card_equals_the_cpu(scenes):
    """The batched 25-part decode on the card (K1, K3, greedy, K5, each
    launched once) gives the CPU's humans, of BODY_25's parts."""
    params = DecodeParams()
    out, n = counted(lambda: decode_batch(scenes, 4 * H8, 4 * W8, params,
                                          BODY25))
    assert n == {"smooth_nms_topk_raw": 1, "smooth_nms": 0,
                 "score_candidates_raw": 1, "smooth_nms_topk": 0,
                 "assemble_dense": 1, "bias_prelu": 0}
    ref = decode_batch(scenes.cpu(), 4 * H8, 4 * W8, params, BODY25)
    for i in range(16):
        got = PoseArrays.of(Assembled(*(t[i].cpu().numpy() for t in out)),
                            BODY25).to_humans()
        want = PoseArrays.of(Assembled(*(t[i].numpy() for t in ref)),
                             BODY25).to_humans()
        assert got, f"image {i}: no humans"
        assert all(h.skeleton is BODY25 and len(h.body_parts) <= 25
                   for h in got)
        same_humans(got, want, f"BODY_25 image {i}")


def test_bf16_network_against_the_reference(card):
    """The program's bf16 BODY_25 at 184x328, B=4, on seeded weights
    against the benchmark's fp32 reference (TF32 off) on the card: its
    gap within 1.5 times the gap of the reference computed in bf16 (the
    benchmark's ``maps_rms_ratio``), and 99 K6 launches a forward."""
    tree = weights.seeded_tree("body25", 2 ** 31 + 11, card)
    net = get_network("body25", torch.bfloat16).eval().to(card)
    weights.load_into(net, tree, "body25")
    x = torch.rand((4, 184, 328, 3), device=card,
                   generator=torch.Generator(device=card).manual_seed(5)) - 0.5
    with torch.inference_mode():
        n = bias_prelu.launches
        got = net(x)["concat_stage7"].float()
        assert bias_prelu.launches == n + 99
    ref = ref_models.forward("body25", tree, x)
    low = ref_models.forward("body25", tree, x, dtype=torch.bfloat16)
    ratio = float((got - ref).norm() / (low - ref).norm())
    assert got.shape == (4, 23, 41, 78)
    assert 0 < ratio <= 1.5


def test_body25_replays_with_k6_inside_the_graph(card):
    """bf16 BODY_25 at B=2 656x368 (seeded weights) through
    ``inference_batch``, three calls: eager, capture, replay. Each call's
    maps equal the eager forward's bit for bit, with K6 inside the
    graph, and each call counts 99 ``bias_prelu`` and one
    ``assemble_dense`` launches, the replay's added by the graph; the
    replay's own trace (torch.profiler) holds the 99 K6 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tfpose_tpu_torch.estimator import (
        TfPoseEstimator,
        forward_eager,
        run_backbone,
    )
    from tfpose_tpu_torch.ops.kernels.bias_prelu import bias_prelu as k6
    from tfpose_tpu_torch.pipeline.preprocess import prepare

    est = TfPoseEstimator("body25", target_size=(656, 368),
                          dtype="bfloat16", params_path="no-checkpoint",
                          device="cuda")
    rng = np.random.default_rng(25)
    frames = [rng.integers(0, 256, (2, 368, 656, 3), np.uint8)
              for _ in range(3)]
    want = [forward_eager(est.net, prepare(torch.from_numpy(f).cuda(),
                                           368, 656)) for f in frames]
    maps = []
    est.net.register_forward_hook(
        lambda m, a, out: maps.append(out["concat_stage7"]))
    kinds, counts = [], []
    for i, f in enumerate(frames):
        before = (run_backbone.eager, run_backbone.captures,
                  run_backbone.replays)
        k6.launches = assemble_dense.launches = 0
        prof = profile(activities=[ProfilerActivity.CUDA])
        with prof if i == 2 else contextlib.nullcontext():
            est.inference_batch(list(f), upsample_size=4.0)
            torch.cuda.synchronize()
        counts.append((k6.launches, assemble_dense.launches))
        after = (run_backbone.eager, run_backbone.captures,
                 run_backbone.replays)
        kinds.append(("eager", "captures", "replays")[
            [a - b for a, b in zip(after, before)].index(1)])
    assert kinds == ["eager", "captures", "replays"]
    assert counts == [(99, 1)] * 3
    assert sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "bias_prelu_vec" in e.key) == 99
    assert len(maps) == 3
    for got, w in zip(maps, want):
        assert torch.equal(got.float(), w)
