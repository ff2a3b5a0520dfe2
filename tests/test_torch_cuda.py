"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card they skip (the decision is made inside
the fixture, so every worker collects the same tests). On the card,
whose Python has no jax for ``tests/conftest.py``:
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import os
import threading

import numpy as np
import pytest
import torch

from chip_smoke import (
    CHECKPOINT,
    heat8_of,
    humans_key,
    k1_phase_reference,
    k2_compare,
    k3_compare,
    k4_compare,
    peaks_of,
    planes_up,
    render_frames,
    same_persons,
    scene_nets,
    video_serial,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.core.topology import pairs_array
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.models import MODEL_NAMES, get_network
from tfpose_tpu_torch.models.layers import init_weights
from tfpose_tpu_torch.ops import resize
from tfpose_tpu_torch.ops.kernels.paf_score import (
    score_candidates_raw,
    score_candidates_raw_plain,
)
from tfpose_tpu_torch.ops.kernels.smooth_nms import (
    smooth_nms,
    smooth_nms_plain,
    smooth_nms_topk,
    smooth_nms_topk_plain,
    smooth_nms_topk_raw,
    smooth_nms_topk_raw_plain,
)
from tfpose_tpu_torch.utils import synthetic

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    scenes = [synthetic.render_scene(rng, n, 46, 54)[0] for n in (3, 0, 5)]
    return torch.from_numpy(np.stack(scenes)).cuda()


@pytest.mark.parametrize("k", [32, 128])
@pytest.mark.parametrize("cap", [4096, 8])
def test_topk_raw_kernel(nets, k, cap):
    """184x216 planes (not a multiple of the 32x64 tile); ``cap=8``
    takes the radix-select path. Indices exact, scores rtol 1e-5 against
    the plain version, bit for bit against the kernel's own phase
    arithmetic."""
    heat8 = nets[..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), 4, 4, k, 0.05, cap=cap)
    s0, i0 = smooth_nms_topk_raw_plain(heat8, 4, 4, k, 0.05)
    assert torch.equal(i, i0)
    torch.testing.assert_close(s, s0, rtol=1e-5, atol=0)
    s1, i1 = k1_phase_reference(heat8, 4, 4, k, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)


@pytest.mark.parametrize("f", [1, 2, 3])
def test_topk_raw_kernel_other_factors(nets, f):
    """Factors other than 4 run the kernel's run-time loops."""
    heat8 = nets[..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    s, i = smooth_nms_topk_raw(heat8.contiguous(), f, f, 32, 0.05)
    s1, i1 = k1_phase_reference(heat8, f, f, 32, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)
    assert torch.equal(i, smooth_nms_topk_raw_plain(heat8, f, f, 32, 0.05)[1])


@pytest.mark.parametrize("cap", [4096, 16])
def test_topk_raw_kernel_on_a_plateau(nets, cap):
    """A plateau makes peaks of near-equal values: the two summation
    orders pick different ones, so the kernel is held bit for bit
    against its own phase arithmetic; a plane below the threshold has
    no peak."""
    x = torch.full((46, 54, 2), 0.5, device=nets.device)
    x[..., 1] = 0.01
    s, i = smooth_nms_topk_raw(x, 4, 4, 128, 0.05, cap=cap)
    s1, i1 = k1_phase_reference(x, 4, 4, 128, 0.05)
    assert torch.equal(i, i1) and torch.equal(s, s1)
    assert bool((i[0] >= 0).all()) and bool((i[1] == -1).all())


@pytest.fixture(scope="module")
def nets8(nets):
    rng = np.random.default_rng(8)
    scenes = [synthetic.render_scene(rng, n, 46, 54)[0]
              for n in (1, 4, 0, 2, 6)]
    return torch.cat([nets, torch.from_numpy(np.stack(scenes)).cuda()])


@pytest.mark.parametrize("shape, kernlen", [
    ((184, 216), 25), ((46, 54), 25), ((115, 135), 25), ((10, 12), 25),
    ((22, 26), 25), ((184, 216), 13)])
def test_smooth_nms_kernel(nets, shape, kernlen):
    """Bit for bit against the plain version on the 4x and 2.5x maps, the
    warm-up's 1x maps and at 13 taps (the run-time loops)."""
    heat = resize.resize_area(nets[0, ..., :19], *shape).contiguous()
    k2_compare(smooth_nms(heat, kernlen), smooth_nms_plain(heat, kernlen),
               f"{shape} {kernlen} taps")


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [32, 128])
def test_paf_sample_kernel(nets8, b, k):
    """The fused candidate scorer bit for bit against its plain version
    (``ok`` and ``score``), with one pair of image 0 without a valid
    a-peak (the row skip's nrows 0)."""
    heat8 = nets8[:b, ..., :18].permute(1, 2, 0, 3).reshape(46, 54, -1)
    pk = peaks_of(*smooth_nms_topk_raw(heat8.contiguous(), 4, 4, k, 0.05),
                  b, 216)
    valid = pk.valid.clone()
    valid[0, pairs_array()[0, 0]] = False
    pk = pk._replace(valid=valid)
    params = DecodeParams()
    got = score_candidates_raw(pk, nets8[:b, ..., 19:], 184, 216, params)
    k3_compare(got, score_candidates_raw_plain(pk, nets8[:b, ..., 19:], 184,
                                               216, params), f"B={b} K={k}")
    assert not bool(got.ok[0, 0].any()) and bool(got.ok.any())


def test_paf_sample_kernel_on_the_windowed_grid(nets):
    """A 1280x720 frame's merged 90x160 grid at 4x, peaks from the
    full-resolution top-K, with and without the row skip."""
    net = torch.from_numpy(synthetic.render_scene(
        np.random.default_rng(4), 3, 90, 160)[0]).to(nets.device)
    pk = peaks_of(*smooth_nms_topk(planes_up(net[None], 360, 640), 32, 0.05),
                  1, 640)
    params = DecodeParams()
    for prefix_valid in (True, False):
        args = (pk, net[None, ..., 19:], 360, 640, params, prefix_valid)
        got = score_candidates_raw(*args)
        k3_compare(got, score_candidates_raw_plain(*args), "90x160")
    assert bool(got.ok.any())


@pytest.mark.parametrize("k, cap", [(32, 4096), (128, 4096), (32, 32)])
@pytest.mark.parametrize("up", [(360, 640), (115, 135)])
def test_full_res_topk_kernel(nets, up, k, cap):
    """Scene planes as decode hands them over (a (H, W, C) view of
    channel-first planes); ``cap=32`` takes the radix-select path.
    Indices exact, scores 1e-6."""
    x = planes_up(nets, *up)
    k4_compare(smooth_nms_topk(x, k, 0.05, cap=cap),
               smooth_nms_topk_plain(x, k, 0.05))


def test_full_res_topk_kernel_on_a_plateau(nets):
    """Every interior pixel of a plateau is a peak: far more than the
    kernel's shared list, so it selects by radix from device memory."""
    x = torch.full((360, 640, 2), 0.5, device=nets.device)
    x[..., 1] = 0.01
    got = smooth_nms_topk(x, 128, 0.05)
    k4_compare(got, smooth_nms_topk_plain(x, 128, 0.05))
    assert bool((got[1][0].diff() > 0).all()) and bool((got[1][1] == -1).all())


def test_full_res_topk_kernel_other_blur_length(nets):
    """A blur length other than 25 runs the kernel's run-time loops."""
    x = planes_up(nets, 115, 135)
    for kernlen in (13, 4):
        k4_compare(smooth_nms_topk(x, 32, 0.05, kernlen=kernlen),
                   smooth_nms_topk_plain(x, 32, 0.05, kernlen))


# the new backbones' grids: CMU at 656x368 (46x82, B=16) and
# mobilenet_v2_small at 368x368 (46x46, B=8)
_GRIDS = {(46, 82): [3, 1, 5, 0, 2, 6, 4, 2] * 2, (46, 46): [2, 1, 3, 0, 2,
                                                            4, 1, 2]}


@pytest.fixture(scope="module")
def grid_nets(nets):
    return {g: torch.from_numpy(scene_nets(sum(g), people, *g)).to(
        nets.device) for g, people in _GRIDS.items()}


@pytest.mark.parametrize("grid", sorted(_GRIDS))
@pytest.mark.parametrize("k", [32, 128])
def test_topk_raw_kernel_at_the_new_grids(grid_nets, grid, k):
    """K1 at (46, 82, 288) and (46, 46, 144), and at B=1: bit for bit
    against its phase arithmetic; against the plain version the same
    peaks with scores rtol 1e-5. Here two peaks of one 46x46 plane lie
    an ulp apart and take each other's place in the plain version's
    order (it sums the upsampled blur in another order; the CPU shows the
    same swap between the plain version and the phase arithmetic), so
    the peaks are compared as sets."""
    net = grid_nets[grid]
    for b in (1, len(net)):
        heat8 = heat8_of(net[:b]).contiguous()
        s, i = smooth_nms_topk_raw(heat8, 4, 4, k, 0.05)
        s1, i1 = k1_phase_reference(heat8, 4, 4, k, 0.05)
        assert torch.equal(i, i1) and torch.equal(s, s1)
        s0, i0 = smooth_nms_topk_raw_plain(heat8, 4, 4, k, 0.05)
        i_sorted, order = i.sort(1)
        i0_sorted, order0 = i0.sort(1)
        assert torch.equal(i_sorted, i0_sorted) and bool((i >= 0).any())
        torch.testing.assert_close(s.gather(1, order), s0.gather(1, order0),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_smooth_nms_kernel_at_the_new_grids(grid_nets, grid):
    """K2 at 184x328x19 (two waves of tiles) and 184x184x19, bit for bit."""
    h8, w8 = grid
    heat = resize.resize_area(grid_nets[grid][0, ..., :19], 4 * h8,
                              4 * w8).contiguous()
    k2_compare(smooth_nms(heat), smooth_nms_plain(heat), f"{heat.shape}")


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_paf_sample_kernel_at_the_new_grids(grid_nets, grid):
    """K3 at 46x82 B=16 and 46x46 B=8, with and without the row skip."""
    h8, w8 = grid
    net = grid_nets[grid]
    b, up_h, up_w = len(net), 4 * h8, 4 * w8
    pk = peaks_of(*smooth_nms_topk_raw(heat8_of(net).contiguous(), 4, 4, 32,
                                       0.05), b, up_w)
    params = DecodeParams()
    for prefix_valid in (True, False):
        args = (pk, net[..., 19:], up_h, up_w, params, prefix_valid)
        got = score_candidates_raw(*args)
        k3_compare(got, score_candidates_raw_plain(*args), f"{grid} B={b}")
    assert bool(got.ok.any())


# ---- the serving side and the bf16 backbone on the card


@pytest.fixture(scope="module")
def thin368(nets):
    return TfPoseEstimator("mobilenet_thin", target_size=(432, 368),
                           params_path=CHECKPOINT)


def test_decode_is_deterministic_on_the_card(thin368):
    """The same maps decoded three times give the same arrays bit for
    bit. Before the assembly's score sums went through ``segment_sum``,
    the atomic fp32 ``scatter_add`` gave human scores that differed in
    the last bit between runs (2 of 12 frames of 640x480)."""
    from tfpose_tpu_torch.ops.decode import decode_batch

    frames = render_frames(np.random.default_rng(12), 16, 368, 432)
    maps = thin368._forward(np.stack(frames), 368, 432)
    runs = [decode_batch(maps, 184, 216, thin368.decode_params)
            for _ in range(3)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
    assert bool(runs[0].human_valid.any())


def test_video_pipeline_streams_equal_the_serial_loop(thin368):
    """Depth 3 on 64 rendered 640x480 frames: the forwards on their own
    stream, the decodes on the current one; the humans equal the serial
    loop's bit for bit."""
    from tfpose_tpu_torch.pipeline.video import VideoPipeline

    frames = render_frames(np.random.default_rng(64), 64, 480, 640)
    got = [h for _, h in VideoPipeline(thin368, 4.0, 3).run(frames)]
    want = video_serial(thin368, frames)
    assert [humans_key(h) for h in got] == [humans_key(h) for h in want]
    assert sum(len(h) for h in got) > 64


def test_service_with_concurrent_clients_at_max_batch_8(thin368):
    """Four client threads, eight requests each, at ``max_batch=8``:
    every reply equals ``humans_to_msg`` of the serial estimator's
    ``inference_batch`` humans for its frame (x, y 1e-6, confidence
    1e-4)."""
    from tfpose_tpu_torch.serving import (
        PoseClient, PoseService, humans_to_msg)

    imgs = render_frames(np.random.default_rng(4), 8, 368, 432)
    want = [humans_to_msg(h, 432, 368)
            for h in thin368.inference_batch(imgs, upsample_size=4.0)]
    svc = PoseService(thin368, port=0, upsample_size=4.0, max_batch=8,
                      max_wait_ms=20.0)
    addr = svc.start()
    replies, errors = {}, []

    def client(t):
        try:
            c = PoseClient(*addr)
            for i in range(8):
                k = (t * 3 + i) % 8
                replies[(t, i)] = (k, c.infer_raw(imgs[k]))
            c.close()
        except Exception as exc:  # reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        assert not errors and len(replies) == 32
        sizes = svc._batcher.batch_sizes
        assert sum(k * v for k, v in sizes.items()) == 32
    finally:
        svc.stop()
    for (t, i), (k, msg) in replies.items():
        same_persons(msg, want[k], f"client {t} request {i}")


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_bf16_backbone_on_the_card_against_the_cpu(nets, name):
    """Seeded random weights at 96x128 (CMU at 64x96), bf16 on the card
    (cuDNN) against the port's bf16 forward on the CPU: within 3e-2 of
    the largest fp32 map value. Each is within about 1e-2 of JAX's bf16
    (tests/test_torch_bf16.py), bf16 noise of other summation orders."""
    h, w = (64, 96) if name == "cmu" else (96, 128)
    net = init_weights(get_network(name, torch.bfloat16),
                       torch.Generator().manual_seed(3)).eval()
    net32 = get_network(name).eval()
    net32.load_state_dict(net.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (2, h, w, 3)).astype(np.float32))
    with torch.no_grad():
        cpu = net(x)["concat_stage7"].float()
        ref32 = net32(x)["concat_stage7"]
        card = net.cuda()(x.cuda())["concat_stage7"]
    assert card.dtype == torch.bfloat16
    scale = ref32.abs().max().item()
    assert scale > 0
    assert (card.float().cpu() - cpu).abs().max().item() <= 3e-2 * scale


def _int64_dense(xq, wq):
    o, _, kh, kw = wq.shape
    cols = torch.nn.functional.unfold(xq.double(), (kh, kw)).long()
    out = torch.einsum("ok,nkl->nol", wq.reshape(o, -1).long(), cols)
    n, _, h, w = xq.shape
    return out.reshape(n, o, h - kh + 1, w - kw + 1)


def test_int8_accumulators_on_the_card_equal_int64(nets):
    """The int8 convs' accumulators on the card (``torch._int_mm`` for a
    dense conv, int32 tap sums for a depthwise one) equal an int64
    reference: CMU's 7x7x185 conv (K = 9065) saturated at +-127 of one
    sign (146,209,385, past fp32's exact integers), random values, and
    a saturated depthwise 3x3."""
    from tfpose_tpu_torch.models.layers import int_conv2d

    rng = np.random.default_rng(9)
    w = torch.full((128, 185, 7, 7), 127, dtype=torch.int8)
    for x in (torch.full((2, 185, 52, 88), 127, dtype=torch.int8),
              torch.from_numpy(rng.integers(-127, 128, (2, 185, 52, 88),
                                            dtype=np.int8))):
        got = int_conv2d(x.cuda(), w.cuda(), (1, 1))
        assert torch.equal(got.cpu().long(), _int64_dense(x, w))
    wr = torch.from_numpy(rng.integers(-127, 128, (40, 185, 7, 7),
                                       dtype=np.int8))
    assert torch.equal(int_conv2d(x.cuda(), wr.cuda(), (1, 1)).cpu().long(),
                       _int64_dense(x, wr))
    xd = torch.full((4, 96, 30, 40), -127, dtype=torch.int8)
    wd = torch.full((96, 1, 3, 3), 127, dtype=torch.int8)
    got = int_conv2d(xd.cuda(), wd.cuda(), (2, 2), groups=96).cpu()
    assert int(got.min()) == -9 * 127 * 127
    assert torch.equal(got, int_conv2d(xd, wd, (2, 2), groups=96))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_int8_forward_on_the_card_equals_the_cpu(nets, name):
    """Seeded random weights (BN statistics away from identity) at
    96x128 (CMU at 64x96), calibrated on the card: the calibration
    within rtol 1e-5 of the CPU's, and with the card's calibration in
    both, the int8 ``concat_stage7`` of the card equal to the CPU's bit
    for bit: integer accumulators, and every float op (quantise,
    rescale, BatchNorm one op at a time) rounded alike."""
    from tfpose_tpu_torch.convert.checkpoint import (
        variables_from_numpy, variables_to_numpy)
    from tfpose_tpu_torch.models.quantize import (
        calibrate, default_calibration_images)
    from tfpose_tpu_torch.models.layers import set_quant_mode

    h, w = (64, 96) if name == "cmu" else (96, 128)
    gen = torch.Generator().manual_seed(5)
    net = init_weights(get_network(name), gen).eval()
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    cpu = get_network(name).eval()
    cpu.load_state_dict(net.state_dict())
    imgs = default_calibration_images((w, h), n=2)
    card = net.cuda()
    q_card = calibrate(card, imgs)
    q_cpu = calibrate(cpu, imgs)

    def leaves(t):
        return [v for x in t.values() for v in (
            leaves(x) if isinstance(x, dict) else [x])]

    np.testing.assert_allclose(leaves(q_card), leaves(q_cpu), rtol=1e-5)
    variables_from_numpy(cpu, dict(variables_to_numpy(card)))
    set_quant_mode(card, "int8")
    set_quant_mode(cpu, "int8")
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (2, h, w, 3)).astype(np.float32))
    with torch.no_grad():
        want = cpu(x)["concat_stage7"]
        got = card(x.cuda())["concat_stage7"].cpu()
    assert torch.equal(got, want), (got - want).abs().max().item()


def test_train_step_on_the_card_matches_the_cpu(nets):
    """One fp32 step of thin at 32x32, B = 4, from the same seeded
    weights and batch, TF32 off: the loss within rtol 1e-5, every
    gradient within 0.15 of the largest one (the bound against JAX on
    the CPU, ``tests/test_torch_train.py``; cuDNN's weight gradients sum
    with atomics), the BN running statistics within 1e-5."""
    from tfpose_tpu_torch.cli.train import synthetic_batches
    from tfpose_tpu_torch.train.state import batch_loss

    batch = next(synthetic_batches(4, (32, 32), np.random.default_rng(0)))
    net = init_weights(get_network("mobilenet_thin"),
                       torch.Generator().manual_seed(0))
    cpu = get_network("mobilenet_thin")
    cpu.load_state_dict(net.state_dict())
    card = net.cuda()
    losses, grads = [], []
    for m in (cpu, card):
        loss, _ = batch_loss(m, batch)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    top = max(g.abs().max().item() for g in grads[0].values())
    assert max((grads[1][k] - g).abs().max().item()
               for k, g in grads[0].items()) <= 0.15 * top
    for (k, a), b in zip(cpu.named_buffers(), card.buffers()):
        if a.is_floating_point():
            assert (b.cpu() - a).abs().max().item() <= 1e-5, k


# ---- Datum and GraphDef records, and the profiling helpers, on the card

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fixtures")


def test_datum_records_train_on_the_card(nets, tmp_path):
    """The JAX writer's shard (no protobuf on the card): every record
    re-serializes byte for byte, the raw ones are written again byte
    for byte and feed ``--datum-shard`` for one step on the card."""
    from tfpose_tpu_torch.cli import train as train_cli
    from tfpose_tpu_torch.train import lmdb_dataset

    shard = os.path.join(_FIXTURES, "datum_jax.tpds")
    raw = open(shard, "rb").read()
    records = list(lmdb_dataset.DatumShardReader(shard))
    assert b"TPDS" + b"".join(
        len(d.SerializeToString()).to_bytes(4, "little")
        + d.SerializeToString() for d in records) == raw
    path = str(tmp_path / "raw.tpds")
    lmdb_dataset.write_datum_shard(path, [lmdb_dataset.unpack_datum(d)
                                          for d in records[:4]], False)
    assert raw.startswith(open(path, "rb").read())
    state = train_cli.main(["--datum-shard", path, "--no-augment",
                            "--input-size", "64x80", "--batchsize", "4",
                            "--max-steps", "1", "--log-every", "1"])
    assert state.step == 1 and next(state.net.parameters()).is_cuda


def test_graphdef_consts_to_the_card(nets):
    """TensorFlow's graph read by the port's codec, its consts moved to
    the card and back bit for bit."""
    from tfpose_tpu_torch.convert import graphdef

    consts = graphdef.extract_consts(graphdef.load_graphdef(
        os.path.join(_FIXTURES, "graphdef_tf.pb")))
    expected = np.load(os.path.join(_FIXTURES, "graphdef_tf.npz"))
    for i, name in enumerate(str(n) for n in expected["names"]):
        back = torch.from_numpy(consts[name]).cuda().cpu().numpy()
        assert back.tobytes() == expected[f"a{i}"].tobytes(), name


def test_profiling_on_the_card(thin368, tmp_path):
    """``trace`` lists K2's kernel and cuDNN's convs by name; the device
    timers give positive times; ``get_flops`` equals the CPU's."""
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.utils import profiling

    img = render_frames(np.random.default_rng(3), 1, 368, 432)[0]
    with profiling.trace(str(tmp_path)):
        thin368.inference(img, upsample_size=4.0)
    durs = profiling.device_event_durations_ms(str(tmp_path))
    assert any("smooth_nms_kernel" in k for k in durs)
    assert profiling.device_event_durations_ms(str(tmp_path), "zz") == {}
    x = torch.zeros(1, 368, 432, 3, device="cuda")
    p50 = profiling.device_p50_ms(lambda t: run_backbone(thin368.net, t),
                                  (x,), n_runs=5)
    am = profiling.amortized_ms(lambda t: t.sum(), torch.ones(
        8, 1024, device="cuda"))
    assert 0 < p50 < 1e3 and am > 0
    cpu = TfPoseEstimator("mobilenet_thin", target_size=(96, 80),
                          device="cpu")
    card = TfPoseEstimator("mobilenet_thin", target_size=(96, 80))
    assert card.get_flops() == cpu.get_flops() > 0


# ---- the mesh on the card (parallel/): ranks started by launch; their
# bodies are top-level functions, since a spawned rank imports this file

def _halo_rank_on_the_card():
    """A 3x3 and a 7x7 conv (stride 1) and a 3x3 stride-2 depthwise conv
    on this rank's rows of 46 (over gloo, CUDA tensors), forward and
    gradient, against its rows of the unsharded conv on the card: the
    largest differences relative to the largest values."""
    from tfpose_tpu_torch.models.layers import SameConv2d
    from tfpose_tpu_torch.parallel.halo import row_bounds
    from tfpose_tpu_torch.parallel.mesh import make_mesh, shard_batch, sharded

    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, 2, ["cuda:0"] * 2)
    s = mesh.spatial_index
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 46, 54), generator=g).cuda()
    out = {}
    for name, conv in (("3x3", SameConv2d(6, 5, 3)),
                       ("7x7", SameConv2d(6, 4, 7)),
                       ("dw3x3_s2", SameConv2d(6, 6, 3, 2, groups=6))):
        with torch.no_grad():
            for t in conv.parameters():
                t.copy_(torch.randn(t.shape, generator=g))
        conv.cuda()
        xl = shard_batch(mesh, x, spatial_axis=2).clone().requires_grad_()
        with sharded(mesh, image_hw=(46, 54)):
            y = conv(xl)
        gl = torch.autograd.grad((y * y).sum(), xl)[0]
        xf = x.clone().requires_grad_()
        yf = conv(xf)
        gf = torch.autograd.grad((yf * yf).sum(), xf)[0]
        ob, ib = row_bounds(yf.shape[2], 2), row_bounds(46, 2)
        out[name] = (
            ((y - yf[:, :, ob[s]:ob[s + 1]]).abs().max()
             / yf.abs().max()).item(),
            ((gl - gf[:, :, ib[s]:ib[s + 1]]).abs().max()
             / gf.abs().max()).item())
    return out


def _nccl_rank():
    import torch.distributed as dist

    from tfpose_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    t = torch.arange(5, dtype=torch.float32, device=mesh.device)
    dist.all_reduce(t, group=mesh.world)
    return dist.get_backend(), mesh.shape, str(mesh.device), t.cpu().numpy()


def test_halo_exchange_on_the_card_over_gloo(nets):
    """Two gloo ranks sharing the card, CUDA tensors: forward and
    gradient within 1e-5 of the largest value (cuDNN sums a block's
    windows in another order than the whole map's)."""
    from tfpose_tpu_torch.parallel.mesh import launch

    for out in launch(_halo_rank_on_the_card, 2, ["cuda:0"] * 2, "gloo",
                      timeout=120):
        for name, (fwd, grad) in out.items():
            assert fwd <= 1e-5 and grad <= 1e-5, (name, fwd, grad)


def test_nccl_all_reduce_with_one_rank(nets):
    """NCCL initialises with one rank on the card, ``make_mesh()`` takes
    the visible card, and an ``all_reduce`` runs on its stream."""
    from tfpose_tpu_torch.parallel.mesh import launch

    (backend, shape, device, t), = launch(_nccl_rank, 1, ["cuda:0"], "nccl",
                                          timeout=120)
    assert backend == "nccl" and device == "cuda:0"
    assert shape == {"data": 1, "spatial": 1}
    np.testing.assert_array_equal(t, np.arange(5, dtype=np.float32))
