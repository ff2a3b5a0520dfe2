"""A new pose architecture is added as files alone: in a copy of the
harness, an architecture file and a skeleton for a toy network with
what a second OpenPose network (BODY_25) brings: 5 parts and a
background, 4 limbs of which one is redundant, PAF channels out of limb
order, and PReLU slopes, a parameter leaf of its own. The seeded tree,
the loader, the forward, the reference decode, the work counts and the
cell find the toy by name, and no file of the copy is edited."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from conftest import small_copy
from posebench.lib import counts, weights
from posebench.lib.cell import Cell
from posebench.lib.spec import metric_reader
from posebench.metrics import _common
from posebench.reference import decode as ref_decode
from posebench.reference import models as ref_models

TOY_ARCH = '''"""A toy pose network: three 3x3 convs, each with a PReLU and a
2x2 max-pool, then 1x1 heads for the heat and the PAF."""

import torch
import torch.nn.functional as F

from posebench.reference.models import Conv, Leaf

SKELETON = "toy5"
LEAVES = {"prelu": Leaf("alpha", lambda c: (c.cout,), 0.25, "weight")}
STEM = [("stem1", 3, 8), ("stem2", 8, 8), ("stem3", 8, 8)]


def convs():
    return ([Conv((name, "conv"), 3, ci, co, bias=True, leaves=("prelu",))
             for name, ci, co in STEM]
            + [Conv(("heat", "conv"), 1, 8, 6, bias=True),
               Conv(("paf", "conv"), 1, 8, 8, bias=True)])


def body(net, x):
    for name, _, _ in STEM:
        x = net.conv(x, (name, "conv"), relu=False)
        alpha = net.node((name, "prelu"))["alpha"]
        x = net.max_pool(F.prelu(x, alpha.to(x.dtype)))
    return torch.cat([net.conv(x, ("heat", "conv"), relu=False),
                      net.conv(x, ("paf", "conv"), relu=False)], 1)
'''
# parts: 0 head, 1 neck, 2 right hand, 3 left hand, 4 hip; the hip is
# reached by the redundant limb alone, which comes second in limb order
# (BODY_25's come in the middle, COCO's last); limb i reads PAF_CH[i]
PAIRS = [[1, 0], [1, 4], [1, 2], [1, 3]]
PAF_CH = [[4, 5], [0, 1], [6, 7], [2, 3]]
REDUNDANT = 1
TOY_SKELETON = {"parts": 5, "heat_channels": 6, "pairs": PAIRS,
                "paf_channels": PAF_CH, "redundant": [REDUNDANT]}
STEM = [("stem1", 3, 8), ("stem2", 8, 8), ("stem3", 8, 8)]
# a human's parts about its neck, (x, y) at the decode size
OFFSETS = np.array([[0, -10], [0, 0], [-8, 10], [8, 10], [0, 20]])


def _digests(checkout):
    out = {}
    for dirpath, _, files in os.walk(checkout):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, checkout)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture
def toy(tmp_path):
    """The copy's ``posebench`` with the toy's files added; after the
    test, every file the copy had before is as it was."""
    root = small_copy(tmp_path)
    checkout = os.path.dirname(root)
    before = _digests(checkout)
    with open(os.path.join(root, "reference", "archs", "toy.py"), "w") as f:
        f.write(TOY_ARCH)
    with open(os.path.join(root, "reference", "skeletons", "toy5.json"),
              "w") as f:
        json.dump(TOY_SKELETON, f)
    cfg = json.loads(open(os.path.join(
        root, "configs", "cmu-bf16-656x368.json")).read())
    cfg.update(model="toy", input_wh=[96, 64], dtype="float32")
    with open(os.path.join(root, "configs", "toy-96x64.json"), "w") as f:
        json.dump(cfg, f)
    wl = json.loads(open(os.path.join(
        root, "workloads", "thin432-batch16.json")).read())
    wl.update(config="toy-96x64", batch=2)
    with open(os.path.join(root, "workloads", "toy-b2.json"), "w") as f:
        json.dump(wl, f)
    yield root
    after = _digests(checkout)
    assert {k: after.get(k) for k in before} == before


def _plain_toy():
    """The toy as a plain module, named as its tree is."""
    net = nn.ModuleDict({
        name: nn.ModuleDict({"conv": nn.Conv2d(ci, co, 3, padding=1),
                             "prelu": nn.PReLU(co)})
        for name, ci, co in STEM})
    net["heat"] = nn.ModuleDict({"conv": nn.Conv2d(8, 6, 1)})
    net["paf"] = nn.ModuleDict({"conv": nn.Conv2d(8, 8, 1)})
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(float("nan"))
    return net


def _plain_forward(net, x):
    h = x.permute(0, 3, 1, 2)
    for name, _, _ in STEM:
        h = F.max_pool2d(net[name]["prelu"](net[name]["conv"](h)), 2)
    return torch.cat([net["heat"]["conv"](h), net["paf"]["conv"](h)],
                     1).permute(0, 2, 3, 1)


def test_seeded_tree_fills_the_plain_module_and_the_forward_agrees(toy):
    tree = weights.seeded_tree("toy", 2 ** 31 + 3, "cpu", toy)
    alpha = tree["params"]["stem2"]["prelu"]["alpha"]
    assert alpha.shape == (8,) and bool((alpha == 0.25).all())
    # slopes of their own, so that the forward shows they reached both
    for i, (name, _, co) in enumerate(STEM):
        tree["params"][name]["prelu"]["alpha"] = torch.linspace(
            -0.5, 0.5 + i, co)
    net = _plain_toy()
    with pytest.raises(KeyError):
        weights.load_into(net, tree)     # without the architecture's leaves
    weights.load_into(net, tree, "toy", toy)
    state = net.state_dict()
    assert torch.equal(state["stem3.prelu.weight"],
                       tree["params"]["stem3"]["prelu"]["alpha"])
    assert torch.equal(state["paf.conv.weight"],
                       tree["params"]["paf"]["conv"]["kernel"].permute(
                           3, 2, 0, 1))
    x = torch.rand((2, 64, 96, 3),
                   generator=torch.Generator().manual_seed(1)) - 0.5
    ref = ref_models.forward("toy", tree, x, root=toy)
    assert ref.shape == (2, 8, 12, 6 + 8)
    with torch.no_grad():
        plain = _plain_forward(net, x)
    assert float((ref - plain).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_model_flops_of_the_toy(toy):
    macs = sum(64 * 96 // 4 ** i * 9 * ci * co
               for i, (_, ci, co) in enumerate(STEM))
    macs += 8 * 12 * 8 * (6 + 8)
    assert counts.model_flops("toy", 64, 96, toy) == 2 * macs


def _render(necks, h=48, w=64):
    """(h, w, 6 + 8) maps at the decode size: a Gaussian disc a part in
    its heat channel, and each limb's unit vector within 1.5 px of its
    segment in the limb's own PAF channels."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    maps = np.zeros((h, w, 14))
    for neck in necks:
        parts = neck + OFFSETS
        for p, (x, y) in enumerate(parts):
            maps[..., p] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0)
        for (a, b), (cx, cy) in zip(PAIRS, PAF_CH):
            d = (parts[b] - parts[a]).astype(np.float64)
            length = np.hypot(*d)
            u = d / length
            rx, ry = xx - parts[a][0], yy - parts[a][1]
            along = rx * u[0] + ry * u[1]
            across = np.abs(rx * u[1] - ry * u[0])
            on = (along >= -1) & (along <= length + 1) & (across <= 1.5)
            maps[on, 6 + cx], maps[on, 6 + cy] = u[0], u[1]
    return torch.from_numpy(maps)


def test_reference_decode_finds_the_planted_humans(toy):
    sk = ref_decode.skeleton("toy5", toy)
    assert (sk.parts, sk.heat_channels, sk.limbs) == (5, 6, 4)
    necks = [np.array([16, 16]), np.array([46, 16])]
    humans = ref_decode.decode(_render(necks), 48, 64, skeleton=sk)
    got = sorted(sorted((p, xy[:2]) for p, xy in parts.items())
                 for parts, _ in humans)
    want = sorted(sorted((p, tuple(int(v) for v in xy))
                         for p, xy in enumerate(n + OFFSETS))
                  for n in necks)
    assert got == want


def test_a_redundant_limb_joins_but_never_starts_a_human(toy):
    """``assemble``'s rows have the toy's layout: 5 part ids, the score
    sum, the part count; a lone connection starts a row on every limb
    but the redundant one."""
    sk = ref_decode.skeleton("toy5", toy)
    params = dataclasses.replace(ref_decode.PARAMS, thresh_part_cnt=2,
                                 thresh_human_score=0.0)
    conn = ref_decode.Connection(score=1.0, cid1=0, cid2=1,
                                 peak_score1=0.5, peak_score2=0.25)
    for limb in range(sk.limbs):
        by_limb = [[conn] if i == limb else [] for i in range(sk.limbs)]
        rows = ref_decode.assemble(by_limb, params, sk)
        if limb == REDUNDANT:
            assert rows == []
            continue
        (row,) = rows
        a, b = PAIRS[limb]
        want = np.full(7, -1.0)
        want[[a, b, 5, 6]] = 0, 1, 1.75, 2
        assert np.array_equal(row, want)


def test_the_cell_takes_the_skeleton_and_the_counts_follow_it(toy):
    cell = Cell("toy-b2", 7, 1.0, True, device="cpu", root=toy)
    assert cell.skeleton.name == "toy5" and cell.skeleton.parts == 5
    k = 32
    rng = np.random.default_rng(3)
    peaks = np.stack([rng.integers(0, cell.up_w, (5, k)),
                      rng.integers(0, cell.up_h, (5, k))], -1)
    valid = np.zeros((5, k), bool)
    by_name = {n: 1e-3 for n in ("phase_peaks_kernel", "select_kernel",
                                 "smooth_nms_kernel",
                                 "score_candidates_kernel")}
    ctx = {"cell": cell, "trace": {"calls": 1, "by_name": by_name},
           "outcome": {"local_batch": 2}, "traced_scenes": [[0]],
           "peaks": {0: (peaks, valid)}}
    h8, w8 = 64 // 8, 96 // 8

    def pct(work, seconds):
        return 100 * _common.fp32_bound(*work) / seconds

    assert metric_reader("k1_roofline_pct", toy).read(ctx) == pct(
        counts.k1_work(2 * 5, h8, w8), 2e-3)
    assert metric_reader("k2_roofline_pct", toy).read(ctx) == pct(
        counts.k2_work(cell.up_h, cell.up_w, 6), 1e-3)
    assert metric_reader("k3_roofline_pct", toy).read(ctx) is None
    # 4 limbs of K x K candidate slots, 5 parts of K peaks
    base = counts.k3_work(peaks, valid, h8, w8, cell.up_h, cell.up_w,
                          cell.skeleton.pairs)
    assert base == (16 * 4 * k * k, 5 * k * 9 + 4 * k * k * 5)
    # two necks and a hip: the redundant limb's 2 live candidates, each
    # sampling 10 raw PAF cells
    valid[1, :2] = valid[4, 0] = True
    ops, nbytes = counts.k3_work(peaks, valid, h8, w8, cell.up_h, cell.up_w,
                                 cell.skeleton.pairs)
    assert ops == base[0] + 2 * 131 and 8 <= nbytes - base[1] <= 20 * 8
    assert metric_reader("k3_roofline_pct", toy).read(ctx) == pct(
        (ops, nbytes), 1e-3)
