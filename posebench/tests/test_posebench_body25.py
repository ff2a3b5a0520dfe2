"""OpenPose BODY_25, added as files: its seeded tree and FLOPs pinned,
its skeleton against OpenPose's tables, K6's work, and its cell run on
the CPU at a small size with ``correct`` true."""

import json
import os

import numpy as np
import pytest

from conftest import small_copy
from posebench.lib import counts, runner, weights
from posebench.lib.cell import Cell
from posebench.lib.spec import metric_reader
from posebench.reference import decode as ref_decode
from test_posebench_pinned import SEED, tree_digest

TREE = "c59df0ecd00016f1cc14d1cc14eef20ebc3909b6d24a60ded1d9caa3aa53a4f7"
# openpose src/openpose/pose/poseParameters.cpp, BODY_25: the limbs'
# parts and each limb's (x, y) PAF channels counted after the 26 heat
# channels, as OpenPose lists them
POSE_BODY_25_PAIRS = [
    1, 8, 1, 2, 1, 5, 2, 3, 3, 4, 5, 6, 6, 7, 8, 9, 9, 10, 10, 11, 8, 12,
    12, 13, 13, 14, 1, 0, 0, 15, 15, 17, 0, 16, 16, 18, 2, 17, 5, 18,
    14, 19, 19, 20, 14, 21, 11, 22, 22, 23, 11, 24]
POSE_BODY_25_MAP_IDX = [
    0, 1, 14, 15, 22, 23, 16, 17, 18, 19, 24, 25, 26, 27, 6, 7, 2, 3, 4, 5,
    8, 9, 10, 11, 12, 13, 30, 31, 32, 33, 36, 37, 34, 35, 38, 39, 20, 21,
    28, 29, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51]


def test_seeded_tree_and_flops_pinned():
    """114 convs (99 with PReLU slopes), 26.17 M parameters; 287.26
    GFLOP an image at 656x368 (CMU: 484.63)."""
    tree = weights.seeded_tree("body25", SEED, "cpu")
    assert tree_digest(tree) == TREE
    leaves = [v for node in tree["params"].values() for sub in node.values()
              for v in sub.values()]
    assert sum(v.numel() for v in leaves) == 26_166_084
    assert sum(1 for node in tree["params"].values()
               if "prelu" in node) == 99
    assert counts.model_flops("body25", 368, 656) == 287_261_035_520


def test_skeleton_is_openposes():
    sk = ref_decode.skeleton("body25")
    assert (sk.parts, sk.heat_channels, sk.limbs) == (25, 26, 26)
    assert sk.pairs.ravel().tolist() == POSE_BODY_25_PAIRS
    assert sk.paf_channels.ravel().tolist() == POSE_BODY_25_MAP_IDX
    assert sorted(sk.redundant) == [18, 19]


def test_k6_work_pinned():
    """For each of the 99 PReLU convs, B x 46 x 82 x cout values read
    and written once in bf16, and its bias and slopes: 3.38 GB a B=16
    call, 1.01 ms at 3.35 TB/s. A network without PReLU has none."""
    k6 = metric_reader("k6_roofline_pct")
    assert k6.k6_work("body25", 368, 656, 16, "bfloat16") == (
        1_691_787_264, 3_383_686_656)
    assert k6.k6_work("cmu", 368, 656, 16, "bfloat16") == (0, 0)
    cell = Cell("body25-656-bf16-batch16", SEED, 1.0, True, device="cpu")
    ctx = {"cell": cell, "trace": {"calls": 2, "by_name": {
        "void (anonymous namespace)::bias_prelu_vec<unsigned short, 8>"
        "(unsigned short const*)": 3e-3, "bias_prelu_vec<float, 4>": 1e-3}},
        "outcome": {"local_batch": 16}}
    assert k6.read(ctx) == pytest.approx(
        100 * 2 * 3_383_686_656 / 3.35e12 / 4e-3, rel=1e-12)
    ctx["trace"]["by_name"] = {}
    assert k6.read(ctx) is None
    ctx["trace"] = None
    assert k6.read(ctx) is None


def test_cell_runs_correct_on_the_cpu(tmp_path):
    """The cell at 96x64, B=2, through the program's BODY_25 on the CPU
    (every kernel's plain version) with the seeded weights: ``correct``
    against the plain reference."""
    root = small_copy(tmp_path, {
        "configs/body25-bf16-656x368.json": {"input_wh": [96, 64]},
        "workloads/body25-656-bf16-batch16.json": {
            "batch": 2, "scenes": 4, "check_images": 4, "trace_calls": 1}})
    result, lines, _ = runner.run("body25-656-bf16-batch16", 2 ** 31 + 77,
                                  1.0, False, device="cpu", root=root)
    assert result["correct"], lines[-3:]
    checks = result["checks"]
    assert 0 < checks["maps_rms_ratio"]["value"] < 1.5
    assert checks["humans_gap"]["value"] == 0.0
    with open(os.path.join(root, "configs",
                           "body25-bf16-656x368.json")) as f:
        assert json.load(f)["model"] == "body25"
    assert np.isfinite(result["metrics"]["images_per_s"]["value"])
