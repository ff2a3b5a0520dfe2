"""The yardstick pinned: the seeded weight trees, the reference's maps,
the model FLOPs and the kernel bounds of the benchmark's two networks,
as the harness gave them before each network's reference moved into an
architecture file of its own (``reference/archs/``). Trees and maps are
compared by SHA-256 digest, bit for bit: the maps on the CPU with one
thread (``conftest.py``), in fp32 and, for CMU, in bf16 as well (the
precision ``maps_rms_ratio`` divides by)."""

import hashlib

import numpy as np
import pytest
import torch

from posebench.lib import counts, weights
from posebench.lib.cell import Cell
from posebench.lib.spec import metric_reader
from posebench.reference import models as ref_models

SEED = 2 ** 31 + 29

TREES = {
    "mobilenet_thin":
        "8b0a01e2b3389b0b98ecf27358f1ae3475f17bf54127ba193558fcca80a2a12c",
    "cmu":
        "7640c09969d75dfad94bbb3084df4b37dcb2f69f706f539937e421b02822970a",
}
MAPS = {
    ("mobilenet_thin", "float32"):
        "98f2d0b4a3819529c570dd60fe19dd0559347e69eb50af3fa685df98d668546a",
    ("cmu", "float32"):
        "9c359fd7d4e762ceba1032a4ad455fa5828948baf9f003a838d7712846e92dc1",
    ("cmu", "bfloat16"):
        "f58e62ae2f21447b9b8df7517108c71256a7095c6884740dd6cb3cafb73f810f",
}
FLOPS = {("mobilenet_thin", 368, 432): 10826474256,
         ("cmu", 368, 656): 484634285056}
# each roofline reader on one traced call of the cell, every kernel at
# 1 ms of device time, K3 on peaks drawn from a fixed seed
ROOFLINES = {
    "thin432-single": {'k1_roofline_pct': 0.01382142089552239,
                       'k2_roofline_pct': 0.1803309850746269,
                       'k3_roofline_pct': 0.003545313432835821},
    "thin432-batch16": {'k1_roofline_pct': 0.22114273432835824,
                        'k2_roofline_pct': 0.1803309850746269,
                        'k3_roofline_pct': 0.003545313432835821},
    "cmu656-bf16-batch16": {'k1_roofline_pct': 0.3340868776119403,
                            'k2_roofline_pct': 0.27383594029850744,
                            'k3_roofline_pct': 0.0035629850746268657},
}


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def tree_digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        a = leaf.detach().cpu().contiguous().numpy()
        h.update(f"{'/'.join(path)} {a.dtype} {a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def maps_digest(model: str, dtype: str) -> str:
    tree = weights.seeded_tree(model, SEED, "cpu")
    x = torch.rand((2, 64, 96, 3),
                   generator=torch.Generator().manual_seed(4)) - 0.5
    maps = ref_models.forward(model, tree, x, dtype=getattr(torch, dtype))
    a = maps.contiguous().numpy()
    return hashlib.sha256(f"{a.dtype} {a.shape}\n".encode()
                          + a.tobytes()).hexdigest()


def rooflines(workload: str):
    cell = Cell(workload, SEED, 1.0, True, device="cpu")
    rng = np.random.default_rng(5)
    k = 32
    peaks = np.stack([rng.integers(0, cell.up_w, (18, k)),
                      rng.integers(0, cell.up_h, (18, k))], -1)
    valid = rng.uniform(size=(18, k)) < 0.1
    by_name = {n: 1e-3 for n in ("phase_peaks_kernel", "select_kernel",
                                 "smooth_nms_kernel",
                                 "score_candidates_kernel")}
    ctx = {"cell": cell, "trace": {"calls": 1, "by_name": by_name},
           "outcome": {"local_batch": cell.batch},
           "traced_scenes": [[0]], "peaks": {0: (peaks, valid)}}
    return {name: metric_reader(name).read(ctx)
            for name in ("k1_roofline_pct", "k2_roofline_pct",
                         "k3_roofline_pct")}


@pytest.mark.parametrize("model", sorted(TREES))
def test_seeded_tree_pinned(model):
    assert tree_digest(weights.seeded_tree(model, SEED, "cpu")) == \
        TREES[model]


@pytest.mark.parametrize("model,dtype", sorted(MAPS))
def test_reference_maps_pinned(model, dtype):
    assert maps_digest(model, dtype) == MAPS[(model, dtype)]


@pytest.mark.parametrize("key", sorted(FLOPS))
def test_model_flops_pinned_exactly(key):
    assert counts.model_flops(*key) == FLOPS[key]


@pytest.mark.parametrize("workload", sorted(ROOFLINES))
def test_roofline_readers_pinned(workload):
    assert rooflines(workload) == ROOFLINES[workload]
