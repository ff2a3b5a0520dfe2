"""The assembly's kernel wrapper (``ops/assemble.py:assemble_dense``) on
the CPU: its input checks, the plain version it runs for CPU tensors, the
coordinate normalisation it folds in, and the redundant-pair walk case
that the card's tests hold K5 to."""

import numpy as np
import pytest
import torch

from torch_cases import assembly_inputs, walk_branches, walk_case
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.ops.assemble import (
    Assembled,
    assemble_dense,
    assemble_dense_plain,
)
from tfpose_tpu_torch.ops.nms import Peaks
from tfpose_tpu_torch.ops.paf import Connections
from tfpose_tpu_torch.utils import synthetic

PARAMS = DecodeParams(max_peaks=16, max_humans=16)


def _equal(got, want):
    for name in Assembled._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.fixture(scope="module")
def scene():
    """Peaks and connections of three rendered 46x54 scenes (0, 3 and 6
    people) as ``decode_batch`` hands them to the assembly."""
    rng = np.random.default_rng(3)
    nets = np.stack([synthetic.render_scene(rng, n, 46, 54)[0]
                     for n in (0, 3, 6)])
    return assembly_inputs(torch.from_numpy(nets), 184, 216, DecodeParams())


_FIELDS = [("peaks", i) for i in range(4)] + [("conns", i) for i in range(4)]


@pytest.mark.parametrize("which, i", _FIELDS)
def test_wrapper_rejects_a_wrong_dtype(which, i):
    pk, conns = walk_case()
    group = list(pk if which == "peaks" else conns)
    wrong = torch.float64 if group[i].dtype != torch.float64 else torch.int32
    group[i] = group[i].to(wrong)
    args = ((Peaks(*group), conns) if which == "peaks"
            else (pk, Connections(*group)))
    with pytest.raises(ValueError, match="want"):
        assemble_dense(*args, PARAMS)


@pytest.mark.parametrize("case", ["parts", "pairs", "batch", "k"])
def test_wrapper_rejects_a_wrong_shape(case):
    pk, conns = walk_case()
    if case == "parts":
        pk = Peaks(*(t[:, :17] for t in pk))
    elif case == "pairs":
        conns = Connections(*(t[:, :18] for t in conns))
    elif case == "batch":
        conns = Connections(*(t[:1] for t in conns))
    else:
        conns = Connections(*(t[..., :8] for t in conns))
    with pytest.raises(ValueError):
        assemble_dense(pk, conns, PARAMS)


@pytest.mark.parametrize("case", ["one field", "all"])
def test_wrapper_rejects_a_wrong_device(case):
    pk, conns = walk_case()
    if case == "one field":
        conns = conns._replace(score=conns.score.to("meta"))
    else:
        pk = Peaks(*(t.to("meta") for t in pk))
        conns = Connections(*(t.to("meta") for t in conns))
    with pytest.raises(ValueError, match="meta"):
        assemble_dense(pk, conns, PARAMS)


@pytest.mark.parametrize("k", [0, 129])
def test_wrapper_rejects_k_outside_1_to_128(k):
    pk = Peaks(torch.zeros(1, 18, k, dtype=torch.int32),
               torch.zeros(1, 18, k, dtype=torch.int32),
               torch.zeros(1, 18, k), torch.zeros(1, 18, k, dtype=torch.bool))
    conns = Connections(torch.full((1, 19, k), -1, dtype=torch.int32),
                        torch.full((1, 19, k), -1, dtype=torch.int32),
                        torch.zeros(1, 19, k),
                        torch.zeros(1, 19, k, dtype=torch.bool))
    with pytest.raises(ValueError, match="1..128"):
        assemble_dense(pk, conns, PARAMS)


def test_k_of_128_is_taken(scene):
    """The escalated decode's K: 128 peaks a part pass the checks."""
    pk, conns = scene
    pad = [(0, 128 - pk.x.shape[2])]
    pk = Peaks(*(torch.nn.functional.pad(t, *pad) for t in pk))
    conns = Connections(
        *(torch.nn.functional.pad(t, *pad, value=-1 if t.dtype ==
                                  torch.int32 else 0) for t in conns))
    out = assemble_dense(pk, conns, DecodeParams().escalated())
    assert out.coords.shape == (3, 64, 18, 2)
    assert int(out.human_valid.sum()) > 0


@pytest.mark.parametrize("batched", [True, False])
def test_cpu_tensors_take_the_plain_version(scene, batched):
    """CPU tensors run the plain version, bit for bit, and launch
    nothing."""
    pk, conns = scene
    want = assemble_dense_plain(pk, conns, DecodeParams())
    assemble_dense.launches = 0
    if batched:
        got = assemble_dense(pk, conns, DecodeParams())
    else:
        got = Assembled(*(torch.stack(t) for t in zip(*(
            assemble_dense(Peaks(*(t[i] for t in pk)),
                           Connections(*(t[i] for t in conns)),
                           DecodeParams()) for i in range(3)))))
    _equal(got, want)
    assert assemble_dense.launches == 0
    assert int(got.human_valid.sum()) > 0


@pytest.mark.parametrize("size", [(216, 184), (640, 360), (82 * 4, 46 * 4)])
def test_folded_normalisation_equals_the_separate_one(scene, size):
    """``size`` gives the coordinates the decode's former separate
    normalisation: the fp32 reciprocals from NumPy, multiplied where the
    coordinate is >= 0; every other field unchanged."""
    pk, conns = scene
    raw = assemble_dense(pk, conns, DecodeParams())
    got = assemble_dense(pk, conns, DecodeParams(), size)
    w, h = size
    scale = torch.tensor(np.asarray([1.0 / w, 1.0 / h], np.float32))
    want = raw._replace(coords=torch.where(raw.coords >= 0,
                                           raw.coords * scale, raw.coords))
    _equal(got, want)
    assert bool((got.coords == -1).any()) and bool((got.coords > 0).any())
    assert float(got.coords.max()) <= 1.0


def test_walk_case_takes_every_branch():
    """The constructed case on which the card's tests hold K5: in each
    image the redundant-pair walk extends, fuses and attaches once (the
    left and right ear pairs), and four humans pass the thresholds."""
    pk, conns = walk_case()
    out = assemble_dense(pk, conns, PARAMS)
    for img in (0, 1):
        assert walk_branches(out, img) == {"extend", "fuse", "attach"}
    assert out.human_valid.sum(1).tolist() == [4, 4]
    # without the redundant pairs no branch shows
    cut = Connections(*(t.clone() for t in conns))
    cut.valid[:, 17:] = False
    out = assemble_dense(pk, cut, PARAMS)
    assert walk_branches(out, 0) == walk_branches(out, 1) == set()
