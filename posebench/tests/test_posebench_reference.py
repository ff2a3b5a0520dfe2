"""The reference (plain PyTorch forwards, the frozen decoder and msgpack
reader) against the program, at small sizes on the CPU; on a card, the
reference against the program at the cells' sizes."""

import numpy as np
import pytest
import torch

from posebench.lib import weights
from posebench.reference import decode as ref_decode
from posebench.reference import models as ref_models
from posebench.reference import msgpack
from tfpose_tpu_torch.convert.checkpoint import (
    load_flax_msgpack,
    variables_from_numpy,
)
from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.estimator import run_backbone
from tfpose_tpu_torch.evaluation.parity_sweep import _oracle_humans, compare
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.ops.decode import decode_batch
from tfpose_tpu_torch.utils import synthetic

THIN = "models/trained/thin368_coco/params.msgpack"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_msgpack_reader_equals_the_programs(repo_path):
    ours = dict(_leaves(msgpack.load_flax_msgpack(repo_path(THIN))))
    theirs = dict(_leaves(load_flax_msgpack(repo_path(THIN))))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        assert np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("hw", [(64, 80), (33, 47), (368, 432)])
def test_thin_forward_matches_the_program(repo_path, hw):
    tree = load_flax_msgpack(repo_path(THIN))
    net = get_network("mobilenet_thin")
    variables_from_numpy(net, tree)
    net.eval()
    x = torch.rand((1, *hw, 3), generator=torch.Generator().manual_seed(3))
    ref = ref_models.forward("mobilenet_thin",
                             ref_models.tree_to(tree, "cpu"), x - 0.5)
    prog = run_backbone(net, x - 0.5)
    assert ref.shape == prog.shape
    assert float((ref - prog).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("model", ["cmu", "mobilenet_thin"])
def test_seeded_weights_reach_both_sides_alike(model):
    tree = weights.seeded_tree(model, 2 ** 31 + 17, "cpu")
    net = get_network(model)
    weights.load_into(net, tree)
    net.eval()
    x = torch.rand((2, 40, 56, 3), generator=torch.Generator().manual_seed(1))
    ref = ref_models.forward(model, tree, x - 0.5)
    prog = run_backbone(net, x - 0.5)
    assert float((ref - prog).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_seeded_tree_depends_on_the_seed_only():
    a = weights.seeded_tree("cmu", 5, "cpu")["params"]["conv1_1"]["conv"]
    b = weights.seeded_tree("cmu", 5, "cpu")["params"]["conv1_1"]["conv"]
    c = weights.seeded_tree("cmu", 6, "cpu")["params"]["conv1_1"]["conv"]
    assert torch.equal(a["kernel"], b["kernel"])
    assert not torch.equal(a["kernel"], c["kernel"])


@pytest.mark.parametrize("seed", range(6))
def test_reference_decode_equals_the_programs_oracle_and_decode(seed):
    rng = np.random.default_rng(seed)
    net, _ = synthetic.render_scene(rng, 1 + seed % 4, 46, 54)
    ours = ref_decode.decode(torch.from_numpy(net), 184, 216)
    assert compare(_oracle_humans(net, DecodeParams()), ours,
                   tol_score=1e-12) is None
    out = decode_batch(torch.from_numpy(net)[None], 184, 216, DecodeParams())
    coords, scores, pvalid, hscores, hvalid = (
        t[0].numpy() for t in (out.coords, out.part_scores, out.part_valid,
                               out.human_scores, out.human_valid))
    prog = [({p: (int(round(coords[h, p, 0] * 216)),
                  int(round(coords[h, p, 1] * 184)), float(scores[h, p]))
              for p in range(18) if pvalid[h, p]}, float(hscores[h]))
            for h in range(len(hvalid)) if hvalid[h]]
    assert ours and compare(ours, prog, tol_score=1e-5) is None


@pytest.mark.cuda
@pytest.mark.parametrize("model,hw,dtype", [
    ("mobilenet_thin", (368, 432), torch.float32),
    ("cmu", (368, 656), torch.bfloat16)])
def test_reference_against_the_program_on_the_card(card, model, hw, dtype):
    tree = weights.seeded_tree(model, 2 ** 31 + 5, card)
    net = get_network(model, dtype)
    weights.load_into(net, tree)
    net.eval().to(card)
    x = torch.rand((4, *hw, 3), device=card,
                   generator=torch.Generator(card).manual_seed(2)) - 0.5
    ref = ref_models.forward(model, tree, x)
    gap = float((run_backbone(net, x) - ref).abs().max() / ref.abs().max())
    assert gap <= (1e-4 if dtype == torch.float32 else 0.1)
