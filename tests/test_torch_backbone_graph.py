"""The rules of the backbone's CUDA graphs (``models/graphs.py``) behind
``estimator.run_backbone``, on the CPU.

The CPU cannot capture a graph, so :class:`FakeGraph` stands in for
``graphs.Graph``: its capture runs the forward once on a static copy of
the input, and a replay copies the input in and runs the forward again
with the launch counters held, as a replay launches the captured kernels
without the wrappers' Python. ``graphs.on_card`` is made to accept CPU
tensors, except where a case tests it. The card's own tests of the
replays (bit for bit, the clone, streams) are in ``test_torch_cuda.py``
and ``test_torch_cuda_body25.py``.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tfpose_tpu_torch.convert.checkpoint import (
    variables_from_numpy,
    variables_to_numpy,
)
from tfpose_tpu_torch.estimator import forward_eager, run_backbone
from tfpose_tpu_torch.models import get_network, graphs
from tfpose_tpu_torch.models.layers import (
    SameConv2d,
    batch_norm,
    init_weights,
    nhwc,
    set_compute_dtype,
    set_quant_mode,
)
from tfpose_tpu_torch.ops import resize
from tfpose_tpu_torch.parallel import halo


def tick():
    """A stand-in kernel wrapper: the toy network 'launches' it once a
    forward."""


tick.launches = 0


class Toy(nn.Module):
    """1x1 convs (so that row sharding needs no neighbours) with
    BatchNorm, in the networks' interface."""

    def __init__(self):
        super().__init__()
        self.conv = SameConv2d(3, 8, 1, bias=False)
        self.bn = batch_norm(8)
        self.head = SameConv2d(8, 5, 1, bias=True)
        set_compute_dtype(self, torch.float32)
        set_quant_mode(self, "none")
        init_weights(self, torch.Generator().manual_seed(0))
        with torch.no_grad():
            self.bn.running_mean.uniform_(-0.5, 0.5)
            self.bn.running_var.uniform_(0.5, 2.0)

    def forward(self, x):
        tick.launches += 1
        h = F.relu(self.bn(self.conv(x.to(self.dtype).permute(0, 3, 1, 2))))
        return {"concat_stage7": nhwc(self.head(h)), "features": h}


class FakeGraph:
    captures = 0

    def __init__(self, net, x):
        self.net, self.x = net, x.clone()
        self.out = net.forward(self.x)[graphs.OUTPUT]
        FakeGraph.captures += 1

    def replay(self, x):
        self.x.copy_(x)
        counters = graphs.launch_counters()
        held = [c.launches for c in counters]
        self.out = self.net.forward(self.x)[graphs.OUTPUT]
        for c, n in zip(counters, held):
            c.launches = n
        return {graphs.OUTPUT: self.out.clone()}


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", FakeGraph)
    monkeypatch.setattr(graphs, "on_card", lambda x: True)
    monkeypatch.setattr(graphs, "launch_counters", lambda: (tick,))
    FakeGraph.captures = 0


def _x(seed=0, shape=(2, 12, 10, 3)):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) - 0.5


def _kinds(net, xs):
    """run_backbone over ``xs``: the kind of each call and its maps."""
    kinds, outs = [], []
    for x in xs:
        before = (run_backbone.eager, run_backbone.captures,
                  run_backbone.replays)
        outs.append(run_backbone(net, x))
        after = (run_backbone.eager, run_backbone.captures,
                 run_backbone.replays)
        kinds.append(("eager", "captures", "replays")[
            [a - b for a, b in zip(after, before)].index(1)])
    return kinds, outs


def _column_major(x):
    """``x``'s values laid out W-major, as a resized frame comes."""
    return x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)


def _with_gaps(x):
    """``x``'s values at every other element of a larger buffer."""
    wide = torch.zeros(x.shape[:-1] + (2 * x.shape[-1],))
    wide[..., ::2] = x
    return wide[..., ::2]


@pytest.mark.parametrize("layout, kinds", [
    (lambda x: x, ["eager", "captures", "replays", "replays"]),
    (_column_major, ["eager", "captures", "replays", "replays"]),
    (_with_gaps, ["eager"] * 4),
], ids=["contiguous", "column-major", "with gaps"])
def test_first_call_eager_second_captures_then_replays(fake_card, layout,
                                                       kinds):
    """Eager, capture, replay, replay at one key, for an input whose
    values fill its memory in any order (one with gaps stays eager):
    each result equals the eager forward's bit for bit and is a tensor
    of its own."""
    net = Toy().eval()
    xs = [layout(_x(i)) for i in range(4)]
    got, outs = _kinds(net, xs)
    assert got == kinds
    assert graphs.count(net) == FakeGraph.captures == kinds.count("captures")
    for x, out in zip(xs, outs):
        assert torch.equal(out, forward_eager(net, x))
    assert len({o.data_ptr() for o in outs}) == 4


def test_a_key_seen_in_another_thread_runs_eager_first(fake_card):
    """A call at a key that only another thread has run is that thread's
    warm-up (cuDNN's handles are per thread): eager, then the capture;
    the graph then replays in any thread."""
    net = Toy().eval()
    first, _ = _kinds(net, [_x(0)])
    got = []
    worker = threading.Thread(
        target=lambda: got.extend(_kinds(net, [_x(1), _x(2)])[0]))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    then, _ = _kinds(net, [_x(3)])
    assert first + got + then == ["eager", "eager", "captures", "replays"]


def _row_sharded():
    shard = halo.RowShard(None, 0, 1, 12, 10)
    return halo.use(halo.Sharding(rows=shard))


@pytest.mark.parametrize("case", ["cpu tensor", "training", "calib", "int8",
                                  "row sharding", "submodule hook",
                                  "pre-hook"])
def test_paths_that_never_capture(fake_card, monkeypatch, case):
    """Each of these runs eager at every call and holds no graph."""
    net = Toy().eval()
    ctx = torch.no_grad()
    if case == "cpu tensor":
        monkeypatch.setattr(graphs, "on_card", lambda x: x.is_cuda)
    elif case == "training":
        net.train()
    elif case in ("calib", "int8"):
        set_quant_mode(net, case)
        net.conv.in_absmax.fill_(0.5)
        net.head.in_absmax.fill_(2.0)
    elif case == "row sharding":
        ctx = _row_sharded()
    elif case == "submodule hook":
        net.bn.register_forward_hook(lambda m, a, o: None)
    else:
        net.register_forward_pre_hook(lambda m, a: None)
    with ctx:
        kinds, _ = _kinds(net, [_x(i) for i in range(3)])
    assert kinds == ["eager"] * 3
    assert graphs.count(net) == 0 and FakeGraph.captures == 0


@pytest.mark.parametrize("where", ["submodule", "network"])
def test_a_hook_registered_after_the_capture_lets_the_graphs_go(fake_card,
                                                                where):
    """A hook on a submodule, or before the network's forward, that
    comes after the capture runs on every later call: those calls are
    eager and the network holds no graph. A hook registered elsewhere
    keeps the replays."""
    net, other = Toy().eval(), Toy().eval()
    _kinds(net, [_x(0), _x(1)])
    other.bn.register_forward_hook(lambda m, a, o: None)
    assert _kinds(net, [_x(2)])[0] == ["replays"]
    calls = []
    if where == "submodule":
        net.bn.register_forward_hook(lambda m, a, o: calls.append(m))
    else:
        net.register_forward_pre_hook(lambda m, a: calls.append(m))
    kinds, outs = _kinds(net, [_x(i) for i in range(3, 6)])
    assert kinds == ["eager"] * 3 and len(calls) == 3
    assert graphs.count(net) == 0
    for i, o in zip(range(3, 6), outs):
        assert torch.equal(o, forward_eager(net, _x(i)))


def test_at_most_four_graphs_and_nothing_evicted(fake_card):
    """Six shapes, each called twice, then the first again: the first
    four capture, the last two stay eager, the first still replays."""
    net = Toy().eval()
    shapes = [(1, 8 + 2 * i, 10, 3) for i in range(6)]
    kinds, _ = _kinds(net, [_x(k, s) for s in shapes for k in (0, 1)])
    assert kinds == ["eager", "captures"] * 4 + ["eager", "eager"] * 2
    assert graphs.count(net) == graphs.MAX_GRAPHS == 4
    assert _kinds(net, [_x(2, shapes[0])])[0] == ["replays"]


def _replace_weight(net):
    net.head.weight = nn.Parameter(net.head.weight.detach() * 2)


def _move(net):
    net.double().float()


_AFTER_A_DROP = ["eager", "captures", "replays"]


@pytest.mark.parametrize("action, kinds", [
    (lambda net: set_quant_mode(net, "none"), _AFTER_A_DROP),
    (lambda net: set_compute_dtype(net, torch.float32), _AFTER_A_DROP),
    # the call in training mode drops the graphs and records nothing
    (lambda net: net.train(), ["eager", "eager", "captures"]),
    (_replace_weight, _AFTER_A_DROP),
    (_move, _AFTER_A_DROP),
], ids=["set_quant_mode", "set_compute_dtype", "train", "replaced parameter",
        "moved"])
def test_actions_that_drop_the_graphs(fake_card, action, kinds):
    """After each, the key is new again (at the next call, for the
    training mode and a move, which the call finds): one call, then
    two in eval mode; every result is the eager forward's."""
    net = Toy().eval()
    _kinds(net, [_x(0), _x(1)])
    assert graphs.count(net) == 1
    action(net)
    first, _ = _kinds(net, [_x(2)])
    net.eval()
    then, outs = _kinds(net, [_x(3), _x(4)])
    assert first + then == kinds
    assert graphs.count(net) == 1
    for x, o in zip((_x(3), _x(4)), outs):
        assert torch.equal(o, forward_eager(net, x))


def test_an_in_place_load_keeps_the_graphs(fake_card):
    """``variables_from_numpy`` copies into the same tensors: the graph
    is kept, and its replay computes with the new values."""
    net = Toy().eval()
    _kinds(net, [_x(0), _x(1)])
    ptrs = [t.data_ptr() for t in net.state_dict().values()]
    variables = variables_to_numpy(net)
    variables["params"]["head"]["kernel"] = (
        variables["params"]["head"]["kernel"] * np.float32(-3))
    variables_from_numpy(net, variables)
    assert [t.data_ptr() for t in net.state_dict().values()] == ptrs
    kinds, outs = _kinds(net, [_x(2)])
    assert kinds == ["replays"] and graphs.count(net) == 1
    assert torch.equal(outs[0], forward_eager(net, _x(2)))


def test_counters_and_replayed_launches_add_up(fake_card):
    """Five calls at one key: one eager, one capture, three replays; the
    stand-in kernel counts one launch a call (the capture's own is
    taken back and each replay adds the increment it recorded); the
    network's forward hook sees each call's own maps."""
    net = Toy().eval()
    seen = []
    net.register_forward_hook(
        lambda m, a, out: seen.append(out["concat_stage7"]))
    before = (run_backbone.eager, run_backbone.captures,
              run_backbone.replays, tick.launches)
    kinds, outs = _kinds(net, [_x(i) for i in range(5)])
    after = (run_backbone.eager, run_backbone.captures,
             run_backbone.replays, tick.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 3, 5]
    assert kinds == ["eager", "captures", "replays", "replays", "replays"]
    assert len(seen) == 5
    for s, o in zip(seen, outs):
        assert s is o


def test_a_replay_gives_back_the_maps_alone(fake_card):
    """The network's forward hook sees every output on an eager call,
    and on a replay a dict of the cloned maps alone: nothing else is
    copied."""
    net = Toy().eval()
    keys = []
    net.register_forward_hook(lambda m, a, out: keys.append(sorted(out)))
    kinds, _ = _kinds(net, [_x(i) for i in range(3)])
    assert kinds == ["eager", "captures", "replays"]
    assert keys == [["concat_stage7", "features"], ["concat_stage7"],
                    ["concat_stage7"]]


def test_a_graph_holds_the_tables_its_forward_read(fake_card):
    """mobilenet_v2's forward reads its upsample taps from a cache of
    ``ops/resize.py``. The graph holds them: after more new sizes than
    the cache keeps, they are alive until the graph is dropped, and the
    replayed maps equal the eager forward's."""
    net = get_network("mobilenet_v2_small")
    init_weights(net, torch.Generator().manual_seed(2))
    net.eval()
    x = _x(6, (1, 64, 48, 3))
    assert _kinds(net, [x, x])[0] == ["eager", "captures"]
    (entry,) = graphs._GRAPHS[net].graphs.values()
    kept = entry[2]
    assert len(kept) == 8  # (i0, i1, w0, w1) for the rows and the columns
    refs = [weakref.ref(t) for t in kept]
    del kept, entry
    for n in range(2, 302):
        resize.resize_bilinear(torch.zeros(1, n, 2, 1), 3, 3)
    info = resize._bilinear_taps_on.cache_info()
    assert info.currsize == info.maxsize < 300
    gc.collect()
    assert all(r() is not None for r in refs)
    y = _x(7, (1, 64, 48, 3))
    kinds, outs = _kinds(net, [y])
    assert kinds == ["replays"]
    assert torch.equal(outs[0], forward_eager(net, y))
    graphs.drop(net)
    gc.collect()
    assert all(r() is None for r in refs)


def test_the_cpu_result_is_the_eager_forward_bit_for_bit():
    """On the CPU ``run_backbone`` runs the forward as it always did:
    ``net(x)["concat_stage7"].float()`` in inference mode with cuDNN's
    TF32 off, and holds no graph."""
    net = get_network("mobilenet_thin")
    init_weights(net, torch.Generator().manual_seed(1))
    net.eval()
    x = _x(5, (1, 48, 40, 3))
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, allow_tf32=False):
        want = net(x)["concat_stage7"].float()
    for _ in range(3):
        got = run_backbone(net, x)
        assert torch.equal(got, want) and got.dtype == torch.float32
    assert graphs.count(net) == 0
