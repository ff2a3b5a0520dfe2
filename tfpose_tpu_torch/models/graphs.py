"""The backbone's eval forward replayed as a CUDA graph at an input shape
it has already seen (``estimator.run_backbone``).

At one image a call, thin's forward is ~700 small kernels that each end
before the host has launched the next, so the card waits on the host
for most of the call. A replay launches the same kernels, with the same
arguments, as one ``cudaGraphLaunch``: one copy into the graph's static
input, the launch, and a clone of its static output.

When a graph engages depends only on what the code can observe:

* the input is a CUDA tensor, the network is in eval mode, no row
  sharding is active (``parallel/halo.py``; the data mesh has none
  inside the backbone), and no dispatch mode (``FlopCounterMode``) or
  global module hook is active, since a replay dispatches no op;
* every conv of the network computes in plain mode (``quant`` "none":
  ``"calib"`` writes ``in_absmax`` and int8 has no cell yet), and no
  hook sits on a submodule or before the network's forward (the
  network's own forward hooks run after each replay, on the cloned
  output). This is checked before a capture, and again before a replay
  whenever a hook has been registered anywhere since the last check; a
  network that fails it lets its graphs go and stays eager until they
  are dropped;
* the key is the input's shape, dtype, device and strides, and only an
  input whose elements fill its memory without gaps or overlaps is
  captured (the static input takes its strides: a resized frame is
  column-major). The first call at a key in a thread runs eager, which
  is also the warm-up that cuDNN (whose handles are per thread) and the
  allocator need before a capture; the second in that thread captures,
  on a side stream with its own memory pool, and replays; every later
  call, in any thread, replays. A shape seen once is never captured,
  and a network holds at most :data:`MAX_GRAPHS` graphs: later shapes
  run eager and nothing is evicted, so nothing thrashes.

A replay copies the input into the static buffer on the current stream,
launches the graph there and returns ``{OUTPUT: a clone of the static
output}``, the one map that the callers read (the video pipeline decodes
frame k while frame k+1's forward runs on its own stream). A replay on
another stream than the previous one of the same graph first waits on
that replay's end event: a stream wait, not a host sync.

A network's graphs are dropped by :func:`drop`, which ``set_quant_mode``
and ``set_compute_dtype`` (hence ``quantize_network``) call; by a call
that finds the network in training mode; when its first parameter's
storage moved (``.to()`` another device or dtype); and when a parameter,
buffer or submodule of it is replaced (PyTorch's global registration
hooks, installed at the first capture). In-place loads
(``convert/checkpoint.py:variables_from_numpy``, ``load_state_dict``)
keep them valid: a replay reads the new values at the same addresses.
A graph keeps alive every tensor its forward reads: the network's
parameters and buffers, and the tables a forward takes from a cache of
its own (``ops/resize.py``'s bilinear taps), which the forward passes to
:func:`hold` while a capture runs.

The kernel wrappers count launches in Python, which a replay skips: a
capture records each counter's increment (99 ``bias_prelu.launches`` in
BODY_25) and every replay adds it, so the counters keep counting the
kernels that ran.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module
from torch.utils.hooks import RemovableHandle

from tfpose_tpu_torch.parallel import halo
from tfpose_tpu_torch.utils.profiling import span

MAX_GRAPHS = 4
# the one output of the forward that a replay gives back
OUTPUT = "concat_stage7"
# shapes remembered as seen once; past this the record starts again
SEEN_LIMIT = 64


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lives where a graph can be captured."""
    return x.is_cuda


def launch_counters():
    """The kernel wrappers, each counting its launches in ``launches``."""
    from tfpose_tpu_torch.ops.kernels import wrappers

    return tuple(wrappers().values())


# ``kept``: the list of what :func:`hold` keeps, while this thread captures
_CAPTURING = threading.local()


def hold(*tensors: torch.Tensor) -> None:
    """Keep ``tensors`` alive as long as the graph that this thread is
    capturing, if any. A forward calls this for each tensor it reads that
    it does not own (a table from a cache): a replay reads the tensor at
    the address the capture saw, whether or not the cache still holds it.
    """
    kept = getattr(_CAPTURING, "kept", None)
    if kept is not None:
        kept.extend(tensors)


class Graph:
    """One captured eval forward of ``net`` at ``x``'s key, keeping its
    :data:`OUTPUT`."""

    def __init__(self, net: nn.Module, x: torch.Tensor):
        self.x = torch.empty_like(x)
        self.x.copy_(x)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            # not ``torch.cuda.graph``, which synchronizes the card and
            # empties the allocator's cache first; thread_local: another
            # thread's work on the card (a service's decode) goes on
            # while this thread captures
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.out = net.forward(self.x)[OUTPUT]
                finally:
                    self.graph.capture_end()
        self.done = torch.cuda.Event()
        self.stream: Optional[torch.cuda.Stream] = None

    def replay(self, x: torch.Tensor):
        stream = torch.cuda.current_stream(x.device)
        if self.stream is not None and self.stream != stream:
            stream.wait_event(self.done)
        self.x.copy_(x)
        self.graph.replay()
        out = {OUTPUT: self.out.clone()}
        self.done.record(stream)
        self.stream = stream
        return out


class _NetGraphs:
    """A network's graphs by key, and what decides whether they hold."""

    def __init__(self, net: nn.Module):
        self.graphs: Dict[Tuple, Tuple[Graph, Dict, list]] = {}
        self.seen = set()
        self.eager_only = False
        # the hooks registered anywhere when ``_plain`` last held
        self.hooks = -1
        # the first parameter: a ``.to()`` moves its storage
        self.probe = next(((m._parameters, n, p) for m in net.modules()
                           for n, p in m._parameters.items()
                           if p is not None), None)
        self.probe_ptr = (None if self.probe is None
                          else self.probe[2].data_ptr())
        self.storages = []

    def holds(self) -> bool:
        if self.probe is None:
            return True
        params, name, p = self.probe
        return params.get(name) is p and p.data_ptr() == self.probe_ptr

    def watch(self, net: nn.Module) -> None:
        """Before a capture: drop the graphs when a tensor of ``net`` is
        replaced, and keep the storages the graphs read alive, so that a
        moved network's new storage never takes the probe's old address
        and a graph never reads freed memory."""
        if not _HOOKS:
            _HOOKS.extend([
                _module.register_module_parameter_registration_hook(
                    _replaced),
                _module.register_module_buffer_registration_hook(_replaced),
                _module.register_module_module_registration_hook(
                    _replaced)])
        ref = weakref.ref(net)
        for m in net.modules():
            _OWNERS[m] = ref
        self.storages = [t.untyped_storage() for t in
                         (*net.parameters(), *net.buffers())]


_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, _NetGraphs]" = (
    weakref.WeakKeyDictionary())
# every module of a network with graphs -> that network
_OWNERS: "weakref.WeakKeyDictionary[nn.Module, weakref.ref]" = (
    weakref.WeakKeyDictionary())
_HOOKS = []


def drop(net: nn.Module) -> None:
    """Forget ``net``'s graphs (and the shapes it has seen)."""
    _GRAPHS.pop(net, None)


def count(net: nn.Module) -> int:
    """The number of graphs ``net`` holds."""
    cache = _GRAPHS.get(net)
    return 0 if cache is None else len(cache.graphs)


def _replaced(module: nn.Module, name: str, value) -> None:
    owner = _OWNERS.get(module)
    net = None if owner is None else owner()
    if net is not None:
        drop(net)


def _plain(net: nn.Module) -> bool:
    """No conv quantises, and no hook runs but the network's own
    forward hooks."""
    if net._forward_pre_hooks or net._forward_hooks_with_kwargs:
        return False
    return all(getattr(m, "quant", "none") == "none"
               and not (m._forward_pre_hooks or m._forward_hooks)
               for m in net.modules() if m is not net)


def _replayable(net: nn.Module, x: torch.Tensor) -> bool:
    return (on_card(x) and not net.training
            and halo.current_rows() is None
            and torch._C._len_torch_dispatch_stack() == 0
            and not _module._global_forward_hooks
            and not _module._global_forward_pre_hooks)


def _still_plain(net: nn.Module, cache: _NetGraphs) -> bool:
    """Whether ``net`` passes :func:`_plain`, checked again only when a
    hook has been registered anywhere since it last passed."""
    if cache.hooks == RemovableHandle.next_id:
        return True
    if _plain(net):
        cache.hooks = RemovableHandle.next_id
        return True
    cache.graphs.clear()
    cache.eager_only = True
    return False


def _capture(net: nn.Module, x: torch.Tensor) -> Tuple[Graph, Dict, list]:
    """A graph of ``net`` at ``x``; each launch counter's increment,
    recorded and taken back (the capture launches nothing); and the
    tensors the forward handed to :func:`hold`."""
    counters = launch_counters()
    before = [c.launches for c in counters]
    kept = _CAPTURING.kept = []
    try:
        graph = Graph(net, x)
    finally:
        _CAPTURING.kept = None
        after = [c.launches for c in counters]
        for c, n in zip(counters, before):
            c.launches = n
    return graph, {c: a - n for c, n, a in zip(counters, before, after)
                   if a != n}, kept


def _replay(net: nn.Module, x: torch.Tensor,
            entry: Tuple[Graph, Dict, list]):
    graph, steps, _ = entry
    out = graph.replay(x)
    for c, n in steps.items():
        c.launches += n
    for hook in tuple(net._forward_hooks.values()):
        res = hook(net, (x,), out)
        if res is not None:
            out = res
    return out


def forward(net: nn.Module, x: torch.Tensor) -> Tuple[str, object]:
    """``net(x)`` by the rules above: ("eager", its output), or
    ("captures" / "replays", ``{OUTPUT: the graph's output cloned}``)."""
    if not _replayable(net, x):
        if net.training:
            drop(net)
        return "eager", net(x)
    cache = _GRAPHS.get(net)
    if cache is None or not cache.holds():
        cache = _GRAPHS[net] = _NetGraphs(net)
    key = (tuple(x.shape), x.dtype, x.device, x.stride())
    entry = cache.graphs.get(key)
    if entry is not None and _still_plain(net, cache):
        with span("model.replay"):
            return "replays", _replay(net, x, entry)
    # a thread's first call warms its own cuDNN handle up: a capture in a
    # thread that has not run the key eagerly fails inside cuDNN
    seen = (key, threading.get_ident())
    if (seen in cache.seen and not cache.eager_only
            and len(cache.graphs) < MAX_GRAPHS):
        if not _plain(net):
            cache.eager_only = True
        elif torch.empty_like(x).stride() == x.stride():  # dense
            with span("model.capture"):
                cache.watch(net)
                cache.hooks = RemovableHandle.next_id
                entry = cache.graphs[key] = _capture(net, x)
                return "captures", _replay(net, x, entry)
        return "eager", net(x)
    if len(cache.seen) >= SEEN_LIMIT:
        cache.seen.clear()
    cache.seen.add(seen)
    return "eager", net(x)
