"""The device mesh — counterpart of ``tfpose_tpu/parallel/mesh.py``.

JAX runs one program over a ``('data', 'spatial')`` mesh of devices: the
batch is split over ``data``, the image height over ``spatial``, and XLA
inserts the collectives. The port runs one process per rank
(:func:`launch`), each on its device, joined by ``torch.distributed``
(NCCL on the cards; gloo where the caller names it: the CPU, or ranks
that share one card). A :class:`Mesh` holds the grid, this rank's
coordinates and its process groups; the grid is laid out row-major, as
JAX's ``make_mesh`` reshapes its device list: rank ``d * n_spatial + s``
is data index ``d``, spatial index ``s``.

* :func:`shard_batch` cuts this rank's block out of a global batch:
  rows ``row_bounds(N, n_data)[d]`` of the batch and, with a spatial
  axis, rows ``row_bounds(H, n_spatial)[s]`` of the ``SPATIAL_KEYS``
  entries (``joints`` rides the data axis alone);
* :func:`sharded` is the context in which a forward of the local block
  exchanges row halos (``parallel/halo.py``) and in which BatchNorm's
  training statistics are summed over the world;
* :func:`replicated` broadcasts rank 0's parameters and buffers;
* :func:`broadcast_batch` hands rank 0's global batch to every rank,
  :func:`gather_blocks` puts the blocks of a sharded result together on
  every rank, :func:`all_reduce_grads` sums the gradients and
  :func:`sum_metrics` the metrics, and
  :func:`assert_replicas_equal` checks that the ranks' train states are
  equal bit for bit.

A mesh of one rank outside :func:`launch` has no process group, and its
collectives are identities. Nothing here picks another backend, device
or path when one fails: it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tfpose_tpu_torch.parallel.halo import (
    RowShard,
    Sharding,
    row_bounds,
    use,
)

# Batch-dict keys with NHWC spatial layout; everything else (e.g.
# 'joints' (N, people, 18, 2)) is data-sharded only even when a
# spatial mesh axis is active.
SPATIAL_KEYS = ("image", "heat", "paf")


@dataclasses.dataclass
class Mesh:
    """``n_data`` x ``n_spatial`` ranks; this process is ``rank`` on
    ``device``. ``world``, ``data`` (the ranks of this spatial index)
    and ``spatial`` (the ranks of this data index) are process groups,
    None in a mesh of one rank without a process group."""

    n_data: int
    n_spatial: int
    rank: int
    device: torch.device
    world: Optional[dist.ProcessGroup] = None
    data: Optional[dist.ProcessGroup] = None
    spatial: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "spatial": self.n_spatial}

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial


def check_grid(n_data: int, n_spatial: int, n_devices: int) -> None:
    """JAX's ``make_mesh`` assertion, as a check that raises."""
    if n_data * n_spatial > n_devices:
        raise ValueError(f"need {n_data}x{n_spatial} devices, have "
                         f"{n_devices}")


def visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """This rank's view of an ``n_data`` x ``n_spatial`` mesh over
    ``devices`` (default: the visible cards; one device per rank, and a
    card may repeat). Inside :func:`launch` the grid must cover the
    world; outside it, the mesh is one rank. Every rank must call this
    alike: it creates the process groups."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else visible_cards())]
    if n_data is None:
        n_data = len(devices) // n_spatial
    check_grid(n_data, n_spatial, len(devices))
    size = n_data * n_spatial
    if size < 1:
        raise ValueError(f"a mesh needs at least one rank, got "
                         f"{n_data}x{n_spatial}")
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(f"a {n_data}x{n_spatial} mesh runs one "
                             f"process per rank: start it with launch()")
        return Mesh(n_data, n_spatial, 0, devices[0])
    if dist.get_world_size() != size:
        raise ValueError(f"a {n_data}x{n_spatial} mesh in a world of "
                         f"{dist.get_world_size()} ranks")
    rank = dist.get_rank()
    mesh = Mesh(n_data, n_spatial, rank, devices[rank],
                world=dist.group.WORLD)
    for s in range(n_spatial):      # every rank creates every group
        g = dist.new_group([d * n_spatial + s for d in range(n_data)])
        if s == mesh.spatial_index:
            mesh.data = g
    for d in range(n_data):
        g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
        if d == mesh.data_index:
            mesh.spatial = g
    return mesh


def _block(a, axis: int, lo: int, hi: int):
    index = [slice(None)] * (axis + 1)
    index[axis] = slice(lo, hi)
    return a[tuple(index)]


def shard_batch(mesh: Mesh, arrays, spatial_axis: Optional[int] = 1,
                spatial_keys: Sequence[str] = SPATIAL_KEYS):
    """This rank's block of a global batch (numpy arrays or tensors, or
    a dict of them): its rows of the batch and, with ``spatial_axis``
    and more than one spatial rank, its rows of that axis. For dict
    batches only ``spatial_keys`` entries are split along
    ``spatial_axis``."""
    spatial = spatial_axis is not None and mesh.n_spatial > 1

    def cut(a, rows: bool):
        b = row_bounds(a.shape[0], mesh.n_data)
        a = _block(a, 0, b[mesh.data_index], b[mesh.data_index + 1])
        if rows:
            b = row_bounds(a.shape[spatial_axis], mesh.n_spatial)
            a = _block(a, spatial_axis, b[mesh.spatial_index],
                       b[mesh.spatial_index + 1])
        return a

    if isinstance(arrays, dict):
        return {k: cut(v, spatial and k in spatial_keys)
                for k, v in arrays.items()}
    return cut(arrays, spatial)


def sharded(mesh: Mesh, image_hw=None, stats: bool = False):
    """Context of a forward of this rank's block: with ``image_hw``, the
    global (H, W) of the network input, and more than one spatial rank,
    the layers exchange row halos over the spatial group; with
    ``stats`` and more than one rank, BatchNorm's training statistics
    are summed over the world."""
    rows = None
    if image_hw is not None and mesh.n_spatial > 1:
        rows = RowShard(mesh.spatial, mesh.spatial_index, mesh.n_spatial,
                        int(image_hw[0]), int(image_hw[1]))
    group = mesh.world if stats and mesh.size > 1 else None
    if rows is None and group is None:
        return contextlib.nullcontext()
    return use(Sharding(rows=rows, stats_group=group))


def _coalesced(tensors: List[torch.Tensor], op: Callable[[torch.Tensor],
                                                         None]) -> None:
    """Apply the collective ``op`` to ``tensors`` as one flat buffer per
    dtype, in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers (in place)."""
    if mesh.world is not None:
        with torch.no_grad():
            _coalesced([t.data for t in module.parameters()]
                       + [t.data for t in module.buffers()],
                       lambda f: dist.broadcast(f, 0, group=mesh.world))
    return module


def all_reduce_grads(mesh: Mesh, params: Sequence[torch.nn.Parameter]
                     ) -> None:
    """Sum the gradients over the world (a missing one counts as 0)."""
    if mesh.world is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _coalesced([p.grad for p in params],
               lambda f: dist.all_reduce(f, group=mesh.world))


def sum_metrics(mesh: Mesh, values: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """0-dim metrics summed over the world."""
    if mesh.world is None:
        return values
    keys = sorted(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=mesh.world)
    return {k: flat[i] for i, k in enumerate(keys)}


def gather_blocks(local: torch.Tensor, bounds: Sequence[int], index: int,
                  group, dim: int = 0) -> torch.Tensor:
    """The whole tensor on every rank of ``group``, whose rank ``i``
    holds rows ``[bounds[i], bounds[i + 1])`` along ``dim``: an
    ``all_reduce`` (sum) of a zeroed buffer holding this rank's block,
    exact since every element has one writer. Bool travels as uint8."""
    if group is None:
        return local
    shape = list(local.shape)
    shape[dim] = bounds[-1]
    dtype = torch.uint8 if local.dtype == torch.bool else local.dtype
    buf = torch.zeros(shape, dtype=dtype, device=local.device)
    buf.narrow(dim, bounds[index], bounds[index + 1] - bounds[index]).copy_(
        local)
    dist.all_reduce(buf, group=group)
    return buf.bool() if local.dtype == torch.bool else buf


def broadcast_batch(mesh: Mesh, batch: Optional[Dict[str, Any]]
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """Rank 0's global batch (a dict of arrays, or None at the end of
    the data) as tensors on every rank's device; the other ranks pass
    None. One ``broadcast`` per array, after one of their shapes."""
    if mesh.world is None:
        if batch is None:
            return None
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v, device=mesh.device)
                for k, v in batch.items()}
    spec = [None]
    tensors = {}
    if mesh.rank == 0 and batch is not None:
        tensors = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                      else v) for k, v in batch.items()}
        spec = [{k: (tuple(t.shape), t.dtype) for k, t in tensors.items()}]
    dist.broadcast_object_list(spec, src=0, group=mesh.world)
    if spec[0] is None:
        return None
    out = {}
    for k, (shape, dtype) in spec[0].items():
        t = (tensors[k].to(mesh.device).contiguous() if mesh.rank == 0
             else torch.empty(shape, dtype=dtype, device=mesh.device))
        dist.broadcast(t, 0, group=mesh.world)
        out[k] = t
    return out


def assert_replicas_equal(mesh: Mesh, tensors: Sequence[torch.Tensor],
                          what: str = "train state") -> None:
    """Raise unless every rank holds ``tensors`` (float32) equal bit for
    bit: the elementwise max and min of their bits over the world agree."""
    if mesh.world is None:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    bits = flat.view(torch.int32)
    hi, lo = bits.clone(), bits.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.world)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.world)
    bad = int((hi != lo).sum())
    if bad:
        raise RuntimeError(f"{what}: {bad} of {flat.numel()} values differ "
                           f"between the {mesh.size} ranks")


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

def _rank_main(rank: int, n_ranks: int, devices, backend: str, store: str,
               timeout: float, threads: int, results, fn, args) -> None:
    try:
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException as e:
        text = traceback.format_exc()
        try:
            exc = pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an exception that won't pickle
            exc = None
        results.put((rank, False, (exc, text)))   # for the caller
        raise


class RankFailed(RuntimeError):
    """A rank of :func:`launch` failed; the message is its traceback."""


def launch(fn: Callable, n_ranks: int, devices: Sequence, backend: str,
           *args, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n_ranks`` processes (``spawn``), rank ``r``
    on ``devices[r]`` with a ``torch.distributed`` process group of
    ``backend`` ("nccl" or "gloo") already joined, and return each
    rank's return value, in rank order. ``fn`` must be a top-level
    function; ``args`` and the return values are pickled (pass numpy
    arrays). The rendezvous is a ``file://`` store in a temporary
    directory: no network, no port. If a rank raises, the others are
    stopped and its exception is raised here (its traceback as the
    cause); ``timeout`` bounds each collective."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) < n_ranks:
        raise ValueError(f"{n_ranks} ranks need {n_ranks} devices, got "
                         f"{len(devices)}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="tfpose_mesh_")
    threads = max(1, torch.get_num_threads() // n_ranks)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n_ranks, devices, backend, os.path.join(tmp, "store"), timeout,
        threads, results, fn, args)) for r in range(n_ranks)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # its report may still be on the way
                    rank, ok, payload = results.get(timeout=5.0)
                except queue_lib.Empty:
                    raise RankFailed(f"rank {dead[0]} exited with code "
                                     f"{procs[dead[0]].exitcode}") from None
            if not ok:
                exc, text = payload
                cause = RankFailed(f"rank {rank} failed:\n{text}")
                if exc is not None:
                    raise pickle.loads(exc) from cause
                raise cause
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n_ranks)]
