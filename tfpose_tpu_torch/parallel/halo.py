"""Row halos: what XLA's GSPMD inserts for JAX when an image's height is
sharded over the mesh's ``spatial`` axis (``tfpose_tpu/parallel/mesh.py``:
"GSPMD inserts halo exchanges for the convolutions").

Every activation of a row-sharded forward is split along its height the
same way at every resolution: rank ``s`` of ``n`` holds the rows
``[row_bounds(rows, n)[s], row_bounds(rows, n)[s + 1])`` of the global
activation (``numpy.array_split``'s rule: 46 rows over 4 ranks are
12/12/11/11). An op whose window reaches across rows (a 3x3 or 7x7 conv
at stride 1 or 2, the 2x2 max-pool, the bilinear 2x upsample) first
fetches the rows of its neighbours that its block of outputs reads
(:func:`window`, :func:`fetch`). The geometry is derived per op from its
kernel, stride and the global ``SAME`` padding (which pads only at the
image's true top and bottom edge), never from an assumption that the
shards line up across strides: 368 rows over 2 ranks leave 23 + 23 rows
at stride 8 and 6 + 6 at stride 16 of 12, 33 rows leave a partial row.

The exchange (:class:`_Exchange`, an ``autograd.Function``) is one
``all_reduce`` (sum) over the spatial group of a zeroed buffer with two
slots per rank, the rows it lacks above and below its block: each row
of a slot is written by its owner alone, so the sum is exact. Its
backward is the same ``all_reduce`` of the halo rows' gradients, which
each owner adds into its own rows. ``all_reduce`` is what NCCL and gloo
both take on CUDA tensors (gloo's ``send``/``recv`` take CPU tensors
only), so one code path serves both backends.

The global height of an activation is read off its width, which no rank
splits: every stride of the three networks is 2 along both axes, so an
activation ``ceil(W / 2**j)`` wide is ``ceil(H / 2**j)`` rows high.

:func:`use` enters the context in which the layers (``models/layers.py``)
and ``ops/resize.py:resize_bilinear`` shard: :class:`Sharding` names the
spatial rows (:class:`RowShard`) and the group over which BatchNorm's
training statistics are summed. Outside it, the default, every layer
runs as on one device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def row_bounds(rows: int, n: int) -> List[int]:
    """Boundaries of ``rows`` split over ``n`` ranks (``array_split``):
    rank ``i`` holds ``[b[i], b[i + 1])``; the first ``rows % n`` blocks
    hold one row more."""
    q, r = divmod(rows, n)
    return [i * q + min(i, r) for i in range(n + 1)]


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's share of a row-sharded forward: ``index`` of ``n``
    ranks of the spatial ``group``, for a network input of
    ``image_rows`` x ``image_cols``."""

    group: Optional[dist.ProcessGroup]
    index: int
    n: int
    image_rows: int
    image_cols: int

    def rows_at(self, cols: int) -> int:
        """Global height of an activation ``cols`` wide."""
        r, c = self.image_rows, self.image_cols
        while c != cols:
            if c == 1:
                raise ValueError(f"no level of a {self.image_rows}x"
                                 f"{self.image_cols} input is {cols} wide")
            r, c = -(-r // 2), -(-c // 2)
        if c == 1 and r > 1:
            raise ValueError("a row-sharded activation one column wide "
                             "does not name its level")
        return r

    def bounds(self, rows: int) -> List[int]:
        if rows < self.n:
            raise ValueError(f"{rows} rows cannot be split over {self.n} "
                             f"spatial shards")
        return row_bounds(rows, self.n)

    def block(self, rows: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a global height ``rows``."""
        b = self.bounds(rows)
        return b[self.index], b[self.index + 1]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The context of one sharded forward: ``rows`` when the height is
    split (else None); ``stats_group`` when BatchNorm's training
    statistics are summed over several ranks (else None)."""

    rows: Optional[RowShard] = None
    stats_group: Optional[dist.ProcessGroup] = None


_CURRENT: contextvars.ContextVar[Optional[Sharding]] = contextvars.ContextVar(
    "tfpose_tpu_torch_sharding", default=None)


def current() -> Optional[Sharding]:
    return _CURRENT.get()


def current_rows() -> Optional[RowShard]:
    sh = _CURRENT.get()
    return None if sh is None else sh.rows


@contextlib.contextmanager
def use(sharding: Optional[Sharding]):
    """Run the layers under ``sharding`` (None: unsharded)."""
    token = _CURRENT.set(sharding)
    try:
        yield sharding
    finally:
        _CURRENT.reset(token)


def row_offset(cols: int) -> int:
    """Global index of this rank's first row of an activation ``cols``
    wide (0 outside a row-sharded forward)."""
    rs = current_rows()
    return 0 if rs is None else rs.block(rs.rows_at(cols))[0]


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward sums the gradients likewise:
    each rank's loss term reaches every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def _plan(bounds: Sequence[int], needs: Sequence[Tuple[int, int]]):
    """For each rank, the rows it reads but does not hold: (above,
    below) as ``[a, b)`` ranges, and the rows of its own block it reads."""
    plan = []
    for r, (lo, hi) in enumerate(needs):
        b0, b1 = bounds[r], bounds[r + 1]
        above = (lo, max(lo, min(hi, b0)))
        below = (min(hi, max(lo, b1)), hi)
        own = (max(lo, b0), max(max(lo, b0), min(hi, b1)))
        plan.append((above, below, own))
    return plan


class _Exchange(torch.autograd.Function):
    """Rows ``needs[index]`` of the global activation, from this rank's
    block ``x`` (rows along ``dim``) and its neighbours'."""

    @staticmethod
    def forward(ctx, x, group, index, dim, bounds, needs):
        plan = _plan(bounds, needs)
        width = max(b - a for p in plan for a, b in p[:2])
        b0, b1 = bounds[index], bounds[index + 1]
        ctx.meta = (group, index, dim, bounds, plan, width, x.shape)
        above, below, own = plan[index]
        mine = x.narrow(dim, own[0] - b0, own[1] - own[0])
        if width == 0:
            return mine.clone()
        shape = list(x.shape)
        shape[dim] = width
        buf = x.new_zeros([len(plan), 2] + shape)
        for dst, slots in enumerate(plan):
            for j, (a, b) in enumerate(slots[:2]):
                s, e = max(a, b0), min(b, b1)
                if s < e:
                    buf[dst, j].narrow(dim, s - a, e - s).copy_(
                        x.narrow(dim, s - b0, e - s))
        dist.all_reduce(buf, group=group)
        return torch.cat([buf[index, 0].narrow(dim, 0, above[1] - above[0]),
                          mine,
                          buf[index, 1].narrow(dim, 0, below[1] - below[0])],
                         dim)

    @staticmethod
    def backward(ctx, g):
        group, index, dim, bounds, plan, width, shape = ctx.meta
        b0, b1 = bounds[index], bounds[index + 1]
        above, below, own = plan[index]
        na, no, nb = (above[1] - above[0], own[1] - own[0],
                      below[1] - below[0])
        gx = g.new_zeros(shape)
        gx.narrow(dim, own[0] - b0, no).copy_(g.narrow(dim, na, no))
        if width == 0:
            return gx, None, None, None, None, None
        gshape = list(shape)
        gshape[dim] = width
        buf = g.new_zeros([len(plan), 2] + gshape)
        buf[index, 0].narrow(dim, 0, na).copy_(g.narrow(dim, 0, na))
        buf[index, 1].narrow(dim, 0, nb).copy_(g.narrow(dim, na + no, nb))
        dist.all_reduce(buf, group=group)
        for dst, slots in enumerate(plan):
            for j, (a, b) in enumerate(slots[:2]):
                s, e = max(a, b0), min(b, b1)
                if s < e and dst != index:
                    gx.narrow(dim, s - b0, e - s).add_(
                        buf[dst, j].narrow(dim, s - a, e - s))
        return gx, None, None, None, None, None


def fetch(x: torch.Tensor, shard: RowShard, dim: int, rows: int,
          needs: Sequence[Tuple[int, int]],
          fill: Optional[float] = None) -> torch.Tensor:
    """Rows ``needs[shard.index]`` (``[lo, hi)``, possibly beyond the
    image) of a global activation ``rows`` high, of which ``x`` holds
    this rank's block along ``dim``; ``needs`` lists every rank's range,
    which every rank computes alike. Rows outside ``[0, rows)`` are
    ``fill`` (a range may leave the image only where ``fill`` is given)."""
    dim = dim % x.dim()
    bounds = shard.bounds(rows)
    if x.shape[dim] != bounds[shard.index + 1] - bounds[shard.index]:
        raise ValueError(
            f"rank {shard.index} of {shard.n} holds {x.shape[dim]} of "
            f"{rows} rows; row_bounds gives it "
            f"{bounds[shard.index + 1] - bounds[shard.index]}")
    clipped = [(max(lo, 0), min(hi, rows)) for lo, hi in needs]
    if any(hi <= lo for lo, hi in clipped):
        raise ValueError(f"an empty row range in {needs}")
    y = _Exchange.apply(x, shard.group, shard.index, dim, bounds, clipped)
    lo, hi = needs[shard.index]
    a, b = clipped[shard.index]
    if (a - lo) or (hi - b):
        if fill is None:
            raise ValueError(f"rows [{lo}, {hi}) leave the image of {rows}")
        pad = [0, 0] * (x.dim() - 1 - dim) + [a - lo, hi - b]
        y = F.pad(y, pad, value=fill)
    return y


def window(x: torch.Tensor, shard: RowShard, dim: int, rows: int,
           kernel: int, stride: int, pad_top: int, fill: float
           ) -> torch.Tensor:
    """The input rows that this rank's block of outputs of a ``kernel``
    x ``stride`` window op reads, with ``SAME``'s ``pad_top`` rows of
    ``fill`` above the image and its rows below: the op then runs
    without vertical padding and yields exactly this rank's outputs."""
    out = shard.bounds(-(-rows // stride))
    needs = [(out[r] * stride - pad_top,
              (out[r + 1] - 1) * stride - pad_top + kernel)
             for r in range(shard.n)]
    return fetch(x, shard, dim, rows, needs, fill)
