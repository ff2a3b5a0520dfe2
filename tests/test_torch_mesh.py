"""The port's mesh (``parallel/mesh.py``) and row halos
(``parallel/halo.py``) on the CPU: gloo ranks started by ``launch``
(``spawn``, a ``file://`` store, no network).

* ``make_mesh``: JAX's shapes and assertion text;
* ``shard_batch``: each rank's block equals the slices of JAX's
  ``batch_sharding`` index maps on the 8 virtual devices
  (``tests/test_parallel.py``), ``joints`` on the data axis alone, and
  ``array_split``'s rule where the height does not divide;
* the halo exchange of every window op of the three networks (3x3 conv
  at stride 1, 3x3 depthwise at stride 2, CMU's 7x7, the 2x2 max-pool,
  v2's bilinear 2x) at an even (48 rows over 2 ranks), an uneven (46
  over 4: 12/12/11/11) and an odd height (33 over 2 and over 4): each
  rank's outputs against its rows of the unsharded op, and the gradient
  through ``autograd.grad`` against its rows of the unsharded gradient,
  within 1e-6 of the largest value (measured: the forward exact, the
  gradients within 6.3e-7 of the largest, at the 7x7 conv);
* ``launch`` re-raises a rank's exception; ``gather_blocks``,
  ``broadcast_batch``, ``replicated`` and ``assert_replicas_equal``.

The rank bodies are top-level functions that import no jax: a spawned
rank imports this module.
"""

import numpy as np
import pytest
import torch

from tfpose_tpu_torch.parallel.halo import row_bounds
from tfpose_tpu_torch.parallel.mesh import (
    SPATIAL_KEYS,
    Mesh,
    launch,
    make_mesh,
    shard_batch,
)

OPS = ("conv3x3", "depthwise3x3_s2", "conv7x7", "max_pool2x2", "bilinear2x")
CASES = {"even": (2, (48,)), "uneven": (4, (46,)), "odd": (2, (33,)),
         "odd4": (4, (33,))}
W = 20


def _ops():
    from tfpose_tpu_torch.models.layers import SameConv2d, max_pool
    from tfpose_tpu_torch.ops.resize import resize_bilinear

    g = torch.Generator().manual_seed(0)

    def conv(*a, **k):
        m = SameConv2d(*a, **k)
        with torch.no_grad():   # the same on every rank
            for t in m.parameters():
                t.copy_(torch.randn(t.shape, generator=g))
        return m

    return {"conv3x3": conv(6, 5, 3, 1),
            "depthwise3x3_s2": conv(6, 6, 3, 2, groups=6),
            "conv7x7": conv(6, 4, 7, 1),
            "max_pool2x2": max_pool,
            "bilinear2x": resize_bilinear}


def _op_errors(mesh, height):
    """{op: (forward error, gradient error)}, each relative to the
    largest value of the unsharded op's output or gradient."""
    from tfpose_tpu_torch.parallel.mesh import sharded

    rng = np.random.default_rng(height)
    s = mesh.spatial_index
    out = {}
    for name, op in _ops().items():
        if name == "bilinear2x":   # NHWC, from the half-height level
            x = rng.normal(size=(2, -(-height // 2), W // 2, 3))
            dim, in_h = 1, -(-height // 2)
            ob = row_bounds(height, mesh.n_spatial)

            def run(t, local):
                return op(t, ob[s + 1] - ob[s] if local else height, W)
        else:
            x = rng.normal(size=(2, 6, height, W))
            dim, in_h = 2, height

            def run(t, local):
                return op(t)
        x = torch.from_numpy(x.astype(np.float32))
        xl = shard_batch(mesh, x, spatial_axis=dim).clone().requires_grad_()
        with sharded(mesh, image_hw=(height, W)):
            y = run(xl, True)
        g = torch.autograd.grad((y * y).sum(), xl)[0]
        xf = x.clone().requires_grad_()
        yf = run(xf, False)
        gf = torch.autograd.grad((yf * yf).sum(), xf)[0]
        ob = row_bounds(yf.shape[dim], mesh.n_spatial)
        ib = row_bounds(in_h, mesh.n_spatial)
        want_y = yf.detach().narrow(dim, ob[s], ob[s + 1] - ob[s])
        want_g = gf.narrow(dim, ib[s], ib[s + 1] - ib[s])
        out[name] = (float((y.detach() - want_y).abs().max()
                           / yf.detach().abs().max()),
                     float((g - want_g).abs().max() / gf.abs().max()))
    return out


def _collectives(mesh):
    """gather_blocks, broadcast_batch, replicated, assert_replicas_equal
    on this rank; returns what the test checks."""
    from tfpose_tpu_torch.parallel.mesh import (
        assert_replicas_equal,
        broadcast_batch,
        gather_blocks,
        replicated,
    )

    r, n = mesh.rank, mesh.size
    bounds = row_bounds(7, n)
    local = torch.arange(bounds[r], bounds[r + 1], dtype=torch.float32)
    whole = gather_blocks(local[:, None].repeat(1, 3), bounds, r, mesh.world)
    flags = gather_blocks(local > 2, bounds, r, mesh.world)
    batch = ({"image": np.full((2, 3, 4, 3), 7, np.uint8),
              "joints": np.arange(8, dtype=np.float32).reshape(2, 4)}
             if r == 0 else None)
    got = broadcast_batch(mesh, batch)
    end = broadcast_batch(mesh, None)
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(r)
    replicated(mesh, lin)
    assert_replicas_equal(mesh, list(lin.parameters()))
    try:
        assert_replicas_equal(mesh, [torch.full((3,), float(r))])
        mismatch = None
    except RuntimeError as e:
        mismatch = str(e)
    return {"whole": whole.numpy(), "flags": flags.numpy(),
            "batch": {k: v.numpy() for k, v in got.items()},
            "end": end, "weight": lin.weight.detach().numpy(),
            "mismatch": mismatch}


def _mesh_rank(n_spatial, heights):
    mesh = make_mesh(1, n_spatial, ["cpu"] * n_spatial)
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "errors": {h: _op_errors(mesh, h) for h in heights}}
    if n_spatial == 2:
        out["collectives"] = _collectives(mesh)
        data = make_mesh(2, 1, ["cpu"] * 2)
        out["data_shape"] = (data.shape, data.data_index, data.spatial_index)
        try:
            make_mesh(4, 1, ["cpu"] * 4)
        except ValueError as e:
            out["too_big"] = str(e)
    return out


def _failing_rank():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise KeyError("rank one fails")
    return dist.get_rank()


@pytest.fixture(scope="module")
def ranks():
    """One launch per grid: 2 ranks (even, odd) and 4 (uneven, odd)."""
    out = {}
    for n in (2, 4):
        heights = sorted({h for m, hs in CASES.values() if m == n
                          for h in hs})
        out[n] = launch(_mesh_rank, n, ["cpu"] * n, "gloo", n, heights)
    return out


def test_make_mesh_shapes_and_assertion():
    import jax
    from tfpose_tpu.parallel.mesh import make_mesh as jax_mesh

    assert dict(jax_mesh(4, 2).shape) == {"data": 4, "spatial": 2}
    mesh = make_mesh(1, 1, ["cpu"])
    assert mesh.shape == {"data": 1, "spatial": 1} and mesh.world is None
    with pytest.raises(AssertionError, match="need 9x1 devices, have 8"):
        jax_mesh(9, 1)
    with pytest.raises(ValueError, match="need 9x1 devices, have 8"):
        make_mesh(9, 1, ["cpu"] * 8)
    with pytest.raises(ValueError, match="need 2x1 devices, have 0"):
        make_mesh(2, 1, [])
    with pytest.raises(ValueError, match="launch"):
        make_mesh(2, 1, ["cpu"] * 2)
    assert len(jax.devices()) == 8


def test_make_mesh_in_ranks(ranks):
    """Inside ``launch``: the grid, row-major coordinates, and a grid
    that does not cover the world raising."""
    for r, out in enumerate(ranks[2]):
        assert out["rank"] == r and out["shape"] == {"data": 1, "spatial": 2}
        assert out["data_shape"] == ({"data": 2, "spatial": 1}, r, 0)
        assert "in a world of 2 ranks" in out["too_big"]


def _jax_blocks(spatial_axis, keys_shapes):
    """{device index in the (4, 2) grid: {key: index tuple}} of JAX's
    shardings of a dict batch."""
    import jax.numpy as jnp
    from tfpose_tpu.parallel.mesh import make_mesh as jax_mesh
    from tfpose_tpu.parallel.mesh import shard_batch as jax_shard

    mesh = jax_mesh(4, 2)
    batch = {k: jnp.zeros(s) for k, s in keys_shapes.items()}
    with mesh:
        placed = jax_shard(mesh, batch, spatial_axis=spatial_axis)
    grid = list(np.asarray(mesh.devices).ravel())
    out = {}
    for k, a in placed.items():
        for dev, idx in a.sharding.devices_indices_map(a.shape).items():
            out.setdefault(grid.index(dev), {})[k] = idx
    return out


@pytest.mark.parametrize("spatial_axis", [1, None])
def test_shard_batch_blocks_equal_jax(spatial_axis):
    """Each of the 8 ranks' blocks are the slices of JAX's index maps;
    only ``SPATIAL_KEYS`` are split along the height."""
    shapes = {"image": (8, 16, 12, 3), "heat": (8, 2, 2, 19),
              "joints": (8, 4, 18, 2)}
    want = _jax_blocks(spatial_axis, shapes)
    batch = {k: np.arange(np.prod(s)).reshape(s) for k, s in shapes.items()}
    for r in range(8):
        got = shard_batch(Mesh(4, 2, r, torch.device("cpu")), batch,
                          spatial_axis=spatial_axis)
        for k, idx in want[r].items():
            np.testing.assert_array_equal(got[k], batch[k][idx], err_msg=k)
    assert SPATIAL_KEYS == ("image", "heat", "paf")


def test_shard_batch_spatial_keys_and_uneven_rows():
    """``joints`` rides the data axis alone; 46 rows over 4 spatial
    ranks are 12/12/11/11 and 5 images over 2 data ranks 3/2
    (``array_split``); tensors stay tensors."""
    batch = {"image": torch.zeros((5, 46, 8, 3)),
             "joints": np.zeros((5, 3, 18, 2))}
    rows = []
    for r in range(8):
        got = shard_batch(Mesh(2, 4, r, torch.device("cpu")), batch)
        assert torch.is_tensor(got["image"])
        assert got["joints"].shape[1:] == (3, 18, 2)
        rows.append((got["image"].shape[0], got["image"].shape[1],
                     got["joints"].shape[0]))
    assert rows == [(3, 12, 3), (3, 12, 3), (3, 11, 3), (3, 11, 3),
                    (2, 12, 2), (2, 12, 2), (2, 11, 2), (2, 11, 2)]
    assert row_bounds(33, 4) == [0, 9, 17, 25, 33]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("op", OPS)
def test_halo_exchange_matches_the_unsharded_op(ranks, op, case):
    n, heights = CASES[case]
    for out in ranks[n]:
        for h in heights:
            fwd, grad = out["errors"][h][op]
            assert fwd <= 1e-6, (op, case, h, out["rank"], fwd)
            assert grad <= 1e-6, (op, case, h, out["rank"], grad)


def test_collectives(ranks):
    for out in (o["collectives"] for o in ranks[2]):
        np.testing.assert_array_equal(
            out["whole"], np.repeat(np.arange(7, dtype=np.float32)[:, None],
                                    3, 1))
        np.testing.assert_array_equal(out["flags"], np.arange(7) > 2)
        np.testing.assert_array_equal(out["batch"]["image"],
                                      np.full((2, 3, 4, 3), 7, np.uint8))
        assert out["batch"]["joints"].dtype == np.float32
        assert out["end"] is None
        np.testing.assert_array_equal(out["weight"], np.zeros((2, 3)))
        assert "3 of 3 values differ between the 2 ranks" in out["mismatch"]


def test_launch_reraises_a_ranks_exception():
    from tfpose_tpu_torch.parallel.mesh import RankFailed

    with pytest.raises(KeyError, match="rank one fails") as info:
        launch(_failing_rank, 2, ["cpu"] * 2, "gloo", timeout=60)
    assert isinstance(info.value.__cause__, RankFailed)
    assert "_failing_rank" in str(info.value.__cause__)
    with pytest.raises(ValueError, match="backend"):
        launch(_failing_rank, 2, ["cpu"] * 2, "mpi")
