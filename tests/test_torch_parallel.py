"""Sharded forwards and the sharded train step of the port
(``parallel/``, ``models/layers.py`` under ``halo.use``,
``train/state.py:make_train_step(mesh=)``) against the JAX package's
mesh on its 8 virtual CPU devices (``tests/test_parallel.py``), from one
set of weights. The port runs 4 gloo ranks (one ``launch``) in two
grids, (2 x 2) and (1 x 4).

The networks are the registry's at their widths with two refinement
stages (``num_stages=2``: every op kind of the six-stage networks, CMU's
7x7 convs included, at a third of JAX's compile time), seeded weights
with BatchNorm statistics away from identity.

* Spatial forward (inference), ``concat_stage7`` gathered on every rank:
  - even: 48x48, B=4, (2 x 2) against JAX's (4 x 2) and against the
    port's unsharded forward;
  - uneven: 80x32, B=2, (1 x 4): 10 rows at stride 8 (3/3/2/2) and 5 at
    stride 16 (2/1/1/1), against JAX's (2 x 4);
  - odd: 33x32, B=2, (2 x 2): 5 rows at stride 8 (3/2), 3 at stride 16
    (2/1), against JAX's unsharded forward (JAX places no height that
    its shards do not divide);
  all within atol 2e-5 (``tests/test_parallel.py:105``; measured at
  most 1.5e-7 from JAX).
* One train step of thin at 32x32, B=8, lr 1e-4 (JAX's test): the
  (2 x 2) step against JAX's (4 x 2) step and the port's unsharded one:
  loss rtol 1e-5; BN running statistics rtol 1e-5 (atol 1e-7 for the
  means near 0); parameters atol 2.1e-4 (one Adam step moves each by
  +-lr, and an ulp can flip a noise-sized gradient's sign); gradients,
  read through Adam's first moment (``mu = 0.1 g``), within 0.15 of the
  largest (the rows of PERF.md's train step; fp32 gradients of this net
  are ill-conditioned); every rank's state equal bit for bit (checked
  in the ranks by ``assert_replicas_equal`` and here by digests).
  Measured against JAX: loss 2.0e-7, BN statistics 1.2e-7, parameters
  2.0e-4 (one lr step, sign flips), gradients 0.025 of the largest.
* The same step with ``--device-targets`` (joints rasterised for each
  rank's rows) against the unsharded one, loss rtol 1e-5 (measured
  1.1e-7), and in bf16 against the unsharded bf16 step, loss rtol 2e-3
  (measured 2.0e-4; bf16 noise: the sharded BatchNorm sums where the
  unsharded one means).

The rank bodies are top-level functions, and jax is imported inside the
functions that run JAX: a spawned rank imports this module.
"""

import hashlib
import sys

import numpy as np
import pytest
import torch

from tfpose_tpu_torch.convert.checkpoint import variables_to_numpy
from tfpose_tpu_torch.parallel.mesh import launch

torch.set_num_threads(2)

FORWARDS = {  # case: (grid, (H, W), B)
    "even": ((2, 2), (48, 48), 4),
    "uneven": ((1, 4), (80, 32), 2),
    "odd": ((2, 2), (33, 32), 2),
}
MODELS = ("mobilenet_thin", "mobilenet_v2_small", "cmu")
TRAIN_HW, TRAIN_B = 32, 8


def _net(name, dtype=torch.float32):
    """The port's two-stage network, seeded (the same in every process)."""
    from tfpose_tpu_torch.models.cmu import CmuNetwork
    from tfpose_tpu_torch.models.layers import init_weights
    from tfpose_tpu_torch.models.mobilenet import MobilenetNetwork
    from tfpose_tpu_torch.models.mobilenet_v2 import MobilenetV2Network

    net = {"mobilenet_thin": lambda: MobilenetNetwork(
               0.75, 0.50, num_stages=2, dtype=dtype),
           "mobilenet_v2_small": lambda: MobilenetV2Network(
               0.50, 0.50, num_stages=2, dtype=dtype),
           "cmu": lambda: CmuNetwork(num_stages=2, dtype=dtype)}[name]()
    g = torch.Generator().manual_seed(7)
    init_weights(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return net


def _images(case):
    (_, (h, w), b) = FORWARDS[case]
    rng = np.random.default_rng(len(case))
    return (rng.integers(0, 255, (b, h, w, 3)).astype(np.float32)
            / 256.0 - 0.5)


def _train_batch(joints=False):
    rng = np.random.default_rng(2)
    h = w = TRAIN_HW
    batch = {"image": rng.normal(size=(TRAIN_B, h, w, 3)).astype(np.float32)}
    if joints:
        j = rng.uniform(0, h // 8, (TRAIN_B, 3, 18, 2)).astype(np.float32)
        j[:, 2] = np.nan          # a padding person
        j[0, 0, 4] = np.nan       # a missing part
        batch["joints"] = j
    else:
        batch["heat"] = rng.normal(size=(TRAIN_B, h // 8, w // 8, 19)
                                   ).astype(np.float32)
        batch["paf"] = rng.normal(size=(TRAIN_B, h // 8, w // 8, 38)
                                  ).astype(np.float32)
    return batch


def _train_once(mesh, rasterize=False, dtype=torch.float32):
    """One step from the seeded thin; (loss, state as numpy, digest)."""
    from tfpose_tpu_torch.train.state import (
        TrainState, make_optimizer, make_train_step, replica_tensors)

    state = TrainState.create(_net("mobilenet_thin", dtype),
                              make_optimizer(1e-4))
    step = make_train_step(rasterize=rasterize, mesh=mesh)
    state, metrics = step(state, _train_batch(joints=rasterize))
    h = hashlib.sha256()
    for t in replica_tensors(state):
        h.update(t.detach().numpy().tobytes())
    out = {"loss": float(metrics["loss"]), "digest": h.hexdigest(),
           "variables": variables_to_numpy(state.net),
           "mu": {k: v.numpy().copy() for k, v in state.mu.items()}}
    return out


def _forward_sharded(mesh, name, x):
    """The sharded inference forward of ``x`` (global), gathered."""
    from tfpose_tpu_torch.parallel.halo import row_bounds
    from tfpose_tpu_torch.parallel.mesh import (
        gather_blocks, shard_batch, sharded)

    net = _net(name).eval()
    n, h, w = x.shape[:3]
    with torch.inference_mode(), sharded(mesh, image_hw=(h, w)):
        out = net(torch.from_numpy(shard_batch(mesh, x)))["concat_stage7"]
        out = gather_blocks(out, row_bounds(-(-h // 8), mesh.n_spatial),
                            mesh.spatial_index, mesh.spatial, dim=1)
        out = gather_blocks(out, row_bounds(n, mesh.n_data),
                            mesh.data_index, mesh.data)
    return out.numpy()


def _parallel_rank():
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    meshes = {grid: make_mesh(*grid, ["cpu"] * 4)
              for grid in ((2, 2), (1, 4))}
    out = {"forward": {}}
    for case, (grid, _, _) in FORWARDS.items():
        for name in MODELS:
            out["forward"][case, name] = _forward_sharded(
                meshes[grid], name, _images(case))
    out["train"] = _train_once(meshes[2, 2])
    out["train_targets"] = _train_once(meshes[2, 2], rasterize=True)
    out["train_bf16"] = _train_once(meshes[2, 2], dtype=torch.bfloat16)
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "tfpose_tpu"))
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_parallel_rank, 4, ["cpu"] * 4, "gloo")


def _jax_net(name):
    from tfpose_tpu.models.cmu import CmuNetwork
    from tfpose_tpu.models.mobilenet import MobilenetNetwork
    from tfpose_tpu.models.mobilenet_v2 import MobilenetV2Network

    return {"mobilenet_thin": lambda: MobilenetNetwork(
                conv_width=0.75, conv_width2=0.50, num_stages=2),
            "mobilenet_v2_small": lambda: MobilenetV2Network(
                conv_width=0.50, refine_width=0.50, num_stages=2),
            "cmu": lambda: CmuNetwork(num_stages=2)}[name]()


def _jax_forward(name, case):
    import jax
    import jax.numpy as jnp
    from tfpose_tpu.parallel.mesh import batch_sharding, make_mesh, replicated

    net = _jax_net(name)
    variables = variables_to_numpy(_net(name))
    x = jnp.asarray(_images(case))

    def fwd(v, x):
        return net.apply(v, x, train=False)["concat_stage7"]

    if case == "odd":
        return np.asarray(jax.jit(fwd)(variables, x))
    grid = {"even": (4, 2), "uneven": (2, 4)}[case]
    mesh = make_mesh(*grid)
    with mesh:
        return np.asarray(jax.jit(fwd)(
            jax.device_put(variables, replicated(mesh)),
            jax.device_put(x, batch_sharding(mesh, 1))))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("case", sorted(FORWARDS))
def test_spatial_forward_matches_jax(ranks, case, name):
    got = ranks[0]["forward"][case, name]
    for other in ranks[1:]:       # every rank holds the same maps
        np.testing.assert_array_equal(other["forward"][case, name], got)
    want = _jax_forward(name, case)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    if case == "even":
        with torch.inference_mode():
            single = _net(name).eval()(torch.from_numpy(_images(case)))
        np.testing.assert_allclose(
            got, single["concat_stage7"].numpy(), atol=2e-5, rtol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_step():
    """JAX's (4 x 2) train step from the port's starting tree."""
    import jax
    import jax.numpy as jnp
    from tfpose_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from tfpose_tpu.train.state import (
        TrainState, make_optimizer, make_train_step)

    net = _jax_net("mobilenet_thin")
    variables = variables_to_numpy(_net("mobilenet_thin"))
    tx = make_optimizer()
    step = make_train_step(net, tx)
    batch = {k: jnp.asarray(v) for k, v in _train_batch().items()}
    mesh = make_mesh(4, 2)
    with mesh:
        state = jax.device_put(TrainState.create(variables, tx),
                               replicated(mesh))
        state, metrics = jax.jit(step)(state,
                                       shard_batch(mesh, batch, 1))
    adam = state.opt_state[0]
    return {"loss": float(metrics["loss"]),
            "params": _flat(jax.tree.map(np.asarray, state.params)),
            "batch_stats": _flat(jax.tree.map(np.asarray,
                                              state.batch_stats)),
            "mu": _flat(jax.tree.map(np.asarray, adam.mu))}


@pytest.fixture(scope="module")
def single_steps():
    return {"fp32": _train_once(None),
            "targets": _train_once(None, rasterize=True),
            "bf16": _train_once(None, dtype=torch.bfloat16)}


def _mu_tree(mu):
    """The port's first moments as the flax params tree."""
    shadow = _net("mobilenet_thin")
    with torch.no_grad():
        for k, p in shadow.named_parameters():
            p.copy_(torch.from_numpy(mu[k]))
    return _flat(variables_to_numpy(shadow)["params"])


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_modules"] == [] for r in ranks)


def test_train_step_ranks_hold_equal_states(ranks):
    for key in ("train", "train_targets", "train_bf16"):
        assert len({r[key]["digest"] for r in ranks}) == 1, key


@pytest.mark.parametrize("against", ["jax_4x2", "port_unsharded"])
def test_train_step_2x2_matches(ranks, jax_step, single_steps, against):
    got = ranks[0]["train"]
    if against == "jax_4x2":
        want = jax_step
    else:
        one = single_steps["fp32"]
        want = {"loss": one["loss"],
                "params": _flat(one["variables"]["params"]),
                "batch_stats": _flat(one["variables"]["batch_stats"]),
                "mu": _mu_tree(one["mu"])}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    stats = _flat(got["variables"]["batch_stats"])
    assert stats.keys() == want["batch_stats"].keys()
    for k, v in want["batch_stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    params = _flat(got["variables"]["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=2.1e-4,
                                   err_msg=k)
    mu = _mu_tree(got["mu"])
    top = max(np.abs(v).max() for v in want["mu"].values())
    worst = max(np.abs(mu[k] - want["mu"][k]).max() for k in want["mu"])
    assert worst <= 0.15 * top


@pytest.mark.parametrize("key,rel", [("targets", 1e-5), ("bf16", 2e-3)])
def test_train_step_2x2_targets_and_bf16(ranks, single_steps, key, rel):
    got = ranks[0]["train_" + key]
    assert np.isfinite(got["loss"])
    assert got["loss"] == pytest.approx(single_steps[key]["loss"], rel=rel)
