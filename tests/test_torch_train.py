"""Single-card training of the port (``train/loss.py``,
``train/targets.py``, ``train/state.py``) against the JAX package's
``stage_l2_loss``, ``targets_jax`` and ``make_train_step`` on the CPU,
from one flax-initialised tree of mobilenet_thin at 32x32, B = 4.

Tolerances, measured on the CPU:

* the loss of one step: rtol 1e-5 (measured 9e-7);
* the gradients, read through Adam's moments after one step
  (``mu = 0.1 g``, ``nu = 0.001 g^2``): within 0.15 of the largest one
  (measured 0.12 and 0.12, at the first conv, whose gradient sums the
  backward of every BatchNorm after it). The fp32 gradient of this net
  is ill-conditioned (the fast variance E[x^2] - E[x]^2 of the
  BatchNorms over 64 values per channel at the 4x4 grid, gradients from
  1e-8 to 7e3): against an fp64 gradient of the same net the port's is
  off by 0.052 of that leaf's largest value and JAX's by 0.074;
* BatchNorm's running mean and variance after a step: within 1e-5
  (measured 1.9e-6); ``nn.BatchNorm2d``'s unbiased update would miss by
  1.2e-4;
* the parameters: Adam's first step moves each by ``lr * sign(g)``, so
  where a gradient is noise-sized its sign, and the step, can differ:
  every parameter within two steps per step taken, and fewer than 5 %
  of them different at all after one step (measured 1.7 %);
* later steps' losses: the parameters' differences above grow through
  the updates, to rtol 2e-3 by the third step at lr 1e-4 (measured
  1.4e-4 and 9.3e-4); Adam itself, fed the same gradients, equals
  optax within rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tfpose_tpu.models import get_network as jax_network
from tfpose_tpu.train.loss import stage_l2_loss as jax_loss
from tfpose_tpu.train.state import TrainState as JaxState
from tfpose_tpu.train.state import make_optimizer as jax_optimizer
from tfpose_tpu.train.state import make_train_step as jax_train_step
from tfpose_tpu.train.targets_jax import batch_targets as jax_targets
from tfpose_tpu_torch.cli import train as train_cli
from tfpose_tpu_torch.convert.checkpoint import (
    variables_from_numpy,
    variables_to_numpy,
)
from tfpose_tpu_torch.models import get_network
from tfpose_tpu_torch.train.loss import stage_l2_loss
from tfpose_tpu_torch.train.state import (
    TrainState,
    adam_update,
    make_optimizer,
    make_train_step,
)
from tfpose_tpu_torch.train.targets import (
    batch_targets,
    heatmap_targets,
    paf_targets,
)
from test_torch_quantize import _flat

torch.set_num_threads(2)

H = W = 32
B = 4


def test_stage_l2_loss_matches_jax():
    """Six stages of (paf, heat), fp32 and bf16 outputs: the loss and
    the last stage's two terms within rtol 1e-6, in fp32."""
    rng = np.random.default_rng(0)
    paf_gt = rng.normal(size=(2, 4, 5, 38)).astype(np.float32)
    heat_gt = rng.uniform(size=(2, 4, 5, 19)).astype(np.float32)
    stages = [(rng.normal(size=paf_gt.shape).astype(np.float32),
               rng.normal(size=heat_gt.shape).astype(np.float32))
              for _ in range(6)]
    for bf16 in (False, True):
        jst = [(jnp.asarray(p), jnp.asarray(q)) for p, q in stages]
        tst = [(torch.from_numpy(p), torch.from_numpy(q)) for p, q in stages]
        if bf16:
            jst = [(p.astype(jnp.bfloat16), q.astype(jnp.bfloat16))
                   for p, q in jst]
            tst = [(p.bfloat16(), q.bfloat16()) for p, q in tst]
        want = jax_loss(jst, jnp.asarray(paf_gt), jnp.asarray(heat_gt))[1]
        loss, got = stage_l2_loss(tst, torch.from_numpy(paf_gt),
                                  torch.from_numpy(heat_gt))
        assert loss.dtype == torch.float32 and got["loss"] is loss
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=1e-6), k


def _padded_joints(seed, n_people, max_people=5, h=10, w=14):
    rng = np.random.default_rng(seed)
    j = np.full((max_people, 18, 2), np.nan, np.float32)
    j[:n_people] = rng.uniform(0, max(h, w), (n_people, 18, 2))
    if n_people:
        j[0, 3] = np.nan          # a missing part
        j[n_people - 1, 2] = j[n_people - 1, 3]  # a zero-length limb
    return j


@pytest.mark.parametrize("case", ["people", "nan_padded_and_missing",
                                  "no_people"])
def test_targets_match_jax(case):
    """Heatmaps (sigma 1) and PAFs (threshold 1) of a batch of
    NaN-padded stride-8 joints against ``targets_jax``: within 1e-6
    (measured 1.2e-7); with no person a zero heat and PAF and a
    background of 1; the single-image functions equal the batch."""
    h, w = 10, 14
    counts = {"people": [3, 5], "nan_padded_and_missing": [1, 2],
              "no_people": [0, 0]}[case]
    joints = np.stack([_padded_joints(10 * i + len(case), n)
                       for i, n in enumerate(counts)])
    want = jax_targets(jnp.asarray(joints), h, w, sigma=1.0, threshold=1.0)
    got = batch_targets(torch.from_numpy(joints), h, w, sigma=1.0,
                        threshold=1.0)
    for k in ("heat", "paf"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    one = torch.from_numpy(joints[1])
    assert torch.equal(heatmap_targets(one, h, w), got["heat"][1])
    assert torch.equal(paf_targets(one, h, w), got["paf"][1])
    if case == "no_people":
        assert got["heat"][..., :18].max() == 0 and got["paf"].abs().max() == 0
        assert bool((got["heat"][..., 18] == 1).all())


@pytest.fixture(scope="module")
def start():
    """The flax-initialised thin tree (train=True init, as train.py)."""
    net = jax_network("mobilenet_thin")
    return net, jax.tree.map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=True))


def _batches(n, seed=0, **kw):
    gen = train_cli.synthetic_batches(B, (W, H), np.random.default_rng(seed),
                                      **kw)
    return [next(gen) for _ in range(n)]


def _run_both(start, batches, lr, rasterize=False):
    """Both packages' train steps over ``batches`` from ``start``:
    (JAX state, JAX losses, port state, port losses)."""
    jnet, variables = start
    tx = jax_optimizer(lr)
    jstate = JaxState.create(variables, tx)
    jstep = jax.jit(jax_train_step(jnet, tx, rasterize=rasterize))
    net = variables_from_numpy(get_network("mobilenet_thin"), variables)
    state = TrainState.create(net, make_optimizer(lr))
    step = make_train_step(rasterize=rasterize)
    jl, pl = [], []
    for batch in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, pm = step(state, batch)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    return jstate, jl, state, pl


def _moments(state, which):
    """The port's Adam moments as the flax params tree."""
    shadow = get_network("mobilenet_thin")
    with torch.no_grad():
        for k, p in shadow.named_parameters():
            p.copy_(getattr(state, which)[k])
    return _flat(variables_to_numpy(shadow)["params"])


def test_one_train_step_matches_jax(start):
    """One step at lr 1e-3: the loss, the gradients (through ``mu``),
    ``nu``, the BN running statistics and the parameters, within the
    tolerances of the module docstring."""
    lr = 1e-3
    jstate, jl, state, pl = _run_both(start, _batches(1), lr)
    assert pl[0] == pytest.approx(jl[0], rel=1e-5)
    assert state.step == int(jstate.step) == 1
    adam = jstate.opt_state[0]
    for which, ref in (("mu", adam.mu), ("nu", adam.nu)):
        got, want = _moments(state, which), _flat(jax.tree.map(np.asarray,
                                                               ref))
        top = max(np.abs(v).max() for v in want.values())
        worst = max(np.abs(got[k] - want[k]).max() for k in want)
        assert worst <= 0.15 * top, which
    got = variables_to_numpy(state.net)
    stats = _flat(got["batch_stats"])
    want = _flat(jax.tree.map(np.asarray, jstate.batch_stats))
    assert stats.keys() == want.keys()
    assert max(np.abs(stats[k] - want[k]).max() for k in want) <= 1e-5
    params = _flat(got["params"])
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    d = np.concatenate([np.abs(params[k] - want[k]).ravel() for k in want])
    assert d.max() <= 2 * lr * 1.001
    assert (d > 1e-6).mean() < 0.05


def test_three_train_steps_track_jax(start):
    """Three steps at lr 1e-4 (the trainer's default): the first loss
    rtol 1e-5, the next two rtol 2e-3; every parameter within two Adam
    steps per step taken; the BN running variances within 1e-2."""
    lr = 1e-4
    jstate, jl, state, pl = _run_both(start, _batches(3, seed=1), lr)
    assert pl[0] == pytest.approx(jl[0], rel=1e-5)
    assert pl[1:] == pytest.approx(jl[1:], rel=2e-3)
    got = variables_to_numpy(state.net)
    params = _flat(got["params"])
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    assert max(np.abs(params[k] - want[k]).max() for k in want) <= 6 * lr
    stats = _flat(got["batch_stats"])
    want = _flat(jax.tree.map(np.asarray, jstate.batch_stats))
    assert max(np.abs(stats[k] - want[k]).max() for k in want
               if k.endswith("/var")) <= 1e-2


class _Leaves(nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(
            rng.normal(size=(3, 4)).astype(np.float32)))
        self.b = nn.Parameter(torch.from_numpy(
            rng.normal(size=(5,)).astype(np.float32)))


def test_adam_matches_optax_on_the_same_gradients():
    """Four updates with the same gradients (one of them near zero, one
    exactly zero) and a staircase decay every 2 steps, so steps 3 and 4
    use lr * 0.33: parameters, ``mu`` and ``nu`` within rtol 1e-6 of
    ``optax.adam(exponential_decay(...))``; the learning rates equal
    optax's schedule in fp32."""
    rng = np.random.default_rng(3)
    net = _Leaves(rng)
    tx = make_optimizer(1e-2, decay_rate=0.33, decay_steps=2)
    state = TrainState.create(net, tx)
    otx = jax_optimizer(1e-2, decay_rate=0.33, decay_steps=2)
    # copies: a JAX array may share a NumPy array's memory, which the
    # port's in-place update would change under it
    params = {k: jnp.asarray(v.detach().numpy().copy())
              for k, v in net.named_parameters()}
    opt = otx.init(params)
    sched = optax.exponential_decay(1e-2, 2, 0.33, staircase=True)
    for i in range(4):
        grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
                 "b": rng.normal(size=(5,)).astype(np.float32) * 1e-9}
        grads["b"][0] = 0.0
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        assert np.float32(tx.learning_rate(state.step)) == \
            np.asarray(sched(i), np.float32)
        adam_update(state)
        state.step += 1
        upd, opt = otx.update({k: jnp.asarray(v) for k, v in grads.items()},
                              opt, params)
        params = optax.apply_updates(params, upd)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[k], rtol=1e-6)
        np.testing.assert_allclose(state.mu[k].numpy(), opt[0].mu[k],
                                   rtol=1e-6)
        np.testing.assert_allclose(state.nu[k].numpy(), opt[0].nu[k],
                                   rtol=1e-6)
