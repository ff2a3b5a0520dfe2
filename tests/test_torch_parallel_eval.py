"""The port's mesh at its entry points on the CPU: ``BatchedEvaluator``
with a mesh and ``tfpose-torch-train --mesh-data``, gloo ranks started
by ``launch``.

* ``BatchedEvaluator(mesh=)``: JAX's ``tests/test_sweep.py:25`` setup
  (thin at 96x80, batch 8, fp32, flax's initial weights, 8 noise images)
  with JAX on an (8 x 1) mesh and the port on (4 x 1): the detections
  equal; then ``thin160_coco`` on 6 rendered 160x160 scenes in batches
  of 4 (the tail padded), on (4 x 1) and on (2 x 2) with ``spatial``:
  every rank returns the unsharded evaluator's humans (parts exact,
  coords 1e-6, scores 1e-5), detections and ``last_peak_saturated``.
* ``tfpose-torch-train --mesh-data 2 --device cpu`` (two gloo ranks)
  for 2 steps against the single-process run: the first loss rtol 1e-5,
  the second rtol 2e-3 (measured 6.5e-4: the first Adam step moves a
  parameter the other way where its gradient's sign is noise, as in
  ``tests/test_torch_train.py``'s later steps), parameters within two
  Adam steps (2 x 2 lr); without cards, ``--mesh-data 2`` raises JAX's
  message.

The rank bodies are top-level functions that import no jax.
"""

import os

import numpy as np
import pytest
import torch

from tfpose_tpu_torch.parallel.mesh import launch

torch.set_num_threads(2)

THIN160 = os.path.join(os.path.dirname(__file__), "..", "models", "trained",
                       "thin160_coco", "params.msgpack")


def _noise_images(n, h, w):
    """``tests/test_sweep.py``'s images."""
    rng = np.random.default_rng(0)
    for i in range(n):
        yield i, rng.integers(0, 255, (h, w, 3), np.uint8), (w, h)


def _scenes(n, h, w, seed=17):
    from tfpose_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        people = synthetic.random_people(
            rng, int(rng.integers(1, 4)), h, w, separated=True,
            template=synthetic.SPREAD_TEMPLATE)
        out.append((100 + i, synthetic.render_image(people, h, w, rng),
                    (w, h)))
    return out


def _evaluate(mesh=None, spatial=False, variables=None):
    """(humans of the first batch, its ``last_peak_saturated``, all
    detections) of thin160_coco on the rendered scenes, or of
    ``variables`` on the noise images."""
    from tfpose_tpu_torch.convert.checkpoint import variables_from_numpy
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator

    kw = dict(mesh=mesh, spatial=spatial) if mesh else dict(device="cpu")
    if variables is not None:
        ev = BatchedEvaluator("mobilenet_thin", (96, 80), batch_size=8,
                              dtype="float32", **kw)
        variables_from_numpy(ev.net, variables)
        if mesh:
            from tfpose_tpu_torch.parallel.mesh import replicated
            replicated(mesh, ev.net)
        return ev.evaluate(_noise_images(8, 80, 96))
    ev = BatchedEvaluator("mobilenet_thin", (160, 160), batch_size=4,
                          dtype="float32", **kw)
    ev.load_params(THIN160)
    scenes = _scenes(6, 160, 160)
    humans = ev.run_batch(np.stack([img for _, img, _ in scenes[:4]]))
    saturated = ev.last_peak_saturated
    return humans, saturated, ev.evaluate(iter(scenes))


def _eval_rank(variables):
    from tfpose_tpu_torch.parallel.mesh import make_mesh

    data = make_mesh(4, 1, ["cpu"] * 4)
    grid = make_mesh(2, 2, ["cpu"] * 4)
    return {"jax_setup": _evaluate(data, variables=variables),
            "data": _evaluate(data),
            "data_spatial": _evaluate(grid, spatial=True)}


@pytest.fixture(scope="module")
def jax_setup():
    """JAX's evaluator on an (8 x 1) mesh and its initial variables."""
    import jax
    from tfpose_tpu.evaluation.sweep import BatchedEvaluator as JaxEvaluator
    from tfpose_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(n_data=8, n_spatial=1)
    ev = JaxEvaluator("mobilenet_thin", (96, 80), batch_size=8,
                      dtype="float32", mesh=mesh)
    with mesh:
        dets = ev.evaluate(_noise_images(8, 80, 96))
    return dets, jax.tree.map(np.asarray, ev.variables)


@pytest.fixture(scope="module")
def ranks(jax_setup):
    return launch(_eval_rank, 4, ["cpu"] * 4, "gloo", jax_setup[1])


def test_evaluator_on_a_mesh_matches_jax_test_sweep(ranks, jax_setup):
    # imported here: a spawned rank imports this module, and these
    # modules import jax
    from test_torch_api import _assert_same_detections as _same_detections

    want = jax_setup[0]
    for r in ranks:
        _same_detections(r["jax_setup"], want)
    single = _evaluate(variables=jax_setup[1])
    _same_detections(single, want)


@pytest.mark.parametrize("grid", ["data", "data_spatial"])
def test_evaluator_on_a_mesh_returns_the_single_device_list(ranks, grid):
    from test_torch_api import _assert_same_detections as _same_detections
    from test_torch_estimator import _assert_same_humans as _same_humans

    humans, saturated, dets = _evaluate()
    assert sum(len(h) for h in humans) >= 4 and len(dets) >= 6
    for r in ranks:
        got_humans, got_saturated, got_dets = r[grid]
        assert len(got_humans) == len(humans) == 4
        for g, w in zip(got_humans, humans):
            _same_humans(g, w)
        np.testing.assert_array_equal(got_saturated, saturated)
        _same_detections(got_dets, dets)


def test_evaluator_mesh_arguments():
    from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
    from tfpose_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="needs a mesh"):
        BatchedEvaluator("mobilenet_thin", (64, 64), device="cpu",
                         spatial=True)
    with pytest.raises(ValueError, match="smaller than the 4 data ranks"):
        BatchedEvaluator("mobilenet_thin", (64, 64), batch_size=2,
                         mesh=Mesh(4, 1, 0, torch.device("cpu")))


_ARGV = ["--input-size", "32x32", "--batchsize", "4", "--max-steps", "2",
         "--log-every", "1", "--synthetic", "--device", "cpu"]


def test_train_cli_mesh_data_2_matches_one_process():
    from tfpose_tpu_torch.cli import train as train_cli
    from tfpose_tpu_torch.convert.checkpoint import variables_to_numpy

    one = train_cli.main(_ARGV)
    two = train_cli.main(_ARGV + ["--mesh-data", "2"])
    assert two.step == one.step == 2
    l1 = [h["loss"] for h in one.history]
    l2 = [h["loss"] for h in two.history]
    assert l2[0] == pytest.approx(l1[0], rel=1e-5)
    assert l2[1] == pytest.approx(l1[1], rel=2e-3)
    a, b = variables_to_numpy(one.net), variables_to_numpy(two.net)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    d = max(np.abs(x - y).max() for x, y in zip(leaves(a["params"]),
                                                leaves(b["params"])))
    assert d <= 4e-4 * 1.001


def test_train_cli_mesh_without_cards_raises_jax_message(monkeypatch):
    from tfpose_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="need 2x1 devices, have 0"):
        train_cli.main(["--mesh-data", "2"])
    with pytest.raises(ValueError, match="need 1x2 devices, have 0"):
        train_cli.main(["--mesh-spatial", "2"])
