"""The port's decode-parity sweep (``evaluation/parity_sweep.py``) and
its oracles (``oracle/numpy_post.py``, ``oracle/cpp/``) against the JAX
package's, on the CPU (the production decode runs the kernels' plain
versions here; ``tests/test_torch_cuda_paths.py`` runs the sweep on the
card).

* ``numpy_post``: every function bit for bit against JAX's copy;
* the C++ oracle, built by ``g++`` into ``tfpose_tpu_torch/_build/``,
  bit for bit against JAX's ``oracle.cpp.process_paf`` (the same
  source) on rendered scenes and an empty map;
* ``run_sweep(8, seed0=1000)``, one scene per recipe (ties, near
  thresholds, cap saturation with escalation), C++ on every default
  scene: 0 mismatches; each scene's humans equal to JAX's
  ``_jax_humans_adaptive`` on the same seed (parts and pixel coords
  exact, scores within 1e-5), escalating in the same scenes;
* ``run_ckpt_sweep(2, thin160_synth)`` through the port's thin with the
  committed checkpoint: 0 mismatches, the C++ oracle too;
* the module's CLI, and the sweep raising without a card by default.
"""

import os

import numpy as np
import pytest
import torch

from tfpose_tpu_torch.core.config import DecodeParams
from tfpose_tpu_torch.evaluation import parity_sweep
from tfpose_tpu_torch.oracle import numpy_post
from tfpose_tpu_torch.utils import synthetic

torch.set_num_threads(2)

SYNTH = os.path.join(os.path.dirname(__file__), "..", "models", "trained",
                     "thin160_synth", "params.msgpack")


def test_numpy_post_equals_jax_bit_for_bit():
    from tfpose_tpu.oracle import numpy_post as jax_post

    rng = np.random.default_rng(0)
    for a, b in ((46, 184), (23, 57), (54, 216), (7, 3)):
        np.testing.assert_array_equal(numpy_post.area_resize_weights(a, b),
                                      jax_post.area_resize_weights(a, b))
    for k, s in ((25, 3.0), (13, 2.0)):
        np.testing.assert_array_equal(numpy_post.gauss_kernel_1d(k, s),
                                      jax_post.gauss_kernel_1d(k, s))
        np.testing.assert_array_equal(numpy_post.gauss_kernel_2d(k, s),
                                      jax_post.gauss_kernel_2d(k, s))
    x = rng.normal(size=(20, 24, 3))
    np.testing.assert_array_equal(numpy_post.area_resize(x, 50, 37),
                                  jax_post.area_resize(x, 50, 37))
    np.testing.assert_array_equal(numpy_post.smooth(x), jax_post.smooth(x))
    np.testing.assert_array_equal(numpy_post.nms_peaks(x),
                                  jax_post.nms_peaks(x))
    net, _ = synthetic.render_scene(rng, 3, 46, 54, noise=0.01)
    for got, want in zip(numpy_post.full_post(net, 184, 216),
                         jax_post.full_post(net, 184, 216)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n_people,noise",
                         [(0, 1, 0.0), (2, 3, 0.01), (3, 6, 0.02)])
def test_cpp_oracle_equals_jax_bit_for_bit(seed, n_people, noise):
    from tfpose_tpu.oracle import cpp as jax_cpp
    from tfpose_tpu_torch.oracle import cpp

    rng = np.random.default_rng(seed)
    net, _ = synthetic.render_scene(rng, n_people, 46, 54, noise=noise)
    peaks, heat, paf = (a.astype(np.float32)
                        for a in numpy_post.full_post(net, 184, 216))
    got = cpp.process_paf(peaks, heat, paf)
    want = jax_cpp.process_paf(peaks, heat, paf)
    assert got[0].shape[0] >= 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert cpp.library_path().startswith(os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "tfpose_tpu_torch", "_build")))
    zeros = np.zeros((46, 54, 19), np.float32)
    parts, scores = cpp.process_paf(zeros, zeros,
                                    np.zeros((46, 54, 38), np.float32))
    assert parts.shape[0] == scores.shape[0] == 0


def test_cpp_oracle_without_gxx_raises(monkeypatch, tmp_path):
    from tfpose_tpu_torch.oracle import cpp

    monkeypatch.setattr(cpp, "_lib", None)
    monkeypatch.setattr(cpp, "_BUILD", str(tmp_path))
    monkeypatch.setattr(cpp.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        cpp.get_lib()


@pytest.fixture(scope="module")
def sweep():
    return parity_sweep.run_sweep(8, seed0=1000, cpp_every=1, device="cpu")


def test_run_sweep_has_no_mismatch(sweep):
    assert sweep.total == 8
    assert set(sweep.per_recipe) == set(parity_sweep.RECIPES)
    assert sweep.mismatch_total == 0, sweep.examples
    assert sweep.cpp_total == 7 and sweep.cpp_mismatch == 0, sweep.examples
    assert sweep.escalated >= 1          # the cap_saturated scene
    assert sweep.mean_px_deviation == 0.0


def _same(got, want):
    assert len(got) == len(want)
    for (gp, gs), (wp, ws) in zip(sorted(got, key=lambda h: -h[1]),
                                  sorted(want, key=lambda h: -h[1])):
        assert gp.keys() == wp.keys()
        assert abs(gs - ws) <= 1e-5
        for p in gp:
            assert gp[p][:2] == wp[p][:2]
            assert abs(gp[p][2] - wp[p][2]) <= 1e-5


def test_scene_humans_equal_jax(sweep):
    """Each recipe's scene through the port's decode and JAX's
    ``_jax_humans_adaptive``; the oracle caps the same way."""
    from tfpose_tpu.core.config import DecodeParams as JaxParams
    from tfpose_tpu.evaluation import parity_sweep as jax_sweep

    for idx, recipe in enumerate(parity_sweep.RECIPES):
        net, params = parity_sweep._scene(
            np.random.default_rng(1000 + idx), recipe)
        jnet, jparams = jax_sweep._scene(
            np.random.default_rng(1000 + idx), recipe)
        np.testing.assert_array_equal(net, jnet)
        assert params.max_peaks == jparams.max_peaks
        got, esc = parity_sweep._port_humans_adaptive(net, params, "cpu")
        want, jesc = jax_sweep._jax_humans_adaptive(
            jnet, JaxParams(max_peaks=jparams.max_peaks))
        assert esc == jesc, recipe
        _same(got, want)
    assert parity_sweep.DEFAULT == DecodeParams()


@pytest.mark.skipif(not os.path.exists(SYNTH),
                    reason="committed checkpoint missing")
def test_run_ckpt_sweep_on_the_committed_checkpoint():
    stats = parity_sweep.run_ckpt_sweep(2, SYNTH, seed0=50, cpp_every=1,
                                        device="cpu")
    assert stats.total == 2 and stats.per_recipe == {"ckpt_real": [2, 0]}
    assert stats.mismatch_total == 0, stats.examples
    assert stats.cpp_total == 2 and stats.cpp_mismatch == 0, stats.examples
    assert stats.dev_px_n > 0


def test_cli_and_the_card_by_default(capsys, monkeypatch):
    import json

    stats = parity_sweep.main(["2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["total"] == stats.total == 2 and out["mismatch_total"] == 0
    assert out["cpp_total"] == 1 and out["cpp_mismatch"] == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_sweep.run_sweep(1)
