"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``tfpose_tpu_torch`` begins with ``tfpose_tpu``),
and the reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tfpose_tpu"}


def _loaded(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = """
import importlib
from posebench.lib import runner, spec
import posebench.calibrate
from tfpose_tpu_torch.evaluation.sweep import BatchedEvaluator
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.parallel.mesh import launch
for e in spec.names("entries", ".py"):
    spec.entry(e)
for m in spec.names("metrics", ".py"):
    spec.metric_reader(m)
"""
    loaded = _loaded(code)
    assert "tfpose_tpu_torch" in loaded and "posebench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("from posebench.reference import decode, models, "
                     "msgpack\nfrom posebench.lib import counts, scenes")
    assert "posebench" in loaded
    assert not loaded & (FORBIDDEN | {"tfpose_tpu_torch"}), loaded


def test_runner_flags_forbidden_modules_by_whole_name(monkeypatch):
    from posebench.lib import runner

    monkeypatch.setitem(sys.modules, "tfpose_tpu_torch_x", sys)
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tfpose_tpu.core", sys)
    assert runner.forbidden_modules() == ["tfpose_tpu"]
