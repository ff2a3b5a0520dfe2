"""The benchmark's own tests (not collected by ``pytest tests/``):
``python -m pytest posebench/tests -q`` from the repository's root.
Tests marked ``cuda`` need a card and skip without one; on the card
(no jax there): ``python -m pytest posebench/tests -q -m cuda``."""

import json
import os
import shutil
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# one host thread, as in the benchmark's own runs (``run.py``): tests run
# side by side in several processes, and a full thread pool in each
# slows the traced and timed windows of the others many times over
torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips a test without a CUDA card (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")


@pytest.fixture
def repo_path():
    return lambda rel: os.path.join(REPO, rel)


def small_copy(tmp_path, edits=None):
    """A copy of ``BENCHMARK.json`` and ``posebench/``'s data files under
    ``tmp_path``, with ``edits`` {relative path: {key: value}} applied to
    its JSON files; returns the copy's ``posebench`` directory."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "posebench"), root / "posebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "models"), root / "models")
    for rel, change in (edits or {}).items():
        path = root / "posebench" / rel
        doc = json.loads(path.read_text())
        doc.update(change)
        path.write_text(json.dumps(doc))
    return str(root / "posebench")
