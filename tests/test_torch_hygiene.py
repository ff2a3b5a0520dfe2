"""Import hygiene of the port: ``tfpose_tpu_torch``, the card tests,
``tests/torch_cases.py`` (also in the ranks that the card tests spawn)
and ``chip_smoke.py`` load no jax, flax, optax, orbax, msgpack, cv2,
tensorboard, tensorflow, protobuf (``google``), lmdb or ``tfpose_tpu``
module; and the card tests skip only on a machine without a card."""

import ast
import glob
import os
import subprocess
import sys

import pytest


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "cv2",
             "tensorboard", "tensorflow", "google", "lmdb", "tfpose_tpu")

# Runs in a fresh interpreter: block the forbidden packages at import
# time, then run the payload and report what it loaded (site start-up
# may already hold namespace modules, e.g. ``google`` from a .pth file).
_GUARD = """
import sys
FORBIDDEN = {forbidden!r}
BEFORE = set(sys.modules)

class Guard:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("forbidden import: " + name)
        return None

sys.meta_path.insert(0, Guard())
sys.path.insert(0, {root!r})
{payload}
bad = sorted(m for m in set(sys.modules) - BEFORE
             if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print("CLEAN")
"""

_IMPORT_ALL = """
import importlib, pkgutil
import tfpose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tfpose_tpu_torch.__path__, "tfpose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), "modules")
"""


def _run(payload, cwd=ROOT, env=None):
    code = _GUARD.format(forbidden=FORBIDDEN, root=ROOT, payload=payload)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    out = _run(_IMPORT_ALL)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
    assert int(out.stdout.split()[0]) >= 25  # every module was imported


# the counterparts of the repo's tool scripts (scripts/broadcaster.py,
# visualization.py, sweep_backbones.py, profile_*.py)
TOOL_MODULES = ("tfpose_tpu_torch.cli.broadcaster",
                "tfpose_tpu_torch.cli.visualization",
                "tfpose_tpu_torch.evaluation.backbone_sweep",
                "tfpose_tpu_torch.profiles",
                "tfpose_tpu_torch.profiles.stages",
                "tfpose_tpu_torch.profiles.forward",
                "tfpose_tpu_torch.profiles.ops")


def test_tool_modules_import_nothing_forbidden():
    """The tools load no jax, no module of the JAX package and no cv2
    (the visualization client imports it in ``main`` only)."""
    out = _run("import importlib\n"
               f"for name in {TOOL_MODULES!r}:\n"
               "    importlib.import_module(name)\n")
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


# the only places the port may import cv2, inside these functions: the
# service's JPEG payload decode, the CLIs' file, video and window I/O
# (the visualization client's too),
# the training data's augmentations and PNG export, and the Datum
# records' PNG encode and decode
CV2_FUNCTIONS = {
    ("serving/service.py", "_decode_payload"),
    ("utils/imload.py", "_cv2"),
    ("cli/run.py", "main"),
    ("cli/run_video.py", "main"),
    ("cli/run_webcam.py", "main"),
    ("cli/visualization.py", "main"),
    ("train/augment.py", "random_scale"),
    ("train/augment.py", "random_rotation"),
    ("train/augment.py", "random_flip"),
    ("train/augment.py", "resize_shortest_edge"),
    ("train/augment.py", "random_crop"),
    ("train/augment.py", "resize_fixed"),
    ("train/coco_export.py", "write_synthetic_coco"),
    ("train/lmdb_dataset.py", "_png_encode"),
    ("train/lmdb_dataset.py", "_png_decode"),
}
# torch.utils.tensorboard: only the trainer's writer, with a log directory
TENSORBOARD_FUNCTIONS = {("train/summaries.py", "make_writer")}


def _cv2_import_sites(tree, module="cv2"):
    """The enclosing function's name (None at module level) of every
    import of ``module`` (cv2 by default) in a module's syntax tree."""
    sites = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom):
                names = [child.module or ""]
            else:
                names = []
            if any(n == module or n.startswith(module + ".")
                   for n in names):
                sites.append(func)
            visit(child, child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)

    visit(tree, None)
    return sites


def _port_import_sites(module):
    pkg = os.path.join(ROOT, "tfpose_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, pkg).replace(os.sep, "/")
                for func in _cv2_import_sites(ast.parse(open(path).read()),
                                              module):
                    assert func is not None, \
                        f"{rel} imports {module} at import"
                    found.add((rel, func))
    return found


def test_port_imports_cv2_only_inside_its_io_functions():
    """No module of the port imports cv2 at import time; the functions
    that do are the ones in ``CV2_FUNCTIONS``, and each still does."""
    assert _port_import_sites("cv2") == CV2_FUNCTIONS


def test_port_imports_tensorboard_only_inside_make_writer():
    """``torch.utils.tensorboard`` (which pulls in the tensorboard
    package, absent on the card machine) is imported only by the
    trainer's ``make_writer``, when a log directory is given."""
    assert _port_import_sites("torch.utils.tensorboard") == \
        TENSORBOARD_FUNCTIONS


# the card tests, their shared cases and the kernels' yardstick, run on
# a machine without jax
CARD_FILES = {os.path.basename(p): p for p in [
    os.path.join(ROOT, "tests", "torch_cases.py"),
    os.path.join(ROOT, "chip_smoke.py")] + sorted(glob.glob(os.path.join(
        ROOT, "tests", "test_torch_cuda*.py")))}


@pytest.mark.parametrize("name", CARD_FILES)
def test_card_tests_import_nothing_forbidden(name):
    """No import statement of the file, at any depth, names a forbidden
    root, and importing it loads no forbidden module."""
    path = CARD_FILES[name]
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert not {n for n in names if n.split(".")[0] in FORBIDDEN}
    out = _run(f"sys.path.insert(0, {os.path.dirname(path)!r})\n"
               f"import {name[:-3]}\n")
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def _card_rank_modules():
    """In a rank spawned by ``launch``: import ``torch_cases`` (whose
    ``rank_*`` bodies the card tests launch) and every port module that
    it names; return the forbidden modules loaded (a namespace package
    that site start-up put there has no file)."""
    import importlib

    import torch_cases

    for node in ast.walk(ast.parse(open(torch_cases.__file__).read())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "tfpose_tpu_torch"):
            importlib.import_module(node.module)
    return sorted(name for name, mod in list(sys.modules.items())
                  if name.split(".")[0] in FORBIDDEN
                  and getattr(mod, "__file__", None) is not None)


def test_card_test_ranks_import_nothing_forbidden():
    from tfpose_tpu_torch.parallel.mesh import launch

    assert launch(_card_rank_modules, 2, ["cpu"] * 2, "gloo",
                  timeout=120) == [[], []]


def test_chip_smoke_fails_without_a_card():
    """Run under the guard with CUDA hidden: exit 1, no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    payload = ("import runpy\n"
               "try:\n"
               "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
               "except SystemExit as e:\n"
               "    print('EXIT', e.code)\n")
    out = _run(payload, env=env)
    assert out.returncode == 0, out.stderr
    assert "EXIT 1" in out.stdout and '"ok"' not in out.stdout
    assert "CLEAN" in out.stdout


@pytest.mark.parametrize("node, reached, cards, wanted, outcome", [
    (False, False, 0, 1, "skip"),   # a machine without a card
    (True, False, 0, 1, "fail"),    # a card that torch cannot reach
    (True, True, 1, 1, "card"),
    (True, True, 1, 4, "skip"),     # the four-card file on one card
    (True, True, 4, 4, "card"),
])
def test_card_fixtures_skip_only_without_a_card(tmp_path, monkeypatch, node,
                                                reached, cards, wanted,
                                                outcome):
    """``torch_cases.card``, every card fixture's decision: a skip where
    the machine has no NVIDIA device node, a failure where it has one
    that torch does not reach, a skip below the cards a file needs."""
    import torch

    import torch_cases

    dev = tmp_path / "nvidiactl"
    if node:
        dev.touch()
    monkeypatch.setattr(torch_cases, "NVIDIA_DEVICE", str(dev))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: reached)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if outcome == "card":
        assert torch_cases.card(wanted) == torch.device("cuda:0")
    else:
        with pytest.raises(pytest.skip.Exception if outcome == "skip"
                           else pytest.fail.Exception):
            torch_cases.card(wanted)
