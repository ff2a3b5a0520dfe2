"""Import hygiene of the port: ``tfpose_tpu_torch`` and ``chip_smoke.py``
(also in the ranks that it spawns) load no jax, flax, optax, orbax,
msgpack, cv2, tensorboard, tensorflow, protobuf (``google``), lmdb or
``tfpose_tpu`` module, and the chip run refuses to start without a card
or outside a checkout."""

import ast
import os
import shutil
import subprocess
import sys


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


def test_chip_smoke_imports_are_clean():
    # every import statement in the script, at any depth
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in FORBIDDEN}
    assert {n.split(".")[0] for n in names} <= {
        "__future__", "contextlib", "json", "os", "subprocess", "sys",
        "time", "numpy", "torch", "tfpose_tpu_torch"}


def test_chip_smoke_fails_without_a_card():
    """Run under the guard with CUDA hidden: exit non-zero, no result."""
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


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _chip_smoke_rank_modules():
    """In a rank spawned by ``launch``: import ``chip_smoke.py`` as a
    spawned rank does (``__mp_main__``) and every port module that it
    names; return the forbidden modules loaded (a namespace package that
    site start-up put there has no file)."""
    import importlib
    import runpy

    path = os.path.join(ROOT, "chip_smoke.py")
    runpy.run_path(path, run_name="__mp_main__")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "tfpose_tpu_torch"):
            importlib.import_module(node.module)
    return sorted(name for name, mod in list(sys.modules.items())
                  if name.split(".")[0] in FORBIDDEN
                  and getattr(mod, "__file__", None) is not None)


def test_chip_smoke_ranks_import_nothing_forbidden():
    """Phase 11 spawns ranks; a spawned rank of ``launch`` that loads
    ``chip_smoke.py`` and the port modules it names loads none of the
    forbidden packages."""
    from tfpose_tpu_torch.parallel.mesh import launch

    assert launch(_chip_smoke_rank_modules, 2, ["cpu"] * 2, "gloo",
                  timeout=120) == [[], []]
