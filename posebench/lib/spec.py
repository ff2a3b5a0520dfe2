"""Where the harness finds its pieces, by name.

Every piece that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<name>.json``: the model, its weights, dtype, input size,
  upsample ratio, source, ``reduced``, ``assumed`` and the limits of the
  correctness comparison; optionally ``program`` (further keyword
  arguments of the program's estimator, such as ``quantize``),
  ``ratio_dtype`` (the precision in which the reference is worked out
  again for ``maps_rms_ratio``) and ``peak`` (the row of the table of
  peaks that ``mfu`` divides by; the dtype's by default);
* ``workloads/<name>.json``: the cell's configuration, entry point,
  batch, chips, scene pool, people per scene and how many images the
  check and calls the trace take; anything else (``loop``, an entry's
  own parameters) is the entry's to read and to refuse;
* ``entries/<entry>.py``: the code that drives one of the program's
  entry points (a ``run(cell)`` function);
* ``metrics/<name>.py``: a reader with ``read(ctx)`` that returns the
  metric's value, or None where it finds nothing to read;
* ``reference/archs/<model>.py``: the plain reference network of a
  configuration's ``model``: ``SKELETON`` (the name of its skeleton),
  ``convs()`` (every convolution, in the order the seeded weights are
  drawn), ``body(net, x)`` (the stride-8 maps, heat first, then PAF)
  and optionally ``LEAVES`` (parameter leaves of its own, such as a
  PReLU's slopes; ``reference/models.py:Leaf``);
* ``reference/skeletons/<name>.json``: a skeleton: the part count, the
  heat channels (the parts and the background), each limb's ``pairs``
  of parts and its x, y ``paf_channels``, and the ``redundant`` limbs,
  which join two humans' parts but never start a human.

A later change adds a configuration, a mix, a metric or a network with
its skeleton by adding files: the harness asks for the keys it reads
itself and passes every other key through to the entry that reads it.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

# the keys the harness itself reads; a file may hold more
WORKLOAD_KEYS = {"config", "entry", "batch", "chips", "scenes", "people",
                 "warmup_calls", "check_images", "trace_calls", "why"}
CONFIG_KEYS = {"model", "weights", "dtype", "input_wh", "upsample",
               "source", "reduced", "assumed", "limits", "why"}
SKELETON_KEYS = {"parts", "heat_channels", "pairs", "paf_channels",
                 "redundant"}
ARCH_NAMES = ("SKELETON", "convs", "body")
ARCHS = os.path.join("reference", "archs")


def check_name(name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"bad name {name!r}: a letter, digit or _ first, "
                         f"then at most 63 of letters, digits, _ . -")
    return name


def _load_json(kind: str, name: str, keys, root: str) -> Dict:
    path = os.path.join(root, kind, check_name(name) + ".json")
    with open(path) as f:
        doc = json.load(f)
    missing = keys - set(doc)
    if missing:
        raise ValueError(f"{path}: missing keys {sorted(missing)}")
    doc["name"] = name
    return doc


def workload(name: str, root: str = ROOT) -> Dict:
    doc = _load_json("workloads", name, WORKLOAD_KEYS, root)
    if doc["chips"] not in (1, 4):
        raise ValueError(f"workload {name}: chips must be 1 or 4")
    return doc


def config(name: str, root: str = ROOT) -> Dict:
    return _load_json("configs", name, CONFIG_KEYS, root)


def skeleton(name: str, root: str = ROOT) -> Dict:
    """``reference/skeletons/<name>.json``; ``reference/decode.py:
    skeleton`` makes it a ``Skeleton``."""
    return _load_json(os.path.join("reference", "skeletons"), name,
                      SKELETON_KEYS, root)


def names(kind: str, suffix: str, root: str = ROOT) -> List[str]:
    """The names of every piece of one kind (``workloads``, ``configs``,
    ``metrics``, ``entries``, ``reference/archs``)."""
    d = os.path.join(root, kind)
    return sorted(n[:-len(suffix)] for n in os.listdir(d)
                  if n.endswith(suffix) and not n.startswith("_"))


def _module(kind: str, name: str, root: str) -> ModuleType:
    path = os.path.join(root, kind, check_name(name) + ".py")
    modname = re.sub(r"[^A-Za-z0-9_]", "_", f"posebench_{kind}_{name}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, root: str = ROOT) -> ModuleType:
    """``entries/<name>.py``, as the module ``posebench.entries.<name>``:
    a mesh entry's rank function is pickled by its module path. An entry
    of another copy of the harness (``root``) is loaded from its file."""
    path = os.path.join(root, "entries", name + ".py")
    if not name.isidentifier() or not os.path.exists(path):
        raise ValueError(f"no entry {name!r} under {root}/entries")
    modname = f"posebench.entries.{name}"
    own = os.path.join(ROOT, "entries", name + ".py")
    if os.path.exists(own) and os.path.samefile(path, own):
        return importlib.import_module(modname)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT) -> ModuleType:
    mod = _module("metrics", name, root)
    if not UNIT.match(getattr(mod, "UNIT", "")):
        raise ValueError(f"metric {name}: bad UNIT {getattr(mod, 'UNIT')!r}")
    return mod


def arch(model: str, root: str = ROOT) -> ModuleType:
    """``reference/archs/<model>.py``, loaded once for each file, so
    that the weights drawn and the forward that reads them agree."""
    return _arch(os.path.abspath(root), check_name(model))


@functools.lru_cache(maxsize=None)
def _arch(root: str, model: str) -> ModuleType:
    mod = _module(ARCHS, model, root)
    missing = [a for a in ARCH_NAMES if not hasattr(mod, a)]
    if missing:
        raise ValueError(f"architecture {model}: no {', '.join(missing)}")
    return mod


def benchmark(root: str = ROOT) -> Dict:
    """``BENCHMARK.json`` beside the harness's folder."""
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)
