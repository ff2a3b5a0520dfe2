"""The weights of a configuration, made or read once and handed alike
to the program and to the reference.

A configuration names either a checkpoint file of the repository (a
flax msgpack tree, which both sides read themselves: the program
through its own loader, the reference through its frozen reader) or
``"seeded"``: a tree drawn on the device from the run's seed
(``reference/models.py:random_tree``), which :func:`load_into` copies
into the program's network. The program's modules carry the flax module
names one to one, so a leaf's path names its tensor there; an
architecture's own leaves (its file's ``LEAVES``) name their suffix.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from posebench.lib import spec
from posebench.reference import models

# flax leaf -> the state-dict suffix of the program's module
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _leaves(tree: Dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def seeded_tree(model: str, seed: int, device,
                root: str = spec.ROOT) -> Dict:
    """The configuration's seeded weights, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return models.random_tree(model, gen, device, root)


def load_into(net: torch.nn.Module, tree: Dict, model: Optional[str] = None,
              root: str = spec.ROOT) -> None:
    """Copy a variables tree of tensors into ``net`` in place (conv
    kernels HWIO -> OIHW; ``model``'s architecture names its own
    leaves); raises where a leaf has no counterpart or a tensor of
    ``net`` is left unfilled."""
    suffix = dict(_LEAF)
    if model is not None:
        for leaf in getattr(spec.arch(model, root), "LEAVES", {}).values():
            suffix[(leaf.collection, leaf.name)] = leaf.suffix
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    filled = set()
    with torch.no_grad():
        for collection, sub in tree.items():
            for path, leaf in _leaves(sub):
                key = ".".join(path[:-1] + (suffix[(collection, path[-1])],))
                if key not in state:
                    raise KeyError(f"no {key} in {type(net).__name__}")
                if path[-1] == "kernel":
                    leaf = leaf.permute(3, 2, 0, 1)
                state[key].copy_(leaf)
                filled.add(key)
    missing = set(state) - filled
    if missing:
        raise KeyError(f"weights leave {len(missing)} tensors unfilled, "
                       f"e.g. {sorted(missing)[:3]}")
