"""The comparison that decides ``correct``.

For a sample of the images whose answers the window returned (drawn
from the seed among the calls that :class:`cell.Keeper` kept), two
numbers, each against the configuration's limit:

* ``maps_gap``: the backbone. The program's stride-8 maps of that call
  (taken by a forward hook on its network) against the plain fp32
  forward of ``reference/models.py`` on the same image and weights:
  max |program - reference| over the image's maps, over max |reference|.
  ``maps_rms_gap`` is the same comparison as a root mean square,
  ||program - reference|| / ||reference||. For a configuration that
  names a ``ratio_dtype`` (its own precision where that is below fp32,
  as bf16), ``maps_rms_ratio`` divides it by the gap of the reference
  itself computed in that precision on the same image and weights: how much further off than the stated precision alone the
  program is. Seeded weights differ in how far they carry rounding
  (bf16's gap is 0.008-0.014 over 16 seeds, int8's 0.043-0.070), and the
  ratio takes that out.
* ``humans_gap``: the decode. The humans the call returned against the
  reference decoder (``reference/decode.py``) run on the maps that the
  program decoded: 1 where the two differ in a human or a part's place
  (at the decode size), else the largest relative gap of a human's or a
  part's score, |a - b| / (1 + |b|).

The decode is checked from the program's own maps, step by step: a map
value within round-off of a threshold or of a tie would let two correct
forwards give different humans, so the decode is held to the maps it
was given and the forward to the reference by itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from posebench.lib import weights
from posebench.reference import decode as ref_decode
from posebench.reference import models as ref_models
from posebench.reference import msgpack

REF_BLOCK = 8   # images per reference forward


def reference_tree(cell, device) -> Dict:
    path = cell.weights_path()
    if path is None:
        return weights.seeded_tree(cell.config["model"], cell.seed, device)
    return ref_models.tree_to(msgpack.load_flax_msgpack(path), device)


def reference_maps(cell, scene_ids, device, tf32: bool = False,
                   dtype: torch.dtype = torch.float32
                   ) -> Dict[int, torch.Tensor]:
    """The reference's (h8, w8, 57) maps of each pool scene in
    ``scene_ids`` (computed in ``dtype``, returned as fp32), on
    ``device``, REF_BLOCK images at a time."""
    tree = reference_tree(cell, device)
    ids = sorted(set(scene_ids))
    out = {}
    for i in range(0, len(ids), REF_BLOCK):
        block = ids[i:i + REF_BLOCK]
        x = torch.as_tensor(np.stack([cell.pool[s] for s in block]),
                            device=device)
        maps = ref_models.forward(cell.config["model"], tree,
                                  ref_models.normalize(x), tf32=tf32,
                                  dtype=dtype)
        out.update(zip(block, maps))
    return out


def humans_gap(ref, out) -> float:
    """1 where the two human sets differ in a human or in the place of a
    part, else the largest relative score gap."""
    if len(ref) != len(out):
        return 1.0
    remaining = list(out)
    gap = 0.0
    for rparts, rscore in ref:
        hit = None
        for j, (oparts, _) in enumerate(remaining):
            if set(oparts) == set(rparts) and all(
                    oparts[p][:2] == rparts[p][:2] for p in rparts):
                hit = j
                break
        if hit is None:
            return 1.0
        oparts, oscore = remaining.pop(hit)
        gap = max(gap, abs(oscore - rscore) / (1 + abs(rscore)))
        for p in rparts:
            gap = max(gap, abs(oparts[p][2] - rparts[p][2])
                      / (1 + abs(rparts[p][2])))
    return gap


def sample(cell, kept: List[Dict]) -> List[tuple]:
    """(scene id, program maps (h8, w8, 57), program humans) of the
    images to compare: ``check_images`` of the kept calls' images,
    drawn from the seed."""
    items = [(s, m, h) for call in kept
             for s, m, h in zip(call["scenes"], call["maps"],
                                call["humans"])]
    rng = np.random.default_rng([cell.seed, 2])
    n = min(cell.workload["check_images"], len(items))
    pick = sorted(rng.choice(len(items), size=n, replace=False))
    return [items[i] for i in pick]


def compare(cell, items: List[tuple], ref: Dict[int, torch.Tensor],
            device, ref_low: Optional[Dict[int, torch.Tensor]] = None
            ) -> Dict[str, float]:
    """The numbers over ``items``; ``ref_low``, the reference in the
    configuration's precision where that is below fp32, adds
    ``maps_rms_ratio``."""
    out = {"maps_gap": 0.0, "maps_rms_gap": 0.0, "humans_gap": 0.0}
    if ref_low is not None:
        out["maps_rms_ratio"] = 0.0
    for s, maps, humans in items:
        prog = torch.as_tensor(np.asarray(maps, np.float32), device=device)
        r = ref[s].double()
        d = prog.double() - r
        rms = float(d.norm() / r.norm())
        out["maps_gap"] = max(out["maps_gap"],
                              float(d.abs().max() / r.abs().max()))
        out["maps_rms_gap"] = max(out["maps_rms_gap"], rms)
        if ref_low is not None:
            low = float((ref_low[s].double() - r).norm() / r.norm())
            out["maps_rms_ratio"] = max(out["maps_rms_ratio"], rms / low)
        want = ref_decode.decode(prog, cell.up_h, cell.up_w)
        out["humans_gap"] = max(out["humans_gap"], humans_gap(want, humans))
    return out


def low_precision(cell) -> Optional[torch.dtype]:
    """The configuration's ``ratio_dtype`` (a ``torch`` dtype's name),
    the precision ``maps_rms_ratio`` divides by; None without one."""
    name = cell.config.get("ratio_dtype")
    if name is None:
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"config {cell.config['name']}: ratio_dtype "
                         f"{name!r} is not a torch dtype")
    return dtype


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
