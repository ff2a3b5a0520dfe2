"""Bulk decode-parity sweep — port of
``tfpose_tpu/evaluation/parity_sweep.py``: the production decode against
the NumPy oracle (and against the C++ oracle on a subsample) over
randomized ADVERSARIAL scenes.

The production side is the port's ``ops/decode.py:decode_adaptive``, on
the card unless ``device="cpu"``: on the card that is the CUDA kernels
(the raw-grid smooth + NMS + top-K and the candidate scorer, and the
top-K again at the escalated K where a scene saturates its cap), so this
net holds them against the oracles on the inputs where a top-K tie
rule, a radix-select boundary or a threshold compare would go wrong.
The oracle side is the port's copies of the JAX package's oracles
(``oracle/numpy_post.py``, ``oracle/numpy_decoder.py``,
``oracle/cpp/``), on the host.

Recipes (cycled per scene index):
  clean            1-6 well-formed people
  noisy            plane noise up to 0.05
  dropped          parts dropped with prob up to 0.5
  crowd            7-10 overlapping people (merge-order stress)
  ties             heat quantized to 1/64 -> exact score ties
  near_heat        peaks scaled to hover at the NMS heat threshold
  near_paf         PAF magnitudes scaled to hover at criterion-1 edge
  cap_saturated    max_peaks=4 with 8 people: saturation triggers the
                   adaptive-K escalation (decode_adaptive), which is
                   then checked for full parity against the unbounded
                   oracle

Scenes on default params are optionally cross-checked against the C++
oracle (which hard-codes the reference thresholds).

    python -m tfpose_tpu_torch.evaluation.parity_sweep 1000 [--device cpu]
    python -m tfpose_tpu_torch.evaluation.parity_sweep --ckpt PARAMS 200
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tfpose_tpu_torch.core.config import DecodeParams

H8, W8 = 46, 54
UP_H, UP_W = H8 * 4, W8 * 4

DEFAULT = DecodeParams()
CAPPED = DecodeParams(max_peaks=4)


def _scene(rng: np.random.Generator, recipe: str
           ) -> Tuple[np.ndarray, DecodeParams]:
    from tfpose_tpu_torch.utils import synthetic

    if recipe == "clean":
        net, _ = synthetic.render_scene(rng, int(rng.integers(1, 7)),
                                        H8, W8)
        return net, DEFAULT
    if recipe == "noisy":
        net, _ = synthetic.render_scene(rng, int(rng.integers(1, 5)),
                                        H8, W8,
                                        noise=float(rng.uniform(0.005,
                                                                0.05)))
        return net, DEFAULT
    if recipe == "dropped":
        net, _ = synthetic.render_scene(rng, int(rng.integers(2, 5)),
                                        H8, W8,
                                        drop_prob=float(
                                            rng.uniform(0.1, 0.5)))
        return net, DEFAULT
    if recipe == "crowd":
        net, _ = synthetic.render_scene(rng, int(rng.integers(7, 11)),
                                        H8, W8, noise=0.01)
        return net, DEFAULT
    if recipe == "ties":
        net, _ = synthetic.render_scene(rng, int(rng.integers(2, 5)),
                                        H8, W8, noise=0.02)
        # quantize -> many exactly-tied peak scores; order-dependence
        # in top-K / greedy sorting surfaces here
        net = np.round(net * 64.0) / 64.0
        return net, DEFAULT
    if recipe == "near_heat":
        net, _ = synthetic.render_scene(rng, int(rng.integers(1, 4)),
                                        H8, W8, noise=0.01)
        # scale heat so peak maxima hover just above thresh_heat
        m = net[..., :19].max()
        if m > 0:
            net = net.copy()
            net[..., :19] *= (DEFAULT.thresh_heat
                              * float(rng.uniform(1.5, 3.0)) / m)
        return net, DEFAULT
    if recipe == "near_paf":
        net, _ = synthetic.render_scene(rng, int(rng.integers(1, 4)),
                                        H8, W8, noise=0.01)
        net = net.copy()
        # criterion 1 counts PAF samples above thresh; shrink magnitude
        # so sampled dot products straddle the threshold
        net[..., 19:] *= float(rng.uniform(0.15, 0.45))
        return net, DEFAULT
    if recipe == "cap_saturated":
        net, _ = synthetic.render_scene(rng, 8, H8, W8, noise=0.01)
        return net, CAPPED
    raise ValueError(recipe)


RECIPES = ("clean", "noisy", "dropped", "crowd", "ties", "near_heat",
           "near_paf", "cap_saturated")


def _cap_peaks(peaks: np.ndarray, k: int) -> np.ndarray:
    """Keep only the top-k peaks per part plane (score order), zeroing
    the rest. The oracle implements the reference's UNCAPPED dynamic
    peak lists; the production path's ``max_peaks`` cap keeps the top K
    by score, the lowest flat index first among equal scores. The sweep
    caps the oracle at the K the production path used (the escalated K
    where saturation escalated: 128, which no recipe's per-part
    population reaches)."""
    out = np.zeros_like(peaks)
    for p in range(peaks.shape[2]):
        plane = peaks[:, :, p]
        ys, xs = np.nonzero(plane > 0)
        if len(ys) > k:
            # nonzero() yields flat-ascending order; a STABLE sort on
            # -score keeps it within ties
            order = np.argsort(-plane[ys, xs], kind="stable")[:k]
            ys, xs = ys[order], xs[order]
        out[ys, xs, p] = plane[ys, xs]
    return out


def _oracle_humans(net, params, up_h=UP_H, up_w=UP_W):
    from tfpose_tpu_torch.oracle import numpy_decoder, numpy_post

    peaks, heat, paf = numpy_post.full_post(net, up_h, up_w)
    peaks = _cap_peaks(peaks, params.max_peaks)
    res = numpy_decoder.process_paf(peaks, heat, paf, params)
    humans = []
    for hi in range(res.parts.shape[0]):
        parts = {}
        for p in range(18):
            cid, x, y, s = res.parts[hi, p]
            if cid >= 0:
                parts[p] = (int(x), int(y), float(s))
        humans.append((parts, float(res.scores[hi])))
    return humans


def _device(device: Optional[str]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the parity sweep decodes on a CUDA card by "
                           "default and none is available; pass "
                           "device='cpu'")
    return dev


def _port_humans_adaptive(net, params, device, up_h=UP_H, up_w=UP_W):
    """Production decode with the host-side adaptive-K dispatch
    (``ops/decode.py:decode_adaptive``) on ``device``. Returns (humans,
    escalated): where a scene saturated the cap and escalated, the
    caller scores the oracle at the escalated cap."""
    from tfpose_tpu_torch.ops.decode import decode_adaptive

    x = torch.as_tensor(np.asarray(net, np.float32), device=device)
    out, escalated = decode_adaptive(x, up_h, up_w, params)
    coords, scores, pvalid, hscores, hvalid = (
        t.cpu().numpy() for t in (out.coords, out.part_scores,
                                  out.part_valid, out.human_scores,
                                  out.human_valid))
    humans = []
    for hi in range(coords.shape[0]):
        if not hvalid[hi]:
            continue
        parts = {}
        for p in range(18):
            if pvalid[hi, p]:
                parts[p] = (int(round(coords[hi, p, 0] * up_w)),
                            int(round(coords[hi, p, 1] * up_h)),
                            float(scores[hi, p]))
        humans.append((parts, float(hscores[hi])))
    return humans, escalated


def _cpp_humans(net, up_h=UP_H, up_w=UP_W):
    from tfpose_tpu_torch.oracle import cpp, numpy_post

    peaks, heat, paf = numpy_post.full_post(net, up_h, up_w)
    parts, scores = cpp.process_paf(peaks.astype(np.float32),
                                    heat.astype(np.float32),
                                    paf.astype(np.float32))
    humans = []
    for hi in range(parts.shape[0]):
        pd = {}
        for p in range(18):
            if parts[hi, p, 0] >= 0:
                pd[p] = (int(parts[hi, p, 1]), int(parts[hi, p, 2]),
                         float(parts[hi, p, 3]))
        humans.append((pd, float(scores[hi])))
    return humans


def compare(ref_humans, out_humans, tol_px: int = 0,
            tol_score: float = 1e-3, check_scores: bool = True
            ) -> Optional[str]:
    """None if the two human sets match; otherwise a short reason."""
    if len(ref_humans) != len(out_humans):
        return (f"count {len(ref_humans)} vs {len(out_humans)}")
    remaining = list(out_humans)
    for oparts, oscore in ref_humans:
        best = None
        for ji, (jparts, _) in enumerate(remaining):
            if set(jparts) != set(oparts):
                continue
            if all(abs(jparts[p][0] - oparts[p][0]) <= tol_px
                   and abs(jparts[p][1] - oparts[p][1]) <= tol_px
                   for p in oparts):
                best = ji
                break
        if best is None:
            return f"no match for human with parts {sorted(oparts)}"
        jparts, jscore = remaining.pop(best)
        if check_scores:
            # relative+absolute: the oracle accumulates in float64, the
            # device path in fp32; large crowd components accumulate
            # ~1e-3 relative fp32 error legitimately
            if abs(jscore - oscore) >= tol_score * (1 + abs(oscore)):
                return f"human score {jscore} vs {oscore}"
            for p in oparts:
                if (abs(jparts[p][2] - oparts[p][2])
                        >= tol_score * (1 + abs(oparts[p][2]))):
                    return f"part {p} score {jparts[p][2]} vs {oparts[p][2]}"
    return None


def pair_deviation(ref_humans, out_humans) -> Tuple[float, int]:
    """(sum of |d px|, #keypoint pairs) between two human sets, greedy-
    matched by mean part distance over shared parts: the mean keypoint
    deviation of the decode against the oracle, in px at the decode's
    resolution, over every part both decoders produced."""
    remaining = list(out_humans)
    dev_sum, n = 0.0, 0
    for rparts, _ in ref_humans:
        best_d, best_i = None, -1
        for ji, (jparts, _) in enumerate(remaining):
            shared = set(rparts) & set(jparts)
            if not shared:
                continue
            d = np.mean([np.hypot(rparts[p][0] - jparts[p][0],
                                  rparts[p][1] - jparts[p][1])
                         for p in shared])
            if best_d is None or d < best_d:
                best_d, best_i = d, ji
        if best_i < 0:
            continue
        jparts, _ = remaining.pop(best_i)
        for p in set(rparts) & set(jparts):
            dev_sum += float(np.hypot(rparts[p][0] - jparts[p][0],
                                      rparts[p][1] - jparts[p][1]))
            n += 1
    return dev_sum, n


@dataclasses.dataclass
class SweepStats:
    total: int = 0
    mismatches: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_recipe: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)  # recipe -> [n, n_mismatch]
    cpp_total: int = 0
    cpp_mismatch: int = 0
    examples: List[str] = dataclasses.field(default_factory=list)
    dev_px_sum: float = 0.0
    dev_px_n: int = 0
    escalated: int = 0

    @property
    def mismatch_total(self) -> int:
        return sum(self.mismatches.values())

    @property
    def mean_px_deviation(self) -> float:
        return (self.dev_px_sum / self.dev_px_n if self.dev_px_n
                else float("nan"))

    def as_dict(self):
        return dataclasses.asdict(self) | {
            "mismatch_total": self.mismatch_total,
            "mean_px_deviation": self.mean_px_deviation}

    def record(self, label: str, scene: int, ref, out) -> None:
        """One scene's production humans ``out`` against the oracle's."""
        reason = compare(ref, out)
        ds, dn = pair_deviation(ref, out)
        self.dev_px_sum += ds
        self.dev_px_n += dn
        self.total += 1
        n, bad = self.per_recipe.get(label, [0, 0])
        if reason is not None:
            self.mismatches[label] = self.mismatches.get(label, 0) + 1
            if len(self.examples) < 20:
                self.examples.append(f"scene {scene} [{label}]: {reason}")
        self.per_recipe[label] = [n + 1, bad + (reason is not None)]

    def record_cpp(self, label: str, scene: int, ref, cpph) -> None:
        """The C++ oracle against the NumPy oracle: structure, coords and
        human scores (its parts carry no score column compared here)."""
        self.cpp_total += 1
        r = compare(
            [({k: (v[0], v[1], 0.0) for k, v in p.items()}, s)
             for p, s in ref],
            [({k: (v[0], v[1], 0.0) for k, v in p.items()}, s)
             for p, s in cpph],
            tol_score=1e-4)
        if r is not None:
            self.cpp_mismatch += 1
            if len(self.examples) < 20:
                self.examples.append(f"scene {scene} [cpp/{label}]: {r}")


def run_sweep(n_scenes: int, seed0: int = 0, cpp_every: int = 0,
              progress=None, device: Optional[str] = None) -> SweepStats:
    """``n_scenes`` recipe scenes (recipe ``idx % 8``, seed
    ``seed0 + idx``) decoded on ``device`` against the oracle; with
    ``cpp_every``, every ``cpp_every``-th default-params scene against
    the C++ oracle too."""
    dev = _device(device)
    stats = SweepStats()
    for idx in range(n_scenes):
        recipe = RECIPES[idx % len(RECIPES)]
        rng = np.random.default_rng(seed0 + idx)
        net, params = _scene(rng, recipe)
        out, escalated = _port_humans_adaptive(net, params, dev)
        stats.escalated += escalated
        # where the production path escalated, the oracle is capped at
        # the escalated K: the reference's unbounded scan in practice
        ref = _oracle_humans(net,
                             params.escalated() if escalated else params)
        stats.record(recipe, seed0 + idx, ref, out)
        if cpp_every and idx % cpp_every == 0 and params is DEFAULT:
            stats.record_cpp(recipe, seed0 + idx, ref, _cpp_humans(net))
        if progress and (idx + 1) % 50 == 0:
            progress(idx + 1, stats)
    return stats


def run_ckpt_sweep(n_scenes: int, params_path: str,
                   input_wh: Tuple[int, int] = (160, 160),
                   seed0: int = 0, cpp_every: int = 0,
                   progress=None, device: Optional[str] = None
                   ) -> SweepStats:
    """Parity on trained network activations: rendered multi-person
    scene images forwarded through mobilenet_thin with the checkpoint
    ``params_path`` at ``input_wh`` on ``device``, their stride-8 maps
    decoded by the production path against the oracle (and the C++
    oracle every ``cpp_every``-th scene). Trained activations have
    structured, correlated peaks and PAFs, another distribution than the
    renderer's recipes."""
    from tfpose_tpu_torch.convert.checkpoint import (
        load_flax_msgpack, variables_from_numpy)
    from tfpose_tpu_torch.estimator import run_backbone
    from tfpose_tpu_torch.models import get_network
    from tfpose_tpu_torch.pipeline.preprocess import normalize
    from tfpose_tpu_torch.utils.synthetic import random_people, render_image

    dev = _device(device)
    w, h = input_wh
    h8, w8 = h // 8, w // 8
    up_h, up_w = h8 * 4, w8 * 4
    net = get_network("mobilenet_thin")
    variables_from_numpy(net, load_flax_msgpack(params_path))
    net.eval().to(dev)

    stats = SweepStats()
    for idx in range(n_scenes):
        rng = np.random.default_rng(seed0 + idx)
        people = random_people(rng, int(rng.integers(1, 5)), h, w)
        img = render_image(people, h, w, rng=rng, joint_radius=6)
        x = torch.as_tensor(img[None], device=dev)
        out = run_backbone(net, normalize(x))[0].cpu().numpy()
        got, escalated = _port_humans_adaptive(out, DEFAULT, dev, up_h, up_w)
        stats.escalated += escalated
        ref = _oracle_humans(
            out, DEFAULT.escalated() if escalated else DEFAULT, up_h, up_w)
        stats.record("ckpt_real", seed0 + idx, ref, got)
        if cpp_every and idx % cpp_every == 0:
            stats.record_cpp("ckpt_real", seed0 + idx, ref,
                             _cpp_humans(out, up_h, up_w))
        if progress and (idx + 1) % 20 == 0:
            progress(idx + 1, stats)
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="decode-parity sweep of the port against the oracles")
    parser.add_argument("n", type=int, nargs="?", default=200,
                        help="number of scenes")
    parser.add_argument("--ckpt", type=str, default="",
                        help="mobilenet_thin params.msgpack: sweep its "
                             "activations on rendered images instead")
    parser.add_argument("--input-size", type=str, default="160x160",
                        help="network input WxH of the --ckpt sweep")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    def progress(i, s):
        print(f"[{i}/{args.n}] mismatches={s.mismatch_total} "
              f"cpp={s.cpp_mismatch}/{s.cpp_total} "
              f"dev={s.mean_px_deviation:.4g}px/{s.dev_px_n}",
              file=sys.stderr)

    if args.ckpt:
        w, h = (int(v) for v in args.input_size.split("x"))
        stats = run_ckpt_sweep(args.n, args.ckpt, (w, h), cpp_every=10,
                               progress=progress, device=args.device)
    else:
        stats = run_sweep(args.n, cpp_every=10, progress=progress,
                          device=args.device)
    print(json.dumps(stats.as_dict(), indent=2))
    return stats


if __name__ == "__main__":
    main()
