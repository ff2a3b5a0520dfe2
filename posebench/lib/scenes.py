"""The traffic generator: rendered multi-person scenes.

A frozen copy of the program's scene renderer
(``tfpose_tpu_torch/utils/synthetic.py``: ``random_people``,
``render_image`` and the part palette, themselves the JAX package's),
which drew the scenes that the committed checkpoints were trained and
gated on: part-coloured joint discs and grey limbs on a dark noisy
background. :func:`scene_pool` draws a workload's pool of distinct
scenes from the run's seed; every seed gives the same sizes and the
same number of scenes, so seeds change the content and not the work's
shape.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

NUM_PARTS = 18
# (part a, part b) per limb (reference COCOPAIRS)
_PAIRS = np.array([
    [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
    [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
    [0, 15], [15, 17], [2, 16], [5, 17]])


def pairs_array() -> np.ndarray:
    return _PAIRS


# Canonical standing pose, (x, y) in a unit box, 18 parts in CocoPart order.
_TEMPLATE = np.array([
    [0.50, 0.10],  # Nose
    [0.50, 0.22],  # Neck
    [0.38, 0.22],  # RShoulder
    [0.34, 0.40],  # RElbow
    [0.32, 0.56],  # RWrist
    [0.62, 0.22],  # LShoulder
    [0.66, 0.40],  # LElbow
    [0.68, 0.56],  # LWrist
    [0.42, 0.55],  # RHip
    [0.41, 0.75],  # RKnee
    [0.40, 0.95],  # RAnkle
    [0.58, 0.55],  # LHip
    [0.59, 0.75],  # LKnee
    [0.60, 0.95],  # LAnkle
    [0.46, 0.07],  # REye
    [0.54, 0.07],  # LEye
    [0.42, 0.10],  # REar
    [0.58, 0.10],  # LEar
], dtype=np.float64)


# Learnability variant: same topology, but face parts spread far
# enough apart that they stay distinct at stride-8 resolution for
# small rendered people — used by the trainer and the e2e learning
# gate (the anatomical _TEMPLATE keeps the decode-parity goldens
# stable).
_SPREAD_TEMPLATE = _TEMPLATE.copy()
_SPREAD_TEMPLATE[0] = [0.50, 0.13]   # Nose
_SPREAD_TEMPLATE[14] = [0.40, 0.02]  # REye
_SPREAD_TEMPLATE[15] = [0.60, 0.02]  # LEye
_SPREAD_TEMPLATE[16] = [0.30, 0.08]  # REar
_SPREAD_TEMPLATE[17] = [0.70, 0.08]  # LEar
SPREAD_TEMPLATE = _SPREAD_TEMPLATE


def random_people(rng: np.random.Generator, n_people: int,
                  h: int, w: int, jitter: float = 0.02,
                  drop_prob: float = 0.0,
                  separated: bool = False,
                  template: np.ndarray | None = None) -> np.ndarray:
    """(n_people, 18, 2) float pixel coords; NaN marks dropped parts.

    ``separated=True`` places people in distinct vertical strips (the
    template is tall and narrow) so their peaks cannot merge — used by
    the hermetic eval gate, where accidental overlaps would look like
    decoder regressions."""
    base = _TEMPLATE if template is None else template
    people = []
    for i in range(n_people):
        scale = rng.uniform(0.35, 0.8)
        if separated:
            # person width ~= 0.36 * scale; keep it inside its strip
            scale = min(scale, 0.8 / (0.36 * max(n_people, 1)) / 2.4)
        pts = base.copy()
        pts = (pts - 0.5) * scale
        if separated:
            strip = (i + 0.5) / n_people
            cx = strip + rng.uniform(-0.25, 0.25) / n_people
            cy = rng.uniform(0.4, 0.6)
        else:
            cx = rng.uniform(0.25, 0.75)
            cy = rng.uniform(0.3, 0.7)
        pts[:, 0] = (pts[:, 0] + cx) * (w - 1)
        pts[:, 1] = (pts[:, 1] + cy) * (h - 1)
        pts += rng.normal(0.0, jitter * scale * min(h, w), pts.shape)
        pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
        pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
        if drop_prob > 0:
            drop = rng.uniform(size=NUM_PARTS) < drop_prob
            pts[drop] = np.nan
        people.append(pts)
    return np.stack(people) if people else np.zeros((0, NUM_PARTS, 2))


def _part_palette() -> np.ndarray:
    """(18, 3) uint8 — one well-separated colour per body part (HSV
    wheel), so rendered joints are visually distinguishable and a
    trained network can tell a nose from an ankle."""
    cols = []
    for i in range(NUM_PARTS):
        hue = i / NUM_PARTS * 6.0
        k = int(hue)
        f = hue - k
        p, q, t = 0.15, 1.0 - 0.85 * f, 0.15 + 0.85 * f
        rgb = [(1.0, t, p), (q, 1.0, p), (p, 1.0, t),
               (p, q, 1.0), (t, p, 1.0), (1.0, p, q)][k % 6]
        cols.append([int(c * 255) for c in rgb])
    return np.asarray(cols, np.uint8)


PART_PALETTE = _part_palette()


def render_image(people: np.ndarray, img_h: int, img_w: int,
                 rng: np.random.Generator | None = None,
                 joint_radius: int = 3, *,
                 background: tuple | None = None,
                 limb_color: tuple | int = 80,
                 limb_halfwidth: float = 1.0,
                 head_radius: int = 0,
                 head_color: tuple = (200, 176, 168)) -> np.ndarray:
    """Render a synthetic training/eval IMAGE (uint8 (H, W, 3)):
    part-colour-coded joint discs + grey limb segments on a dark
    noisy background. People coords are in image pixels.

    This is the supervised-learnable counterpart of the heatmap/PAF
    target renderers above: the joint colours make parts identifiable,
    the limb lines give the PAF branch direction evidence.

    The keyword-only style knobs default to the historical appearance
    (the committed checkpoints/golden fixtures depend on it, pixel for
    pixel); non-default values render the brighter "sample photo"
    style of ``images/p*.jpg`` (solid light background, thick limbs,
    big joint discs, a head disc) — see :func:`random_style`."""
    if background is not None:
        img = np.empty((img_h, img_w, 3), np.uint8)
        img[:] = np.asarray(background, np.uint8)
    elif rng is not None:
        img = rng.integers(0, 25, (img_h, img_w, 3)).astype(np.uint8)
    else:
        img = np.zeros((img_h, img_w, 3), np.uint8)
    pairs = pairs_array()

    def box(lo_x, hi_x, lo_y, hi_y, margin):
        # integer pixel window covering [lo - margin, hi + margin];
        # restricting the mask evaluation to it is exact (pixels
        # outside cannot satisfy the distance condition)
        x0 = max(0, int(np.floor(lo_x - margin)))
        x1 = min(img_w, int(np.ceil(hi_x + margin)) + 1)
        y0 = max(0, int(np.floor(lo_y - margin)))
        y1 = min(img_h, int(np.ceil(hi_y + margin)) + 1)
        if x0 >= x1 or y0 >= y1:
            return None
        yy, xx = np.mgrid[y0:y1, x0:x1]
        return (slice(y0, y1), slice(x0, x1)), yy, xx

    for person in people:
        # limbs (skip the redundant ear<->shoulder pairs 17, 18)
        for pid in range(17):
            a, b = person[pairs[pid][0]], person[pairs[pid][1]]
            if np.isnan(a[0]) or np.isnan(b[0]):
                continue
            d = b - a
            norm = np.hypot(d[0], d[1])
            if norm < 1e-6:
                continue
            win = box(min(a[0], b[0]), max(a[0], b[0]),
                      min(a[1], b[1]), max(a[1], b[1]), limb_halfwidth)
            if win is None:
                continue
            sl, yy, xx = win
            t = np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1])
                        / (norm * norm), 0.0, 1.0)
            dist = np.hypot(xx - a[0] - t * d[0], yy - a[1] - t * d[1])
            img[sl][dist <= limb_halfwidth] = limb_color
        if head_radius > 0:
            # head disc under the face parts (nose/eyes/ears), sample-
            # photo style; centred on the mean of the present ones
            face = person[[0, 14, 15, 16, 17]]
            face = face[np.isfinite(face[:, 0])]
            if len(face):
                cx, cy = face.mean(axis=0)
                win = box(cx, cx, cy, cy, head_radius)
                if win is not None:
                    sl, yy, xx = win
                    mask = ((xx - cx) ** 2 + (yy - cy) ** 2
                            <= head_radius ** 2)
                    img[sl][mask] = head_color
        for part in range(NUM_PARTS):
            px, py = person[part]
            if np.isnan(px):
                continue
            win = box(px, px, py, py, joint_radius)
            if win is None:
                continue
            sl, yy, xx = win
            mask = (xx - px) ** 2 + (yy - py) ** 2 <= joint_radius ** 2
            img[sl][mask] = PART_PALETTE[part]
    return img


def scene_pool(seed: int, n: int, w: int, h: int,
               people: Sequence[int] = (1, 3)) -> List[np.ndarray]:
    """``n`` distinct uint8 (h, w, 3) scenes of ``people[0]`` to
    ``people[1]`` people each (separated, ``SPREAD_TEMPLATE``: the
    trained checkpoints' held-out scenes), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(people[0], people[1] + 1))
        pts = random_people(rng, k, h, w, separated=True,
                            template=SPREAD_TEMPLATE)
        out.append(render_image(pts, h, w, rng))
    return out
