"""The port's skeleton drawing against the JAX package's, which draws
with cv2 (``tfpose_tpu/utils/draw.py``): pixel for pixel, on the same
``Human`` lists."""

import cv2
import numpy as np
import pytest

from tfpose_tpu.core.types import BodyPart as JaxBodyPart
from tfpose_tpu.core.types import Human as JaxHuman
from tfpose_tpu.utils.draw import draw_humans as jax_draw_humans
from tfpose_tpu_torch.core.types import BodyPart, Human
from tfpose_tpu_torch.utils import draw

WHITE = np.array([255, 255, 255], np.uint8)


def _humans(rng, n, border_share):
    """``n`` humans of the 18 parts, each part kept with p 0.8 at a
    uniform spot, or (with p ``border_share``) within 6 pixels of an edge
    of a 432x368 frame or just outside it. Returns the port's and the JAX
    package's lists."""
    ours, theirs = [], []
    for _ in range(n):
        parts = {}
        for i in range(18):
            if rng.random() > 0.8:
                continue
            x, y = rng.uniform(0, 1, 2)
            if rng.random() < border_share:
                side = rng.integers(4)
                off = rng.uniform(-6, 6) / (432 if side < 2 else 368)
                if side < 2:
                    x = (0 if side == 0 else 1) + off
                else:
                    y = (0 if side == 2 else 1) + off
            parts[i] = (float(x), float(y), float(rng.uniform(0.1, 1)))
        h, j = Human([]), JaxHuman([])
        for i, (x, y, s) in parts.items():
            h.body_parts[i] = BodyPart("", i, x, y, s)
            j.body_parts[i] = JaxBodyPart("", i, x, y, s)
        ours.append(h)
        theirs.append(j)
    return ours, theirs


@pytest.mark.parametrize("chunk", range(5))
def test_draw_humans_equals_the_cv2_reference(chunk):
    """50 seeded 432x368 frames (10 per case) of 3 humans, a quarter of
    the parts near or past the borders: every pixel equal."""
    rng = np.random.default_rng(100 + chunk)
    for _ in range(10):
        img = rng.integers(0, 256, (368, 432, 3), np.uint8)
        ours, theirs = _humans(rng, 3, border_share=0.25)
        want = jax_draw_humans(img, theirs, imgcopy=True)
        got = draw.draw_humans(img, ours, imgcopy=True)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()


def test_circle_equals_cv2_at_every_position_near_the_borders():
    """The ring of ``cv2.circle(r=3, thickness=3)``: 96 pixels inside the
    frame, and the clipped shapes (its sides' own clipping included) at
    every centre from 9 pixels outside to 9 inside each border."""
    h, w = 30, 34
    for cy in range(-9, h + 9):
        for cx in range(-9, w + 9):
            if 9 <= cx < w - 9 and 9 <= cy < h - 9 and (cx, cy) != (15, 15):
                continue
            want = np.zeros((h, w, 3), np.uint8)
            cv2.circle(want, (cx, cy), 3, (255, 255, 255), thickness=3)
            got = np.zeros((h, w, 3), np.uint8)
            draw._paint_circle(got, (cx, cy), WHITE)
            np.testing.assert_array_equal(got, want)
    inside = np.zeros((h, w, 3), np.uint8)
    draw._paint_circle(inside, (15, 15), WHITE)
    assert (inside[..., 0] > 0).sum() == 96 and inside[15, 15, 0] == 0


@pytest.mark.parametrize("seed", range(3))
def test_line_equals_cv2(seed):
    """``cv2.line(thickness=3)`` on 500 random segments, ends inside,
    near and outside the frame, short ones and points included."""
    h, w = 60, 70
    rng = np.random.default_rng(seed)
    for t in range(500):
        p0 = tuple(int(v) for v in rng.integers(-15, (w + 15, h + 15)))
        p1 = tuple(int(v) for v in rng.integers(-15, (w + 15, h + 15)))
        if t % 5 == 0:
            p1 = (p0[0] + int(rng.integers(-3, 4)),
                  p0[1] + int(rng.integers(-3, 4)))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.line(want, p0, p1, (255, 255, 255), 3)
        c = draw._Canvas(h, w)
        draw._line(c, p0, p1)
        np.testing.assert_array_equal(c.mask, want[..., 0] > 0)
