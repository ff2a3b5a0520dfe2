"""Skeleton rendering — reference ``TfPoseEstimator.draw_humans``
(``tf_pose/estimator.py:~230``): a circle at each part and a line for
each rendered pair of the human's skeleton, in its colours (COCO-18: 18
parts, 17 pairs, ``CocoColors``; BODY_25: 25 parts, 24 pairs, OpenPose's
colours).

Port of ``tfpose_tpu/utils/draw.py``, which draws with
``cv2.circle(img, c, 3, color, thickness=3)`` and
``cv2.line(img, p0, p1, color, 3)``. The port has no cv2, so this module
rasterises both as cv2 (5.0) does, in numpy, pixel for pixel:

* a thick circle is a 12-gon (vertices every 30 degrees, in 16-bit
  fixed point), each side drawn as a thick line: a 96-pixel ring of
  outer radius 5 whose centre pixel stays unpainted;
* a thick line is a filled quadrilateral two pixels either side of the
  segment (``FillConvexPoly``: its edges stepped in fixed point, then
  scanlines between them) plus a filled radius-2 circle (the midpoint
  algorithm) at each end. ``cv2.line`` first clips its end points to the
  image grown by 3 pixels; the circle's sides are not clipped.

Everything is clipped to the image where it is painted, and the parts
are painted in cv2's order (a human's circles, then its lines), so
overlaps take the same colour.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from tfpose_tpu_torch.core.types import Human

_SHIFT = 16                 # cv2's XY_SHIFT: fixed-point fraction bits
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1
_RADIUS = 3                 # cv2.circle(img, c, 3, color, thickness=3)
_THICK = 3                  # both calls' thickness
_LINE_MARGIN = 3            # cv2.line clips to the image grown by this

Point = Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    """Integer division truncated toward zero, as in C."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1: Point, p2: Point):
    """cv2's ``clipLine`` to [0, w-1] x [0, h-1], its offsets computed in
    double and truncated: (visible, p1, p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


class _Canvas:
    """A boolean mask of the pixels one primitive paints."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.mask = np.zeros((h, w), bool)

    def points(self, xs: np.ndarray, ys: np.ndarray) -> None:
        keep = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.mask[ys[keep], xs[keep]] = True

    def hline(self, y: int, x1: int, x2: int) -> None:
        if 0 <= y < self.h:
            x1, x2 = max(x1, 0), min(x2, self.w - 1)
            if x1 <= x2:
                self.mask[y, x1:x2 + 1] = True

    def edge(self, p1: Point, p2: Point) -> None:
        """A polygon edge between fixed-point points (cv2's ``Line2``):
        stepped one pixel along the major axis, the minor axis carried in
        fixed point."""
        ok, (x1, y1), (x2, y2) = _clip_line(self.w << _SHIFT,
                                            self.h << _SHIFT, p1, p2)
        if not ok:
            return
        dx, dy = x2 - x1, y2 - y1
        flat = abs(dx) > abs(dy)
        if (dx < 0) if flat else (dy < 0):
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx, dy = -dx, -dy
        major = abs(dx) if flat else abs(dy)
        minor_step = _cdiv((dy if flat else dx) << _SHIFT, major | 1)
        count = ((x2 - x1) if flat else (y2 - y1)) >> _SHIFT
        self.points(np.array([(x2 + _HALF) >> _SHIFT]),
                    np.array([(y2 + _HALF) >> _SHIFT]))
        k = np.arange(count + 1, dtype=np.int64)
        if flat:
            self.points(((x1 + _HALF) >> _SHIFT) + k,
                        (y1 + _HALF + k * minor_step) >> _SHIFT)
        else:
            self.points((x1 + _HALF + k * minor_step) >> _SHIFT,
                        ((y1 + _HALF) >> _SHIFT) + k)

    def convex_poly(self, v: List[Point]) -> None:
        """cv2's ``FillConvexPoly`` (8-connected, 16-bit fixed point):
        the edges, then the scanlines between the left and right edge."""
        n = len(v)
        p0 = v[-1]
        for p in v:
            self.edge(p0, p)
            p0 = p
        xs, ys = [p[0] for p in v], [p[1] for p in v]
        imin = ys.index(min(ys))
        xmin, xmax = (min(xs) + _HALF) >> _SHIFT, (max(xs) + _HALF) >> _SHIFT
        ymin, ymax = (min(ys) + _HALF) >> _SHIFT, (max(ys) + _HALF) >> _SHIFT
        if n < 3 or xmax < 0 or ymax < 0 or xmin >= self.w or ymin >= self.h:
            return
        ymax = min(ymax, self.h - 1)
        # per edge walker: [vertex index, direction, x, dx, y end]
        edges = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
        left = n
        y = ymin
        while True:
            for e in edges:
                if y < e[4]:
                    continue
                idx0, idx = e[0], (e[0] + e[1]) % n
                while True:
                    left -= 1
                    if left < 0:
                        break
                    ty = (v[idx][1] + _HALF) >> _SHIFT
                    if ty > y:
                        xs_, xe = v[idx0][0], v[idx][0]
                        step = _cdiv((xe - xs_) * 2 + (ty - y), 2 * (ty - y))
                        e[:] = [idx, e[1], xs_, step, ty]
                        break
                    idx0, idx = idx, (idx + e[1]) % n
            if left < 0:
                break
            if y >= 0:
                a, b = sorted((edges[0][2], edges[1][2]))
                x1, x2 = (a + _HALF) >> _SHIFT, (b + _HALF) >> _SHIFT
                if x2 >= 0 and x1 < self.w:
                    self.hline(y, x1, x2)
            edges[0][2] += edges[0][3]
            edges[1][2] += edges[1][3]
            y += 1
            if y > ymax:
                break

    def disk(self, cx: int, cy: int, radius: int) -> None:
        """cv2's filled ``Circle``: midpoint-algorithm spans."""
        err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
        while dx >= dy:
            for yy, xa, xb in ((cy - dy, cx - dx, cx + dx),
                               (cy + dy, cx - dx, cx + dx),
                               (cy - dx, cx - dy, cx + dy),
                               (cy + dx, cx - dy, cx + dy)):
                self.hline(yy, xa, xb)
            dy += 1
            err += plus
            plus += 2
            mask = -1 if err > 0 else 0
            err -= minus & mask
            dx += mask
            minus -= mask & 2

    def thick_segment(self, p0: Point, p1: Point, caps: int) -> None:
        """cv2's ``ThickLine`` at thickness 3 between fixed-point points:
        the quadrilateral, and a radius-2 disk at the ends set in
        ``caps`` (bit 0: p0, bit 1: p1)."""
        dx = (p0[0] - p1[0]) / _ONE
        dy = (p1[1] - p0[1]) / _ONE
        r2 = dx * dx + dy * dy
        half = (_THICK << (_SHIFT - 1)) + (_THICK & 1) * _ONE * 0.5
        if r2 > np.finfo(np.float64).eps:
            r = half / math.sqrt(r2)
            ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
            self.convex_poly([(p0[0] + ox, p0[1] + oy),
                              (p0[0] - ox, p0[1] - oy),
                              (p1[0] - ox, p1[1] - oy),
                              (p1[0] + ox, p1[1] + oy)])
        rad = ((_THICK << (_SHIFT - 1)) + _HALF) >> _SHIFT
        for bit, p in ((1, p0), (2, p1)):
            if caps & bit:
                self.disk((p[0] + _HALF) >> _SHIFT, (p[1] + _HALF) >> _SHIFT,
                          rad)


def _ring_offsets() -> List[Point]:
    """The fixed-point vertices of cv2's radius-3 circle polygon around
    the origin: ``ellipse2Poly`` every 30 degrees with cv2's float sine
    table (7 decimals), rounded, repeats dropped."""
    r = _RADIUS << _SHIFT
    out: List[Point] = []
    for deg in range(0, 361, 30):
        cos = float(np.float32(round(math.sin(math.radians(450 - deg)), 7)))
        sin = float(np.float32(round(math.sin(math.radians(deg)), 7)))
        p = (int(np.rint(r * cos)), int(np.rint(r * sin)))
        if not out or p != out[-1]:
            out.append(p)
    return out


_RING = _ring_offsets()


def _ring_pattern() -> Tuple[np.ndarray, np.ndarray]:
    """Pixel offsets of the ring drawn well inside an image."""
    c = _Canvas(32, 32)
    _circle(c, (16, 16))
    ys, xs = np.nonzero(c.mask)
    return ys - 16, xs - 16


def _circle(c: _Canvas, center: Point) -> None:
    """``cv2.circle(img, center, 3, color, thickness=3)``: the polygon's
    sides as thick segments, caps at both ends of the first and at the
    far end of each later one."""
    v = [((center[0] << _SHIFT) + ox, (center[1] << _SHIFT) + oy)
         for ox, oy in _RING]
    caps = 3
    for a, b in zip(v, v[1:]):
        c.thick_segment(a, b, caps)
        caps = 2


def _line(c: _Canvas, p0: Point, p1: Point) -> None:
    """``cv2.line(img, p0, p1, color, 3)``: end points clipped to the
    image grown by ``_LINE_MARGIN``, then one thick segment with both
    caps."""
    m = _LINE_MARGIN
    ok, a, b = _clip_line(c.w + 2 * m, c.h + 2 * m, (p0[0] + m, p0[1] + m),
                          (p1[0] + m, p1[1] + m))
    if ok:
        c.thick_segment(((a[0] - m) << _SHIFT, (a[1] - m) << _SHIFT),
                        ((b[0] - m) << _SHIFT, (b[1] - m) << _SHIFT), 3)


_RING_YX = _ring_pattern()


def _paint_circle(img: np.ndarray, center: Point, color) -> None:
    h, w = img.shape[:2]
    cx, cy = center
    reach = 8  # the ring's polygon stays this far inside: no clipping
    if reach <= cx < w - reach and reach <= cy < h - reach:
        ys, xs = _RING_YX
        img[ys + cy, xs + cx] = color
        return
    c = _Canvas(h, w)
    _circle(c, center)
    img[c.mask] = color


def draw_humans(npimg: np.ndarray, humans: List[Human],
                imgcopy: bool = False) -> np.ndarray:
    if imgcopy:
        npimg = np.copy(npimg)
    image_h, image_w = npimg.shape[:2]
    for human in humans:
        sk = human.skeleton
        centers = {}
        for i in range(sk.num_parts):
            if i not in human.body_parts:
                continue
            body_part = human.body_parts[i]
            center = (int(body_part.x * image_w + 0.5),
                      int(body_part.y * image_h + 0.5))
            centers[i] = center
            _paint_circle(npimg, center, _color(npimg, sk.colors[i]))
        for pair_order, pair in enumerate(sk.render_pairs):
            if pair[0] not in human.body_parts \
                    or pair[1] not in human.body_parts:
                continue
            c = _Canvas(image_h, image_w)
            _line(c, centers[pair[0]], centers[pair[1]])
            npimg[c.mask] = _color(npimg, sk.colors[pair_order])
    return npimg


def _color(img: np.ndarray, color) -> np.ndarray:
    return np.asarray(color, img.dtype)[:img.shape[2]]
