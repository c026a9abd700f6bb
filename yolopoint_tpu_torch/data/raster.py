"""OpenCV's drawing calls in numpy, bit for bit.

The JAX package draws with `cv2`; the machine that runs the port has no
OpenCV. The synthetic-shapes renderer's labels depend on its pixels (a
colour is picked from the mean of what is already drawn, a polygon is
rejected where it overlaps an earlier one), and the demo's and the
tracker's frames are compared with the JAX package's, so these functions
reproduce OpenCV's integer arithmetic (OpenCV 5, as this repo's tests hold
them) for uint8 (H, W) and (H, W, 3) images; `scalar` converts a colour as
`scalarToRawData` does:

* `fill_poly`      `cv2.fillPoly(img, [pts], color)`: the outline with
                   8-connected Bresenham lines, then the scanline edge
                   table in 16-bit fixed point (`FillEdgeCollection`);
* `ellipse`        `cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`:
                   `ellipse2Poly` (the angle rounded to whole degrees,
                   OpenCV's 7-digit sine table, a step of 90, 30, 18 or 5
                   degrees picked from the larger axis) in fixed point, then
                   the convex fill (`FillConvexPoly`);
* `line`           `cv2.line(img, p0, p1, color, thickness)`: thickness 1
                   is a Bresenham line clipped to the image; a thicker line
                   is clipped to the image grown by its thickness, then
                   drawn as a filled quad plus a filled disc at each end;
* `rectangle`      `cv2.rectangle(img, p1, p2, color, thickness)`: a closed
                   polyline of such segments, a disc at each one's end only;
* `circle`         `cv2.circle(img, c, r, color, -1)`, and with `aa` the
                   `LINE_AA` disc (`EllipseEx`'s polygon, the anti-aliased
                   `FillConvexPoly`);
* `line_aa`        `cv2.line(..., 1, cv2.LINE_AA)`: OpenCV's `LineAA`;
* `put_text`, `get_text_size`  `cv2.putText` / `cv2.getTextSize` with
                   `FONT_HERSHEY_SIMPLEX` at scale 0.5, thickness 1 (glyph
                   coverage from `raster_tables`);
* `gaussian_blur`  `cv2.GaussianBlur(img, (k, k), 0)` on uint8: OpenCV's
                   bit-exact path (8-bit fixed-point taps, the rows then the
                   columns, `BORDER_REFLECT_101`, rounded once at the end);
* `get_perspective_transform`  the 8x8 system in float64, solved by
                   OpenCV's partial-pivot LU.

Everything runs on the host.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np

from yolopoint_tpu_torch.data.raster_tables import GLYPHS, TEXT_HEIGHT

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1

# OpenCV's `SinTable`: sin of 0..450 whole degrees to 7 decimals, as float32
SIN_TABLE = np.round(np.sin(np.arange(451) * (math.pi / 180.0)), 7).astype(np.float32)


def _cdiv(a: int, b: int) -> int:
    """C integer division: truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(v: float) -> int:
    """`cvRound`: to nearest, ties to even."""
    return round(v)


def scalar(img: np.ndarray, color):
    """OpenCV's `scalarToRawData` for a uint8 image: each channel of
    `color` rounded to nearest (ties to even) and saturated; a number on a
    three-channel image is `(number, 0, 0)`, as a `cv::Scalar`."""
    vals = np.atleast_1d(np.asarray(color, np.float64))
    if img.ndim == 2:
        return int(np.clip(np.rint(vals[0]), 0, 255))
    channels = img.shape[2]
    vals = np.concatenate([vals, np.zeros(max(channels - len(vals), 0))])[:channels]
    return np.clip(np.rint(vals), 0, 255).astype(np.uint8)


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """`cv::clipLine` on a `width x height` frame: `(inside, x1, y1, x2, y2)`,
    the end points as OpenCV leaves them (moved also when the segment misses
    the frame)."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
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
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color: int) -> None:
    """OpenCV's `Line` (8-connected `LineIterator`, left to right)."""
    H, W = img.shape[:2]
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        inside, x1, y1, x2, y2 = clip_line(W, H, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    # minor-axis steps taken before point k: the count of negative errors of
    # `err = dx - 2 dy; err += -2 dy + (2 dx if err < 0)`, in closed form
    minor = -((dx - 2 * dy * k) // (2 * dx)) if dx else np.zeros_like(k)
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    img[ys, xs] = color


def _line2(img: np.ndarray, p1: tuple, p2: tuple, color: int) -> None:
    """OpenCV's `Line2`: the outline of a fixed-point (16-bit) segment."""
    H, W = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(W << XY_SHIFT, H << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    if ecount < 24:  # short edges (most of an ellipse's): plain Python beats numpy's overhead
        pts = [((x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT)]
        if ax > ay:
            pts += [((x1 >> XY_SHIFT) + k, (y1 + y_step * k) >> XY_SHIFT) for k in range(ecount + 1)]
        else:
            pts += [((x1 + x_step * k) >> XY_SHIFT, (y1 >> XY_SHIFT) + k) for k in range(ecount + 1)]
        for x, y in pts:
            if 0 <= x < W and 0 <= y < H:
                img[y, x] = color
        return
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = np.concatenate([[(x2 + _HALF) >> XY_SHIFT], (x1 >> XY_SHIFT) + k])
        ys = np.concatenate([[(y2 + _HALF) >> XY_SHIFT], (y1 + y_step * k) >> XY_SHIFT])
    else:
        xs = np.concatenate([[(x2 + _HALF) >> XY_SHIFT], (x1 + x_step * k) >> XY_SHIFT])
        ys = np.concatenate([[(y2 + _HALF) >> XY_SHIFT], (y1 >> XY_SHIFT) + k])
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    img[ys[inside], xs[inside]] = color


# `LineAA`'s tables: the slope correction and the 3-tap filter of
# `drawing.cpp`
SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
              203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
FILTER = (168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
          254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
          158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
          40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5)


def _line_aa(img: np.ndarray, p1: tuple, p2: tuple, color) -> None:
    """OpenCV's `LineAA` between 16-bit fixed-point ends. Each step along
    the major axis blends 3 pixels across it with the filter taps, scaled
    by the end-point correction; `ICV_PUT_POINT` moves each channel toward
    the colour by `a / 256` (rounded), and then once more. The pixels of one
    line are distinct, so they blend at once."""
    H, W = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(W << XY_SHIFT, H << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    major_x = ax > ay
    if major_x:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dy * XY_ONE, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        y1 += ((step * -(x1 & (XY_ONE - 1))) >> XY_SHIFT) + _HALF
        i, j = (x1 >> (XY_SHIFT - 7)) & 0x78, (x2 >> (XY_SHIFT - 7)) & 0x78
        pos, minor = x1 >> XY_SHIFT, y1
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _cdiv(dx * XY_ONE, ay | 1)
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        x1 += ((step * -(y1 & (XY_ONE - 1))) >> XY_SHIFT) + _HALF
        i, j = (y1 >> (XY_SHIFT - 7)) & 0x78, (y2 >> (XY_SHIFT - 7)) & 0x78
        pos, minor = y1 >> XY_SHIFT, x1
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    slope = 0x100 if slope & 0x20 else SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = [0, 0, (t1 >> 8) & 0x1FF, 0, ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
          ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF, slope]
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    limit, other = (W, H) if major_x else (H, W)
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    major = pos + k
    minor_k = minor + step * k
    corr = np.asarray(ep, np.int64)[np.minimum(k, 2) * 3 + np.minimum(ecount - k, 2)]
    dist = (minor_k >> (XY_SHIFT - 5)) & 31
    m = (minor_k >> XY_SHIFT) - 1
    filt = np.asarray(FILTER, np.int64)
    across = np.concatenate([m, m + 1, m + 2])
    along = np.tile(major, 3)
    a = (np.tile(corr, 3) * filt[np.concatenate([dist + 32, dist, 63 - dist])] >> 8) & 0xFF
    ok = (along >= 0) & (along < limit) & (across >= 0) & (across < other)
    xs, ys = (along[ok], across[ok]) if major_x else (across[ok], along[ok])
    a = a[ok]
    col = np.asarray(color, np.int64)
    d = img[ys, xs].astype(np.int64)
    if img.ndim == 3:
        a = a[:, None]
    for _ in range(2):
        d = d + (((col - d) * a + 127) >> 8)
    img[ys, xs] = d


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color: int) -> None:
    img[y, x1:x2 + 1] = color


def _fill_convex_poly(img: np.ndarray, v: Sequence[tuple], color, shift: int,
                      aa: bool = False) -> None:
    """OpenCV's `FillConvexPoly` for `LINE_8`, or `LINE_AA` where `aa`
    (vertices in `shift`-bit fixed point)."""
    H, W = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if aa:
            _line_aa(img, p0, p, color)
        elif shift == 0:
            _line8(img, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT, p[0] >> XY_SHIFT, p[1] >> XY_SHIFT,
                   color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    idx_ = [imin, imin]
    ye = [ymin, ymin]
    di = [1, npts - 1]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    edges = npts
    y = ymin
    delta1, delta2 = (XY_ONE - 1, 0) if aa else (_HALF, _HALF)
    while True:
        for i in range(2 if not aa or y < ymax or y == ymin else 0):
            if y >= ye[i]:
                idx0 = idx_[i]
                idx = idx0 + di[i]
                if idx >= npts:
                    idx -= npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx += di[i]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + delta1) >> XY_SHIFT
            xx2 = (ex[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, max(xx1, 0), min(xx2, W - 1), color)
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def _collect_poly_edges(img: np.ndarray, v: np.ndarray, color: int, edges: list) -> None:
    """OpenCV's `CollectPolyEdges` for shift 0 and `LINE_8`: draws the
    outline and appends the polygon's non-horizontal edges."""
    H, W = img.shape[:2]
    pt0 = (int(v[-1][0]) << XY_SHIFT, int(v[-1][1]))
    for px, py in v:
        pt1 = (int(px) << XY_SHIFT, int(py))
        t0 = [(pt0[0] + _HALF) >> XY_SHIFT, pt0[1]]
        t1 = [(pt1[0] + _HALF) >> XY_SHIFT, pt1[1]]
        _line8(img, t0[0], t0[1], t1[0], t1[1], color)
        c0, c1 = pt0, pt1
        if not (0 <= t0[0] < W and 0 <= t1[0] < W and 0 <= t0[1] < H and 0 <= t1[1] < H):
            # an edge that leaves the image: its slope from the clipped ends
            _, t0[0], t0[1], t1[0], t1[1] = clip_line(W, H, t0[0], t0[1], t1[0], t1[1])
            if t0[1] != t1[1]:
                c0, c1 = (t0[0] << XY_SHIFT, t0[1]), (t1[0] << XY_SHIFT, t1[1])
            else:  # clipped to a point or a row: the clipped columns, the edge's rows
                c0, c1 = (t0[0] << XY_SHIFT, pt0[1]), (t1[0] << XY_SHIFT, pt1[1])
        if pt0[1] != pt1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append(_Edge(pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx, dx))
            else:
                edges.append(_Edge(pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx, dx))
        pt0 = pt1


def _fill_edge_collection(img: np.ndarray, edges: list, color: int) -> None:
    """OpenCV's `FillEdgeCollection` (even-odd scanline fill of an edge table)."""
    H, W = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    y_max, y_min = -(1 << 31), (1 << 31) - 1
    x_max, x_min = -1, (1 << 63) - 1
    for e1 in edges:
        x1 = e1.x + (e1.y1 - e1.y0) * e1.dx
        y_min, y_max = min(y_min, e1.y0), max(y_max, e1.y1)
        x_min, x_max = min(x_min, e1.x, x1), max(x_max, e1.x, x1)
    if y_max < 0 or y_min >= H or x_max < 0 or x_min >= (W << XY_SHIFT):
        return
    edges.sort(key=lambda e: (e.y0, e.x, e.dx))
    tmp = _Edge(y0=(1 << 31) - 1)
    edges.append(tmp)
    i = 0
    tmp.next = None
    e = edges[i]
    y_max = min(y_max, H)
    for y in range(e.y0, y_max):
        draw = False
        clipline = y < 0
        prelast = tmp
        last = tmp.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last.next
                last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast = last
                last = last.next
            elif i < total:
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if not clipline:
                    # the pixels whose column lies between the two edges
                    lo, hi = sorted((keep_prelast.x, prelast.x))
                    x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT
                    if x1 < W and x2 >= 0:
                        _hline(img, y, max(x1, 0), min(x2, W - 1), color)
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x
        keep_prelast = None
        while True:
            prelast = tmp
            last = tmp.next
            last_exchange = None
            while last is not keep_prelast and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    last_exchange = prelast
                else:
                    prelast = last
                    last = te
            if last_exchange is None:
                break
            keep_prelast = last_exchange
            if keep_prelast is tmp.next or keep_prelast is tmp:
                break


def fill_poly(img: np.ndarray, polys: Sequence[np.ndarray], color: int) -> np.ndarray:
    """`cv2.fillPoly(img, polys, color)` on a uint8 (H, W) or (H, W, 3) image,
    in place; each polygon an (N, 2) int32 array of xy vertices."""
    color = scalar(img, color)
    edges: list = []
    for poly in polys:
        poly = np.asarray(poly, np.int64).reshape(-1, 2)
        if len(poly):
            _collect_poly_edges(img, poly, color, edges)
    _fill_edge_collection(img, edges, color)
    return img


def _circle_filled(img: np.ndarray, cx: int, cy: int, radius: int, color: int) -> None:
    """OpenCV's `Circle` with `fill`: horizontal spans of the midpoint circle."""
    H, W = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < H and xa < W and xb >= 0:
                _hline(img, yy, max(xa, 0), min(xb, W - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color,
                thickness: int, caps: tuple) -> None:
    """OpenCV's `ThickLine` for `LINE_8`, shift 0, thickness > 1: the segment
    clipped to the image grown by `thickness` on each side, a filled quad,
    and a filled disc at each end whose flag in `caps` is set."""
    H, W = img.shape[:2]
    t = thickness
    inside, x0, y0, x1, y1 = clip_line(W + 2 * t, H + 2 * t, x0 + t, y0 + t, x1 + t, y1 + t)
    if not inside:
        return
    x0, y0, x1, y1 = x0 - t, y0 - t, x1 - t, y1 - t
    q0 = (x0 << XY_SHIFT, y0 << XY_SHIFT)
    q1 = (x1 << XY_SHIFT, y1 << XY_SHIFT)
    dx, dy = float(x0 - x1), float(y1 - y0)
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (th + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        quad = [(q0[0] + dpx, q0[1] + dpy), (q0[0] - dpx, q0[1] - dpy),
                (q1[0] - dpx, q1[1] - dpy), (q1[0] + dpx, q1[1] + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    radius = (th + _HALF) >> XY_SHIFT
    for q, cap in zip((q0, q1), caps):
        if cap:
            _circle_filled(img, (q[0] + _HALF) >> XY_SHIFT, (q[1] + _HALF) >> XY_SHIFT, radius,
                           color)


def line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color,
         thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, thickness)` (`LINE_8`) on a uint8
    (H, W) or (H, W, 3) image, in place."""
    x0, y0, x1, y1 = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
    color = scalar(img, color)
    if thickness <= 1:
        _line8(img, x0, y0, x1, y1, color)
    else:
        _thick_line(img, x0, y0, x1, y1, color, thickness, (True, True))
    return img


def ellipse_poly(center: Sequence[float], axes: Sequence[float], angle: int,
                 delta: int) -> list:
    """OpenCV's `ellipse2Poly` (double version) over the full turn: the
    vertices as (x, y) floats."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    a = angle + (360 if angle < 0 else 0)
    beta, alpha = float(SIN_TABLE[a]), float(SIN_TABLE[450 - a])
    pts = []
    for i in range(0, 360 + delta, delta):
        t = min(i, 360)
        x = axes[0] * float(SIN_TABLE[450 - t])
        y = axes[1] * float(SIN_TABLE[t])
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center), tuple(center)]
    return pts


def _ellipse_vertices(cx: int, cy: int, aw: int, ah: int, angle: int) -> list:
    """`EllipseEx`'s fixed-point vertices of a full ellipse (centre and axes
    in 16-bit fixed point)."""
    delta = (max(aw, ah) + _HALF) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    prev = None
    for fx, fy in ellipse_poly((float(cx), float(cy)), (float(aw), float(ah)), angle, delta):
        px = _round(fx / XY_ONE) << XY_SHIFT
        py = _round(fy / XY_ONE) << XY_SHIFT
        pt = (px + _round(fx - px), py + _round(fy - py))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    return v


def ellipse(img: np.ndarray, center: Sequence[int], axes: Sequence[int], angle: float,
            color) -> np.ndarray:
    """`cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)` (a filled
    ellipse) on a uint8 (H, W) or (H, W, 3) image, in place."""
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    v = _ellipse_vertices(cx, cy, aw, ah, _round(angle))
    _fill_convex_poly(img, v, scalar(img, color), XY_SHIFT)
    return img


def _bitexact_gaussian(n: int) -> list[float]:
    """OpenCV's `getGaussianKernelBitExact` at sigma 0 (f64 values)."""
    fixed = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
    if n in fixed:
        return fixed[n]
    sigma = n * 0.15 + 0.35
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)][:half]
    total = sum(values) * 2.0 + 1.0
    mul = 1.0 / total
    out = [0.0] * n
    for i, t in enumerate(values):
        out[i] = out[n - 1 - i] = t * mul
    out[half] = mul
    return out


def gaussian_taps(k: int) -> np.ndarray:
    """The (k,) 8-bit fixed-point taps (sum 256) of `cv2.GaussianBlur` on
    uint8 at sigma 0: the bit-exact kernel rounded with error diffusion
    from the outside in, the centre tap taking the remainder."""
    kernel = _bitexact_gaussian(k)
    taps = [0] * k
    err, total = 0.0, 0
    for i in range(k // 2):
        adj = kernel[i] * 256.0 + err
        v0 = _round(adj)
        err = adj - v0
        taps[i] = taps[k - 1 - i] = v0
        total += v0
    taps[k // 2] = 256 - 2 * total
    return np.asarray(taps, np.int64)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source index of positions -r .. n-1+r under `BORDER_REFLECT_101`."""
    out = []
    for p in range(-r, n + r):
        if n == 1:
            out.append(0)
            continue
        while not 0 <= p < n:
            p = -p if p < 0 else 2 * (n - 1) - p
        out.append(p)
    return np.asarray(out, np.int64)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """`cv2.GaussianBlur(img, (k, k), 0)` on a uint8 (H, W) image (odd k)."""
    taps = gaussian_taps(k)
    r = k // 2
    H, W = img.shape
    src = img.astype(np.int64)
    cols = _reflect101(W, r)
    rows = _reflect101(H, r)
    padded = src[:, cols]
    tmp = sum(taps[j] * padded[:, j:j + W] for j in range(k))
    tmp = tmp[rows]
    acc = sum(taps[i] * tmp[i:i + H] for i in range(k))
    return np.minimum((acc + (1 << 15)) >> 16, 255).astype(np.uint8)


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """`cv2.getPerspectiveTransform(src, dst)` for (4, 2) float32 points: the
    (3, 3) float64 homography."""
    s = np.asarray(src, np.float32).reshape(4, 2)
    d = np.asarray(dst, np.float32).reshape(4, 2)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy, dx, dy = s[i, 0], s[i, 1], d[i, 0], d[i, 1]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        # the products are float32, as OpenCV computes them on `Point2f`
        a[i][6] = float(-sx * dx)
        a[i][7] = float(-sy * dx)
        a[i + 4][6] = float(-sx * dy)
        a[i + 4][7] = float(-sy * dy)
        b[i] = float(dx)
        b[i + 4] = float(dy)
    x = _lu_solve(a, b)
    return np.asarray(x + [1.0], np.float64).reshape(3, 3)


def _lu_solve(a: list, b: list) -> list:
    """OpenCV's `LUImpl` (partial pivoting, row operations `A[j] += alpha A[i]`
    with `alpha = -A[j][i] / A[i][i]` as a product), then back substitution."""
    m = len(a)
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 10:
            raise np.linalg.LinAlgError("singular perspective system")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return b


def line_aa(img: np.ndarray, p0: Sequence[int], p1: Sequence[int], color) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, 1, cv2.LINE_AA)` on a uint8 (H, W) or
    (H, W, 3) image, in place."""
    q0 = (int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT)
    q1 = (int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT)
    _line_aa(img, q0, q1, scalar(img, color))
    return img


def circle(img: np.ndarray, center: Sequence[int], radius: int, color,
           aa: bool = False) -> np.ndarray:
    """`cv2.circle(img, center, radius, color, -1)` (a filled circle,
    `LINE_8`), or with `aa` `cv2.circle(..., -1, cv2.LINE_AA)`: `EllipseEx`'s
    polygon filled by the anti-aliased `FillConvexPoly`. In place."""
    color = scalar(img, color)
    cx, cy = int(center[0]), int(center[1])
    if not aa:
        _circle_filled(img, cx, cy, int(radius), color)
        return img
    r = abs(int(radius)) << XY_SHIFT
    v = _ellipse_vertices(cx << XY_SHIFT, cy << XY_SHIFT, r, r, 0)
    _fill_convex_poly(img, v, color, XY_SHIFT, aa=True)
    return img


def rectangle(img: np.ndarray, p1: Sequence[int], p2: Sequence[int], color,
              thickness: int = 1) -> np.ndarray:
    """`cv2.rectangle(img, p1, p2, color, thickness)` (`LINE_8`, thickness
    >= 1): the closed polyline p1, (p2.x, p1.y), p2, (p1.x, p2.y), each
    segment a `ThickLine` with a disc at its end only. In place."""
    color = scalar(img, color)
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for a, b in zip(pts[-1:] + pts[:-1], pts):
        if thickness <= 1:
            _line8(img, a[0], a[1], b[0], b[1], color)
        else:
            _thick_line(img, a[0], a[1], b[0], b[1], color, thickness, (False, True))
    return img


# ---------------------------------------------------------------------------
# Text: `cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)`.
# OpenCV 5 draws it with an anti-aliased outline font; `raster_tables.GLYPHS`
# holds each printable ASCII glyph's coverage at that scale as OpenCV renders
# it (`tools/make_raster_tables.py`), drawn glyph by glyph at whole-pixel pen
# positions. A character outside printable ASCII is drawn and measured as "?".


@functools.lru_cache(maxsize=None)
def _glyph(ch: str) -> tuple:
    """`(advance, descent, dy, dx, coverage as an int64 (h, w) array)`."""
    code = ord(ch)
    advance, descent, dy, dx, h, w, cover = GLYPHS[code if 32 <= code < 127 else ord("?")]
    a = np.frombuffer(bytes.fromhex(cover), np.uint8).reshape(h, w).astype(np.int64)
    a.setflags(write=False)  # shared by every call
    return advance, descent, dy, dx, a


def get_text_size(text: str) -> tuple[tuple[int, int], int]:
    """`cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.5, 1)`: `((width,
    height), baseline)`."""
    if not text:
        return (0, 0), 0
    glyphs = [_glyph(c) for c in text]
    return (sum(g[0] for g in glyphs) + 1, TEXT_HEIGHT), max(g[1] for g in glyphs)


def put_text(img: np.ndarray, text: str, org: Sequence[int], color) -> np.ndarray:
    """`cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)` on a
    uint8 (H, W) or (H, W, 3) image, in place: each glyph's coverage `a`
    blends in as `(dst * (255 - a) + color * a + 127) // 255`."""
    col = np.asarray(scalar(img, color), np.int64)
    H, W = img.shape[:2]
    x, y = int(org[0]), int(org[1])
    for ch in text:
        advance, _, dy, dx, a = _glyph(ch)
        h, w = a.shape
        if h:
            y0, x0 = y + dy, x + dx
            ys, xs = slice(max(y0, 0), min(y0 + h, H)), slice(max(x0, 0), min(x0 + w, W))
            if ys.start < ys.stop and xs.start < xs.stop:
                a = a[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0]
                if img.ndim == 3:
                    a = a[..., None]
                d = img[ys, xs].astype(np.int64)
                img[ys, xs] = (d * (255 - a) + col * a + 127) // 255
        x += advance
    return img
