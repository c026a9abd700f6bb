"""The port's OpenCV-free drawing calls (`yolopoint_tpu_torch.data.raster`)
against `cv2`, bit for bit, over seeded sweeps on small canvases:

* `fill_poly` = `cv2.fillPoly` (int32 vertices): inside the canvas, off
  it, degenerate polygons (1 and 2 vertices, repeated and collinear ones);
* `ellipse` = `cv2.ellipse(..., 0, 360, color, -1)` in each of OpenCV's
  four vertex-step regimes (larger axis below 3, 3-9, 10-14, above 14),
  float angles, centres off the canvas;
* `line` = `cv2.line` at thicknesses 1, 2 and 3, end points on and off
  the canvas;
* `gaussian_blur` = `cv2.GaussianBlur((k, k), 0)` on uint8, k = 3..11, odd,
  even and tiny (1-pixel) images;
* `get_perspective_transform` = `cv2.getPerspectiveTransform` within 1e-12
  relative (it is bit-equal on this host).

Every case must be equal; no tolerance is applied to the pixels.
"""

import cv2
import numpy as np
import pytest

from yolopoint_tpu_torch.data import raster

CASES = 500


def canvas(rng, lo=1, hi=60):
    H, W = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
    return rng.integers(0, 256, (H, W)).astype(np.uint8)


def assert_same(want, got, what):
    diff = np.argwhere(want != got)
    assert not len(diff), f"{what}: {len(diff)} pixels differ, first {diff[:5].tolist()}"


@pytest.mark.parametrize("kind", ["inside", "off_canvas", "degenerate"])
def test_fill_poly(kind):
    rng = np.random.default_rng({"inside": 1, "off_canvas": 2, "degenerate": 3}[kind])
    for case in range(CASES):
        img = canvas(rng, 3)
        H, W = img.shape
        if kind == "inside":
            n = int(rng.integers(3, 9))
            pts = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], 1)
        elif kind == "off_canvas":
            n = int(rng.integers(3, 9))
            pts = np.stack([rng.integers(-20, W + 20, n), rng.integers(-20, H + 20, n)], 1)
        else:
            n = int(rng.integers(1, 5))
            pts = np.stack([rng.integers(-5, W + 5, n), rng.integers(-5, H + 5, n)], 1)
            if n > 2 and case % 2:
                pts[1] = pts[0]  # a repeated vertex
            if n > 2 and case % 3 == 0:
                pts[2] = 2 * pts[1] - pts[0]  # three collinear vertices
        pts = pts.astype(np.int32)
        col = int(rng.integers(0, 256))
        want, got = img.copy(), img.copy()
        cv2.fillPoly(want, [pts], col)
        raster.fill_poly(got, [pts], col)
        assert_same(want, got, f"fill_poly case {case} {pts.tolist()} on {img.shape}")


@pytest.mark.parametrize("axes_range", [(0, 3), (3, 10), (10, 15), (15, 40)])
def test_ellipse(axes_range):
    rng = np.random.default_rng(axes_range[0])
    for case in range(CASES):
        img = canvas(rng, 5)
        H, W = img.shape
        big = int(rng.integers(*axes_range))
        small = int(rng.integers(0, big + 1))
        axes = (big, small) if case % 2 else (small, big)
        center = (int(rng.integers(-10, W + 10)), int(rng.integers(-10, H + 10)))
        angle = float(rng.uniform(0, 360)) if case % 5 else float(rng.integers(-400, 800))
        col = int(rng.integers(0, 256))
        want, got = img.copy(), img.copy()
        cv2.ellipse(want, center, axes, angle, 0, 360, col, -1)
        raster.ellipse(got, center, axes, angle, col)
        assert_same(want, got, f"ellipse case {case} {center} {axes} {angle}")


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("where", ["inside", "off_canvas"])
def test_line(thickness, where):
    rng = np.random.default_rng(10 * thickness + (where == "inside"))
    for case in range(CASES):
        img = canvas(rng, 2)
        H, W = img.shape
        if where == "inside":
            p0 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            p1 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        else:
            p0 = (int(rng.integers(-30, W + 30)), int(rng.integers(-30, H + 30)))
            p1 = (int(rng.integers(-30, W + 30)), int(rng.integers(-30, H + 30)))
        if case % 17 == 0:
            p1 = p0  # a point
        col = int(rng.integers(0, 256))
        want, got = img.copy(), img.copy()
        cv2.line(want, p0, p1, col, thickness)
        raster.line(got, p0, p1, col, thickness)
        assert_same(want, got, f"line case {case} {p0} {p1} t={thickness} on {img.shape}")


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
def test_gaussian_blur(k):
    rng = np.random.default_rng(k)
    shapes = [(1, 1), (1, 7), (7, 1), (2, 3), (3, 2), (5, 5), (k, k + 1), (k - 1, 2 * k + 1)]
    shapes += [(int(rng.integers(1, 40)), int(rng.integers(1, 40))) for _ in range(60)]
    shapes += [(64, 80), (97, 131)]
    for shape in shapes:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        assert_same(cv2.GaussianBlur(img, (k, k), 0), raster.gaussian_blur(img, k),
                    f"blur k={k} on {shape}")


def test_gaussian_taps_sum_to_one():
    for k in (3, 5, 7, 9, 11):
        taps = raster.gaussian_taps(k)
        assert taps.sum() == 256 and np.array_equal(taps, taps[::-1])


def test_get_perspective_transform():
    rng = np.random.default_rng(0)
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for case in range(CASES):
        src = unit if case % 2 else rng.uniform(0, 100, (4, 2)).astype(np.float32)
        dst = rng.uniform(-50, 700, (4, 2)).astype(np.float32)
        want = cv2.getPerspectiveTransform(src, dst)
        got = raster.get_perspective_transform(src, dst)
        assert got.dtype == np.float64 and got.shape == (3, 3)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_sin_table_is_opencvs():
    """The table recovered from `cv2.ellipse2Poly` at a 2^30 radius."""
    r = 2 ** 30
    xs = cv2.ellipse2Poly((0, 0), (r, 0), 0, 0, 360, 1)[:, 0] / r   # SinTable[450 - i]
    ys = cv2.ellipse2Poly((0, 0), (0, r), 0, 0, 360, 1)[:, 1] / r   # SinTable[i]
    np.testing.assert_array_equal(raster.SIN_TABLE[:361], ys)
    np.testing.assert_array_equal(raster.SIN_TABLE[90:][::-1], xs)
