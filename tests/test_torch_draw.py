"""The port's drawing on colour images (`yolopoint_tpu_torch/data/raster.py`)
against OpenCV on the CPU, bit for bit, on seeded sweeps over 1- and
3-channel images, random backgrounds, float colours and shapes that leave
the image: `circle` (filled, `LINE_8`), `rectangle` (thickness 1 and 2),
`line_aa` (`cv2.line(..., LINE_AA)`), `circle(..., aa=True)`
(`cv2.circle(..., -1, LINE_AA)`), and `put_text` / `get_text_size`
(`cv2.putText` / `cv2.getTextSize` with `FONT_HERSHEY_SIMPLEX` at 0.5): the
text too is bit-equal, no tolerance. The committed glyph and colour tables
equal a fresh derivation (`tools/make_raster_tables.py`). Then the demo's
`draw_output` and the tracker's `draw_tracks` against the JAX package's, on
the same outputs and tracks."""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.frontend import demo as jax_demo
from yolopoint_tpu.frontend.tracker import PointTracker as JaxTracker
from yolopoint_tpu_torch.data import raster, raster_tables
from yolopoint_tpu_torch.frontend import demo
from yolopoint_tpu_torch.frontend.tracker import PointTracker

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FONT = cv2.FONT_HERSHEY_SIMPLEX
CHARS = [chr(c) for c in range(32, 127)]


def cases(seed, n=150):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        H, W = int(rng.integers(5, 60)), int(rng.integers(5, 90))
        shape = (H, W) if rng.random() < 0.3 else (H, W, 3)
        bg = rng.integers(0, 256, shape, dtype=np.uint8)
        if rng.random() < 0.2:
            bg[:] = rng.integers(0, 256)
        pts = [(int(rng.integers(-10, W + 10)), int(rng.integers(-10, H + 10))) for _ in range(2)]
        color = tuple(rng.uniform(0, 255, 3).tolist()) if len(shape) == 3 \
            else float(rng.uniform(0, 255))
        yield bg, pts, color, rng


DRAWS = {
    "circle": (lambda im, p, c, r: cv2.circle(im, p[0], r, c, -1),
               lambda im, p, c, r: raster.circle(im, p[0], r, c)),
    "rectangle_1": (lambda im, p, c, r: cv2.rectangle(im, p[0], p[1], c, 1),
                    lambda im, p, c, r: raster.rectangle(im, p[0], p[1], c, 1)),
    "rectangle_2": (lambda im, p, c, r: cv2.rectangle(im, p[0], p[1], c, 2),
                    lambda im, p, c, r: raster.rectangle(im, p[0], p[1], c, 2)),
    "line_aa": (lambda im, p, c, r: cv2.line(im, p[0], p[1], c, 1, cv2.LINE_AA),
                lambda im, p, c, r: raster.line_aa(im, p[0], p[1], c)),
    "circle_aa": (lambda im, p, c, r: cv2.circle(im, p[0], r, c, -1, cv2.LINE_AA),
                  lambda im, p, c, r: raster.circle(im, p[0], r, c, aa=True)),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_drawing_equals_cv2(name):
    ref_fn, port_fn = DRAWS[name]
    for i, (bg, pts, color, rng) in enumerate(cases(hash(name) % 1000)):
        r = 1 if i % 2 else int(rng.integers(0, 6))
        want, got = bg.copy(), bg.copy()
        ref_fn(want, pts, color, r)
        port_fn(got, pts, color, r)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {pts} r={r} {bg.shape}")


def test_scalar_is_opencvs():
    img3, img1 = np.zeros((1, 1, 3), np.uint8), np.zeros((1, 1), np.uint8)
    assert raster.scalar(img3, (127.5, 128.5, 300.0)).tolist() == [128, 128, 255]
    assert raster.scalar(img3, 200).tolist() == [200, 0, 0]  # a number is Scalar(n, 0, 0)
    assert raster.scalar(img1, -3.2) == 0


def test_text_equals_cv2():
    for bg, pts, color, rng in cases(5, n=300):
        text = "".join(rng.choice(CHARS, int(rng.integers(1, 16))))
        org = pts[0]
        want = bg.copy()
        cv2.putText(want, text, org, FONT, 0.5, color, 1)
        got = raster.put_text(bg.copy(), text, org, color)
        np.testing.assert_array_equal(got, want, err_msg=repr(text))
        assert raster.get_text_size(text) == cv2.getTextSize(text, FONT, 0.5, 1)
    assert raster.get_text_size("") == cv2.getTextSize("", FONT, 0.5, 1)


def test_tables_equal_a_fresh_derivation():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import make_raster_tables
    finally:
        sys.path.remove(str(REPO / "tools"))
    assert make_raster_tables.render() == Path(raster_tables.__file__).read_text()


def outputs(rng, H, W, n_kp=40, n_box=6):
    boxes = np.sort(rng.uniform(-10, max(H, W) + 10, (n_box, 2, 2)), axis=1)
    return {
        "keypoints": rng.uniform(-3, [W + 3, H + 3], (n_kp, 2)).astype(np.float32),
        "kp_valid": rng.random(n_kp) < 0.8,
        "kp_scores": rng.random(n_kp).astype(np.float32),
        "boxes": boxes.transpose(0, 2, 1).reshape(n_box, 4)[:, [0, 2, 1, 3]].astype(np.float32),
        "box_scores": rng.random(n_box).astype(np.float32),
        "box_classes": rng.integers(0, 3, n_box).astype(np.int32),
        "box_valid": rng.random(n_box) < 0.8,
    }


@pytest.mark.parametrize("names", [None, ["car", "pedestrian", "cyclist"]])
def test_draw_output_equals_jax(names):
    rng = np.random.default_rng(3)
    for H, W in ((96, 128), (40, 200), (150, 90)):
        frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        out = outputs(rng, H, W)
        np.testing.assert_array_equal(demo.draw_output(frame, out, names),
                                      jax_demo.draw_output(frame, out, names))


def test_draw_tracks_equals_jax():
    from tests.test_torch_tracker import frames

    mine, theirs = PointTracker(5, 0.7), JaxTracker(5, 0.7)
    rng = np.random.default_rng(9)
    drawn = 0
    for pts, desc in frames(seed=2, n=6):
        mine.update(pts, desc)
        theirs.update(pts, desc)
        bg = rng.integers(0, 256, (110, 110, 3), dtype=np.uint8)
        tracks = theirs.get_tracks(min_length=2)
        drawn += len(tracks)
        np.testing.assert_array_equal(mine.draw_tracks(bg.copy(), mine.get_tracks(2)),
                                      theirs.draw_tracks(bg.copy(), tracks))
    assert drawn > 50
