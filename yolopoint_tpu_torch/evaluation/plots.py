"""Validation reporting without matplotlib: PR/F1/P/R curves, the confusion
matrix, annotated image panels and match images, as PNG files.

Counterpart of `yolopoint_tpu/evaluation/plots.py`: the same entry points
write the same files under the same names. `draw_detections` is the JAX
function (pure numpy), bit for bit, and `plot_val_panel` writes its array
itself. The charts are drawn with `data/raster.py` on an RGB canvas of
`FIGURE` pixels: axes over the JAX figures' data ranges, one curve per class
in matplotlib's `tab10` cycle and the class mean thicker in blue, the JAX
figures' legend, tick and axis label strings in the `cv2.putText` font of
`raster.put_text`; the confusion matrix colours its cells by matplotlib's
`Blues` (`raster_tables.BLUES`, sampled from matplotlib) over 0 .. the
matrix's maximum, as `imshow` does, and prints the values above 0.005 where
there are at most 30 classes. `Axes.pixel` maps data coordinates to pixels,
so a test can find a curve where its data says.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

from yolopoint_tpu_torch.data import raster
from yolopoint_tpu_torch.data.png import write_png
from yolopoint_tpu_torch.data.raster_tables import BLUES, TAB10, TEXT_HEIGHT

FIGURE = (600, 900)          # curve figures: (height, width) pixels
MARGINS = (20, 20, 60, 70)   # top, right, bottom, left of the axes
WHITE, BLACK, BLUE = (255, 255, 255), (0, 0, 0), (0, 0, 255)
GREY = (128, 128, 128)
TICKS = np.linspace(0.0, 1.0, 6)


def _finish(canvas: np.ndarray, path: Path) -> None:
    """Write an RGB canvas as PNG."""
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.ascontiguousarray(canvas[..., ::-1]))


def _legend_names(classes: np.ndarray, names: Sequence[str]) -> list[str]:
    return [names[c] if c < len(names) else str(c) for c in classes]


def _text_width(text: str) -> int:
    return raster.get_text_size(text)[0][0]


def _put_text_rotated(canvas: np.ndarray, text: str, x: int, y: int, color) -> None:
    """`text` turned 90 degrees counter-clockwise (read bottom to top), its
    bounding box's top-left at (x, y)."""
    (w, h), base = raster.get_text_size(text)
    cover = np.zeros((h + base + 2, w), np.uint8)
    raster.put_text(cover, text, (0, h), 255)
    a = np.rot90(cover).astype(np.int64)
    H, W = canvas.shape[:2]
    ys, xs = slice(max(y, 0), min(y + a.shape[0], H)), slice(max(x, 0), min(x + a.shape[1], W))
    a = a[ys.start - y:ys.stop - y, xs.start - x:xs.stop - x, None]
    d = canvas[ys, xs].astype(np.int64)
    canvas[ys, xs] = (d * (255 - a) + np.asarray(color) * a + 127) // 255


def polyline(canvas: np.ndarray, pts: np.ndarray, color, thickness: int = 1) -> None:
    """Connect `(N, 2)` integer pixel points with straight segments (each
    sampled at one point per pixel of its longer side, rounded), widened to
    a `thickness` square brush; points outside the canvas are dropped."""
    pts = np.asarray(pts, np.int64)
    if len(pts) == 1:
        pts = np.concatenate([pts, pts])
    d = np.diff(pts, axis=0)
    steps = np.maximum(np.abs(d).max(axis=1), 1)
    seg = np.repeat(np.arange(len(d)), steps + 1)
    t = np.arange(len(seg)) - np.repeat(np.cumsum(steps + 1) - (steps + 1), steps + 1)
    frac = (t / steps[seg])[:, None]
    xy = np.rint(pts[seg] + d[seg] * frac).astype(np.int64)
    r0, r1 = -((thickness - 1) // 2), thickness // 2 + 1
    H, W = canvas.shape[:2]
    for oy in range(r0, r1):
        for ox in range(r0, r1):
            x, y = xy[:, 0] + ox, xy[:, 1] + oy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            canvas[y[ok], x[ok]] = color


class Axes:
    """A chart's axes on [0, 1] x [0, 1] inside `MARGINS` of a `FIGURE`
    canvas: the frame, ticks every 0.2 labelled "0.0" .. "1.0", and the
    axis labels."""

    def __init__(self, xlabel: str, ylabel: str):
        self.canvas = np.full((*FIGURE, 3), 255, np.uint8)
        top, right, bottom, left = MARGINS
        self.x0, self.x1 = left, FIGURE[1] - right - 1
        self.y0, self.y1 = top, FIGURE[0] - bottom - 1
        c = self.canvas
        raster.rectangle(c, (self.x0, self.y0), (self.x1, self.y1), BLACK)
        for v in TICKS:
            px, py = self.pixel(v, v)
            label = f"{v:.1f}"
            raster.line(c, (px, self.y1), (px, self.y1 + 5), BLACK)
            raster.put_text(c, label, (px - _text_width(label) // 2, self.y1 + 8 + TEXT_HEIGHT),
                            BLACK)
            raster.line(c, (self.x0 - 5, py), (self.x0, py), BLACK)
            raster.put_text(c, label, (self.x0 - 8 - _text_width(label), py + TEXT_HEIGHT // 2),
                            BLACK)
        raster.put_text(c, xlabel, ((self.x0 + self.x1 - _text_width(xlabel)) // 2,
                                    FIGURE[0] - 12), BLACK)
        _put_text_rotated(c, ylabel, 6, (self.y0 + self.y1 - _text_width(ylabel)) // 2, BLACK)

    def pixel(self, x, y):
        """Pixel column and row of data coordinates (scalars or arrays)."""
        px = np.rint(self.x0 + np.clip(x, 0, 1) * (self.x1 - self.x0)).astype(np.int64)
        py = np.rint(self.y1 - np.clip(y, 0, 1) * (self.y1 - self.y0)).astype(np.int64)
        return (int(px), int(py)) if np.ndim(px) == 0 else (px, py)

    def plot(self, x: np.ndarray, y: np.ndarray, color, thickness: int = 1) -> None:
        px, py = self.pixel(np.asarray(x, np.float64), np.asarray(y, np.float64))
        polyline(self.canvas, np.stack([px, py], axis=1), color, thickness)

    def legend(self, entries: Sequence[tuple[str, tuple, int]]) -> None:
        """Entries `(label, colour, thickness)` in a framed box at the lower
        left of the axes."""
        if not entries:
            return
        row = TEXT_HEIGHT + 6
        w = max(_text_width(label) for label, _, _ in entries) + 50
        h = row * len(entries) + 8
        bx0, by1 = self.x0 + 10, self.y1 - 10
        by0 = max(by1 - h, self.y0 + 1)
        self.canvas[by0:by1, bx0:bx0 + w] = WHITE
        raster.rectangle(self.canvas, (bx0, by0), (bx0 + w, by1), GREY)
        for i, (label, color, thick) in enumerate(entries):
            yc = by0 + 4 + row * i + row // 2
            if yc + TEXT_HEIGHT // 2 > by1:
                break
            polyline(self.canvas, np.array([[bx0 + 8, yc], [bx0 + 36, yc]]), color, thick)
            raster.put_text(self.canvas, label, (bx0 + 44, yc + TEXT_HEIGHT // 2 - 2), BLACK)


def class_color(ci: int) -> tuple:
    """The `ci`-th colour of matplotlib's default cycle (`tab10`)."""
    return TAB10[ci % len(TAB10)]


def plot_pr_curves(
    curves: Mapping[str, np.ndarray],
    names: Sequence[str],
    directory: str | Path,
    prefix: str = "",
) -> None:
    """Write `{prefix}PR_curve.png`, `F1_curve.png`, `Precision_curve.png`
    and `Recall_curve.png` from `ap_per_class(return_curves=True)`'s curves.
    Per-class legend entries only up to 20 classes, as the JAX figures."""
    directory = Path(directory)
    cls_names = _legend_names(curves["classes"], names)
    show_legend = len(cls_names) <= 20

    ax = Axes("Recall", "Precision")
    entries = []
    for ci, name in enumerate(cls_names):
        ax.plot(curves["pr_x"], curves["pr"][ci], class_color(ci))
        if show_legend:
            entries.append((f"{name} {curves['ap50'][ci]:.3f}", class_color(ci), 1))
    ax.plot(curves["pr_x"], curves["pr"].mean(0), BLUE, 3)
    entries.append((f"all classes {curves['ap50'].mean():.3f} mAP@0.5", BLUE, 3))
    ax.legend(entries)
    _finish(ax.canvas, directory / f"{prefix}PR_curve.png")

    for key, ylabel in (("f1", "F1"), ("p", "Precision"), ("r", "Recall")):
        ax = Axes("Confidence", ylabel)
        entries = []
        for ci, name in enumerate(cls_names):
            ax.plot(curves["px"], curves[key][ci], class_color(ci))
            if show_legend:
                entries.append((name, class_color(ci), 1))
        mean = curves[key].mean(0)
        best = mean.argmax()
        ax.plot(curves["px"], mean, BLUE, 3)
        entries.append((f"all classes {mean[best]:.2f} at {curves['px'][best]:.3f}", BLUE, 3))
        ax.legend(entries)
        _finish(ax.canvas, directory / f"{prefix}{ylabel}_curve.png")


def blues(values: np.ndarray, vmax: float) -> np.ndarray:
    """`Blues` RGB of values normalized over [0, vmax], as `imshow` maps
    them (256 bins, the top value in the last)."""
    norm = np.clip(np.asarray(values, np.float64) / vmax, 0.0, 1.0) if vmax > 0 \
        else np.zeros(np.shape(values))
    return np.asarray(BLUES, np.uint8)[np.minimum((norm * 256).astype(np.int64), 255)]


def confusion_layout(nc: int, labels: Sequence[str]) -> dict:
    """The confusion figure's geometry: cell size and the matrix's origin."""
    cell = 40 if nc <= 30 else 12
    n = nc + 1
    label_w = max(_text_width(s) for s in labels) + 12
    left = label_w + TEXT_HEIGHT + 12
    top = 20
    return {"cell": cell, "left": left, "top": top, "label_w": label_w,
            "height": top + n * cell + label_w + TEXT_HEIGHT + 20,
            "width": left + n * cell + 90}


def plot_confusion_matrix(
    matrix: np.ndarray,
    names: Sequence[str],
    path: str | Path,
    normalize: bool = True,
) -> None:
    """Confusion-matrix heatmap PNG: predicted classes down, true classes
    across, each normalized by its column's total when `normalize`; the
    values above 0.005 printed (black below 0.6, white above) where there
    are at most 30 classes; a `Blues` colour bar."""
    m = np.asarray(matrix, np.float64)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    nc = m.shape[0] - 1
    labels = list(names[:nc]) + [str(i) for i in range(len(names), nc)] + ["background"]
    g = confusion_layout(nc, labels)
    cell, left, top = g["cell"], g["left"], g["top"]
    canvas = np.full((g["height"], g["width"], 3), 255, np.uint8)
    n = m.shape[0]
    vmax = float(m.max())
    colors = blues(m, vmax)
    canvas[top:top + n * cell, left:left + n * cell] = np.repeat(
        np.repeat(colors, cell, axis=0), cell, axis=1)
    if nc <= 30:
        for i in range(n):
            for j in range(n):
                if m[i, j] > 0.005:
                    s = f"{m[i, j]:.2f}"
                    x = left + j * cell + (cell - _text_width(s)) // 2
                    y = top + i * cell + (cell + TEXT_HEIGHT) // 2 - 2
                    raster.put_text(canvas, s, (x, y), BLACK if m[i, j] < 0.6 else WHITE)
    bottom = top + n * cell
    for k, s in enumerate(labels):
        c = k * cell + cell // 2
        raster.put_text(canvas, s, (left - 6 - _text_width(s), top + c + TEXT_HEIGHT // 2 - 2),
                        BLACK)
        _put_text_rotated(canvas, s, left + c - TEXT_HEIGHT // 2, bottom + 6, BLACK)
    raster.put_text(canvas, "True", (left + (n * cell - _text_width("True")) // 2,
                                     bottom + g["label_w"] + TEXT_HEIGHT + 4), BLACK)
    _put_text_rotated(canvas, "Predicted", 4, top + (n * cell - _text_width("Predicted")) // 2,
                      BLACK)
    # colour bar: vmax at the top, 0 at the bottom
    bx = left + n * cell + 15
    ramp = np.linspace(vmax, 0.0, n * cell)
    canvas[top:bottom, bx:bx + 16] = blues(ramp, vmax)[:, None]
    raster.rectangle(canvas, (bx, top), (bx + 15, bottom - 1), BLACK)
    for v, y in ((vmax, top), (vmax / 2, (top + bottom) // 2), (0.0, bottom - 1)):
        raster.put_text(canvas, f"{v:.2f}", (bx + 20, y + TEXT_HEIGHT // 2 - 2), BLACK)
    _finish(canvas, Path(path))


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    names: Sequence[str],
    keypoints: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Annotate a HWC float/uint8 image with xyxy boxes (1-pixel frames in a
    seeded palette by class) and keypoints (3x3 green squares); returns a
    uint8 RGB array."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2 or img.shape[-1] == 1:
        img = np.repeat(img.reshape(*img.shape[:2], 1), 3, axis=-1)
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]

    rng = np.random.default_rng(7)
    palette = rng.integers(64, 255, (max(len(names), 1), 3))

    def rect(y0, x0, y1, x1, color):
        y0, y1 = int(np.clip(y0, 0, h - 1)), int(np.clip(y1, 0, h - 1))
        x0, x1 = int(np.clip(x0, 0, w - 1)), int(np.clip(x1, 0, w - 1))
        img[y0:y1 + 1, x0] = color
        img[y0:y1 + 1, x1] = color
        img[y0, x0:x1 + 1] = color
        img[y1, x0:x1 + 1] = color

    for box, cls in zip(np.asarray(boxes), np.asarray(classes).astype(int)):
        x1, y1, x2, y2 = box[:4]
        rect(y1, x1, y2, x2, palette[cls % len(palette)])

    if keypoints is not None:
        for x, y in np.asarray(keypoints)[:, :2]:
            yi, xi = int(round(y)), int(round(x))
            if 1 <= yi < h - 1 and 1 <= xi < w - 1:
                img[yi - 1:yi + 2, xi - 1:xi + 2] = (0, 255, 0)
    return img


def plot_val_panel(
    image: np.ndarray,
    dets: Mapping[str, np.ndarray],
    names: Sequence[str],
    path: str | Path,
    keypoints: Optional[np.ndarray] = None,
) -> None:
    """Save one annotated validation image (the valid detections and the
    keypoints): `draw_detections`' array itself, as PNG."""
    valid = np.asarray(dets.get("valid", np.ones(len(dets["boxes"]), bool)))
    img = draw_detections(
        image, np.asarray(dets["boxes"])[valid], np.asarray(dets["scores"])[valid],
        np.asarray(dets["classes"])[valid], names, keypoints=keypoints,
    )
    _finish(img, Path(path))


def plot_matches(
    image_a: np.ndarray,
    image_b: np.ndarray,
    points_a: np.ndarray,
    points_b: np.ndarray,
    path: str | Path,
) -> None:
    """Side-by-side match image: `image_b` right of `image_a`, each match an
    anti-aliased lime line, the points red dots."""
    def to_u8(im):
        im = np.asarray(im)
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        if im.ndim == 2 or im.shape[-1] == 1:
            im = np.repeat(im.reshape(*im.shape[:2], 1), 3, axis=-1)
        return im

    a, b = to_u8(image_a), to_u8(image_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    pa, pb = np.asarray(points_a), np.asarray(points_b)
    for (xa, ya), (xb, yb) in zip(pa[:, :2], pb[:, :2]):
        raster.line_aa(canvas, (int(round(xa)), int(round(ya))),
                       (int(round(xb)) + a.shape[1], int(round(yb))), (0, 255, 0))
    for x, y in np.concatenate([pa[:, :2], pb[:, :2] + [a.shape[1], 0]]):
        raster.circle(canvas, (int(round(x)), int(round(y))), 1, (255, 0, 0))
    _finish(canvas, Path(path))
