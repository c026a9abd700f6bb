"""Synthetic-shapes dataset: rendered geometric primitives with exact corner
keypoint labels and per-shape bounding boxes.

Counterpart of `yolopoint_tpu/data/synthetic.py`, drawn with
`data/raster.py` (OpenCV's drawing calls reproduced in numpy) instead of
`cv2`: the same numpy `Generator` stream gives the same images, points and
boxes bit for bit. Samples are a pure function of (seed, split, index):
lines, polygons, stars, ellipses, checkerboards, stripes and cubes on
blurred blob backgrounds, grey images repeated to 3 channels, 5 box
classes (polygon, star, ellipse, checkerboard, cube).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from yolopoint_tpu_torch.data import raster

# class table for the object head (box labels)
SHAPE_CLASS_NAMES = ["polygon", "star", "ellipse", "checkerboard", "cube"]


def _rng_for(seed: int, split: str, idx: int) -> np.random.Generator:
    base = 0 if split == "train" else 900_000_007
    return np.random.default_rng(np.random.SeedSequence([seed, base + idx]))


# ---------------------------------------------------------------------------
# background + appearance
# ---------------------------------------------------------------------------

def _background(rng: np.random.Generator, H: int, W: int) -> np.ndarray:
    """Textured background: random low-frequency blob field, blurred."""
    nb = int(rng.integers(10, 30))
    img = np.full((H, W), int(rng.integers(0, 256)), np.uint8)
    for _ in range(nb):
        center = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        ax = (int(rng.integers(W // 20 + 1, W // 3 + 2)),
              int(rng.integers(H // 20 + 1, H // 3 + 2)))
        angle = float(rng.uniform(0, 360))
        col = int(rng.integers(0, 256))
        raster.ellipse(img, center, ax, angle, col)
    k = 2 * int(rng.integers(2, 6)) + 1
    img = raster.gaussian_blur(img, k)
    return img


def _pick_color(rng: np.random.Generator, bg_mean: float, min_contrast: int = 50) -> int:
    """A fill intensity at least `min_contrast` away from the background."""
    lo_ok = bg_mean >= min_contrast
    hi_ok = bg_mean <= 255 - min_contrast
    if lo_ok and (not hi_ok or rng.random() < 0.5):
        return int(rng.integers(0, max(int(bg_mean) - min_contrast, 1)))
    return int(rng.integers(min(int(bg_mean) + min_contrast, 254), 256))


def _shape_bbox(cls_id: int, pts: np.ndarray, H: int, W: int) -> np.ndarray:
    """(1, 5) [cls, cx, cy, w, h] normalized box around pixel points."""
    x0, y0 = pts[:, 0].min(), pts[:, 1].min()
    x1, y1 = pts[:, 0].max(), pts[:, 1].max()
    x0, x1 = np.clip([x0, x1], 0, W - 1)
    y0, y1 = np.clip([y0, y1], 0, H - 1)
    return np.array(
        [[cls_id, (x0 + x1) / 2 / W, (y0 + y1) / 2 / H,
          (x1 - x0) / W, (y1 - y0) / H]], np.float32)


# ---------------------------------------------------------------------------
# primitives — each draws into `img` and returns (points (N,2) xy px, boxes)
# ---------------------------------------------------------------------------

def draw_lines(rng, img):
    H, W = img.shape
    n = int(rng.integers(1, 10))
    pts, segs = [], []

    def cross2(u, v):
        return u[0] * v[1] - u[1] * v[0]

    def intersects(a, b):
        # reject segments crossing existing ones (keeps labels = endpoints)
        for c, d in segs:
            d1 = cross2(d - c, a - c)
            d2 = cross2(d - c, b - c)
            d3 = cross2(b - a, c - a)
            d4 = cross2(b - a, d - a)
            if ((d1 * d2) < 0) & ((d3 * d4) < 0):
                return True
        return False

    for _ in range(n):
        a = rng.integers([0, 0], [W, H]).astype(np.float64)
        b = rng.integers([0, 0], [W, H]).astype(np.float64)
        if np.hypot(*(a - b)) < 15 or intersects(a, b):
            continue
        col = _pick_color(rng, img.mean())
        th = int(rng.integers(1, 4))
        raster.line(img, tuple(a.astype(int)), tuple(b.astype(int)), col, th)
        segs.append((a, b))
        pts += [a, b]
    return (np.asarray(pts, np.float32) if pts else np.zeros((0, 2), np.float32),
            np.zeros((0, 5), np.float32))


def _random_convex_polygon(rng, cx, cy, rad, num):
    angles = np.sort(rng.uniform(0, 2 * np.pi, num))
    radii = rng.uniform(0.4 * rad, rad, num)
    xs = cx + radii * np.cos(angles)
    ys = cy + radii * np.sin(angles)
    p = np.stack([xs, ys], 1)
    # drop near-collinear / too-close vertices (no spurious weak corners)
    keep = []
    for i in range(len(p)):
        a, b, c = p[i - 1], p[i], p[(i + 1) % len(p)]
        v1, v2 = a - b, c - b
        cosang = abs(np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2) + 1e-9))
        if cosang < 0.95 and np.linalg.norm(v1) > 8 and np.linalg.norm(v2) > 8:
            keep.append(i)
    return p[keep] if len(keep) >= 3 else None


def draw_polygons(rng, img):
    H, W = img.shape
    n = int(rng.integers(1, 4))
    pts, boxes = [], []
    occupied = np.zeros_like(img, bool)
    for _ in range(n):
        rad = float(rng.uniform(0.08, 0.25) * min(H, W))
        cx = float(rng.uniform(rad, W - rad))
        cy = float(rng.uniform(rad, H - rad))
        poly = _random_convex_polygon(rng, cx, cy, rad, int(rng.integers(3, 8)))
        if poly is None:
            continue
        mask = np.zeros_like(img)
        raster.fill_poly(mask, [poly.astype(np.int32)], 1)
        if (occupied & (mask > 0)).any():
            continue
        occupied |= mask > 0
        col = _pick_color(rng, img[mask > 0].mean() if (mask > 0).any() else img.mean())
        raster.fill_poly(img, [poly.astype(np.int32)], col)
        pts.append(poly)
        boxes.append(_shape_bbox(0, poly, H, W))
    return (np.concatenate(pts).astype(np.float32) if pts else np.zeros((0, 2), np.float32),
            np.concatenate(boxes) if boxes else np.zeros((0, 5), np.float32))


def draw_star(rng, img):
    H, W = img.shape
    nb = int(rng.integers(3, 6))
    rad = float(rng.uniform(0.1, 0.3) * min(H, W))
    cx = float(rng.uniform(rad, W - rad))
    cy = float(rng.uniform(rad, H - rad))
    angles = rng.uniform(0, 2 * np.pi, nb)
    tips = np.stack([cx + rad * np.cos(angles), cy + rad * np.sin(angles)], 1)
    col = _pick_color(rng, img.mean())
    th = int(rng.integers(1, 3))
    for t in tips:
        raster.line(img, (int(cx), int(cy)), tuple(t.astype(int)), col, th)
    pts = np.concatenate([[[cx, cy]], tips]).astype(np.float32)
    return pts, _shape_bbox(1, pts, H, W)


def draw_ellipses(rng, img):
    """Ellipses have NO corner keypoints — negative examples for the
    detector, positive for the object head."""
    H, W = img.shape
    n = int(rng.integers(1, 4))
    boxes = []
    for _ in range(n):
        ax = (int(rng.integers(max(W // 16, 6), W // 4)),
              int(rng.integers(max(H // 16, 6), H // 4)))
        cx = int(rng.integers(ax[0], W - ax[0]))
        cy = int(rng.integers(ax[1], H - ax[1]))
        angle = float(rng.uniform(0, 360))
        col = _pick_color(rng, img.mean())
        raster.ellipse(img, (cx, cy), ax, angle, col)
        r = max(ax)
        corners = np.array([[cx - r, cy - r], [cx + r, cy + r]], np.float32)
        boxes.append(_shape_bbox(2, corners, H, W))
    return np.zeros((0, 2), np.float32), np.concatenate(boxes)


def draw_checkerboard(rng, img):
    H, W = img.shape
    rows, cols = int(rng.integers(3, 6)), int(rng.integers(3, 6))
    # random perspective placement of the grid
    margin = 0.05
    base = np.array([[margin * W, margin * H], [(1 - margin) * W, margin * H],
                     [(1 - margin) * W, (1 - margin) * H], [margin * W, (1 - margin) * H]],
                    np.float32)
    jitter = rng.uniform(-0.12, 0.12, (4, 2)).astype(np.float32) * [W, H]
    quad = base + jitter
    # grid corners in unit cell space -> perspective map into the quad
    src = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    M = raster.get_perspective_transform(src, quad.astype(np.float32))
    us, vs = np.meshgrid(np.linspace(0, 1, cols + 1), np.linspace(0, 1, rows + 1))
    uv = np.stack([us, vs], -1).reshape(-1, 2)
    ones = np.ones((len(uv), 1), np.float32)
    xyw = (M @ np.concatenate([uv, ones], 1).T).T
    corners = (xyw[:, :2] / xyw[:, 2:3]).astype(np.float32)
    grid = corners.reshape(rows + 1, cols + 1, 2)
    cols_pair = (int(rng.integers(0, 128)), int(rng.integers(128, 256)))
    for r in range(rows):
        for c in range(cols):
            cell = np.stack([grid[r, c], grid[r, c + 1],
                             grid[r + 1, c + 1], grid[r + 1, c]])
            raster.fill_poly(img, [cell.astype(np.int32)], cols_pair[(r + c) % 2])
    return corners, _shape_bbox(3, corners, H, W)


def draw_stripes(rng, img):
    H, W = img.shape
    n = int(rng.integers(2, 6))
    # vertical-ish stripe band with rotated frame
    xs = np.sort(rng.uniform(0.1, 0.9, n)) * W
    y0, y1 = 0.1 * H, 0.9 * H
    pts = []
    for i in range(n - 1):
        col = int(rng.integers(0, 256))
        quad = np.array([[xs[i], y0], [xs[i + 1], y0], [xs[i + 1], y1], [xs[i], y1]],
                        np.float32)
        raster.fill_poly(img, [quad.astype(np.int32)], col)
        pts.append(quad)
    pts = np.unique(np.concatenate(pts), axis=0).astype(np.float32) if pts \
        else np.zeros((0, 2), np.float32)
    return pts, np.zeros((0, 5), np.float32)


def draw_cube(rng, img):
    """Wireframe-shaded cube in weak perspective: 7 visible vertices."""
    H, W = img.shape
    s = float(rng.uniform(0.12, 0.3) * min(H, W))
    # cube corners in 3D, random rotation, orthographic-ish projection
    verts = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                     np.float64) - 0.5
    ang = rng.uniform(0, 2 * np.pi, 3)
    cx_, sx = np.cos(ang[0]), np.sin(ang[0])
    cy_, sy = np.cos(ang[1]), np.sin(ang[1])
    cz, sz = np.cos(ang[2]), np.sin(ang[2])
    R = (np.array([[1, 0, 0], [0, cx_, -sx], [0, sx, cx_]])
         @ np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
         @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]]))
    v3 = verts @ R.T
    center = np.array([rng.uniform(s, W - s), rng.uniform(s, H - s)])
    p2 = v3[:, :2] * s + center
    # the vertex with max depth is hidden (weak perspective, convex cube)
    hidden = int(np.argmax(v3[:, 2]))
    faces = [(0, 1, 3, 2), (4, 5, 7, 6), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 3, 7, 5)]
    # paint visible faces (those not containing the hidden vertex) with
    # distinct shades — yields strong corners at the visible vertices
    shades = rng.permutation([60, 120, 200])
    si = 0
    for f in faces:
        if hidden in f:
            continue
        quad = p2[list(f)].astype(np.int32)
        raster.fill_poly(img, [quad], int(shades[si % 3]))
        si += 1
    vis = np.array([i for i in range(8) if i != hidden])
    pts = p2[vis].astype(np.float32)
    return pts, _shape_bbox(4, pts, H, W)


def gaussian_noise(rng, img):
    img[:] = rng.integers(0, 256, img.shape).astype(np.uint8)
    return np.zeros((0, 2), np.float32), np.zeros((0, 5), np.float32)


PRIMITIVES = [
    ("lines", draw_lines),
    ("polygons", draw_polygons),
    ("star", draw_star),
    ("ellipses", draw_ellipses),
    ("checkerboard", draw_checkerboard),
    ("stripes", draw_stripes),
    ("cube", draw_cube),
    ("noise", gaussian_noise),
]
# noise images are rare; corner-rich primitives dominate
PRIMITIVE_WEIGHTS = np.array([3, 4, 2, 2, 3, 2, 3, 1], np.float64)


def render_sample(
    rng: np.random.Generator,
    H: int,
    W: int,
    primitives: Optional[Sequence[str]] = None,
    blur_prob: float = 0.5,
    n_shapes: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one image. Returns (u8 (H, W) image, points (N, 2) xy,
    boxes (M, 5) [cls, cxcywh normalized]).

    `n_shapes > 1` renders a DENSE scene: the canvas is partitioned into a
    near-square grid and one primitive is drawn per cell (labels stay exact
    because shapes cannot occlude each other across cells). Dense scenes
    spread correspondences over the whole frame, which is what the
    homography-correctness metric needs — RANSAC H from matches clustered
    on one shape outline extrapolates noisily to the image corners."""
    table = [(n, f) for n, f in PRIMITIVES if primitives is None or n in primitives]
    w = np.array([PRIMITIVE_WEIGHTS[[p[0] for p in PRIMITIVES].index(n)]
                  for n, _ in table])
    img = _background(rng, H, W)
    if n_shapes > 1:
        gy = max(int(np.sqrt(n_shapes)), 1)
        gx = int(np.ceil(n_shapes / gy))
        ys = np.linspace(0, H, gy + 1).astype(int)
        xs = np.linspace(0, W, gx + 1).astype(int)
        cells = [(ys[i], ys[i + 1], xs[j], xs[j + 1])
                 for i in range(gy) for j in range(gx)]
        order = rng.permutation(len(cells))[:n_shapes]
        pts_l, boxes_l = [], []
        for ci in order:
            y0, y1, x0, x1 = cells[ci]
            tile = np.ascontiguousarray(img[y0:y1, x0:x1])
            _, fn_i = table[rng.choice(len(table), p=w / w.sum())]
            p_i, b_i = fn_i(rng, tile)
            img[y0:y1, x0:x1] = tile
            if len(p_i):
                p_i = p_i + np.array([x0, y0], np.float32)
                pts_l.append(p_i)
            if len(b_i):
                th, tw = y1 - y0, x1 - x0
                b = b_i.copy()
                b[:, 1] = (b[:, 1] * tw + x0) / W
                b[:, 2] = (b[:, 2] * th + y0) / H
                b[:, 3] = b[:, 3] * tw / W
                b[:, 4] = b[:, 4] * th / H
                boxes_l.append(b)
        pts = (np.concatenate(pts_l, 0) if pts_l
               else np.zeros((0, 2), np.float32))
        boxes = (np.concatenate(boxes_l, 0) if boxes_l
                 else np.zeros((0, 5), np.float32))
    else:
        _, fn = table[rng.choice(len(table), p=w / w.sum())]
        pts, boxes = fn(rng, img)
    if rng.random() < blur_prob:
        k = 2 * int(rng.integers(1, 3)) + 1
        img = raster.gaussian_blur(img, k)
    if len(pts):
        inside = ((pts[:, 0] >= 0) & (pts[:, 0] <= W - 1)
                  & (pts[:, 1] >= 0) & (pts[:, 1] <= H - 1))
        pts = pts[inside]
    return img, pts.astype(np.float32), boxes.astype(np.float32)


class SyntheticShapes:
    """Loader-compatible dataset over the renderer (same `get()` surface as
    `data.datasets.ImagePointBoxDataset`). Config (data.*):

      dataset: synthetic_shapes
      preprocessing: {resize: [H, W]}         # or img_size for square
      length: {train: 20000, val: 256}
      generation: {primitives: [...], blur_prob: 0.5, seed: 17}
    """

    mosaic_prob = 0.0
    device_crop = False

    def __init__(
        self,
        config: Mapping[str, Any],
        action: str = "train",
        names: Sequence[str] = (),
        root: str = "datasets",
        debug: bool = False,
    ):
        self.config = dict(config)
        self.action = "train" if "train" in action and not debug else "val"
        pre = config.get("preprocessing") or {}
        if pre.get("resize"):
            self.hw = tuple(int(v) for v in pre["resize"])
        else:
            s = int(pre.get("img_size", 256))
            self.hw = (s, s)
        length = config.get("length") or {}
        self._len = int(length.get(self.action, 20000 if self.action == "train" else 256))
        if debug:
            self._len = min(self._len, 512)
        gen = config.get("generation") or {}
        self.primitives = gen.get("primitives")
        self.blur_prob = float(gen.get("blur_prob", 0.5))
        self.seed = int(gen.get("seed", 17))
        # dense scenes: int (both splits) or {train: a, val: b}. Denser val
        # scenes make the fitness homography term informative
        spi = gen.get("shapes_per_image", 1)
        if isinstance(spi, Mapping):
            spi = spi.get(self.action, 1)
        self.n_shapes = max(int(spi), 1)
        # RAM cache of rendered samples: a sample is a pure function of
        # (seed, split, index), so re-rendering every epoch only burns host
        # CPU. Grayscale u8 + small label arrays: 20k train images at
        # 256x320 = 1.6 GB. Epoch-to-epoch variety comes from the on-device
        # homographic + photometric augmentation.
        self.cache_images = bool(gen.get("cache", True))
        self._cache: dict[int, tuple] = {}
        # stage 3 of the bootstrap loop: train against homographic-adaptation
        # pseudo-labels ({name}.npz {pts}) instead of the exact rendered corners
        self.points_dir = gen.get("points_dir")
        # map renderer class ids -> position in the run's `names`
        names = list(names)
        self.cls_map = np.array(
            [names.index(n) if n in names else -1 for n in SHAPE_CLASS_NAMES],
            np.int64,
        ) if names else np.arange(len(SHAPE_CLASS_NAMES))

    def __len__(self) -> int:
        return self._len

    def _render(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        rng = _rng_for(self.seed, self.action, int(idx))
        H, W = self.hw
        out = render_sample(rng, H, W, self.primitives, self.blur_prob,
                            n_shapes=self.n_shapes)
        if self.cache_images:
            self._cache[idx] = out
        return out

    def get(self, idx: int, mosaic: Optional[bool] = None) -> dict[str, Any]:
        img, pts, boxes = self._render(int(idx))
        if len(boxes):
            mapped = self.cls_map[boxes[:, 0].astype(np.int64)]
            keep = mapped >= 0
            boxes = np.concatenate(
                [mapped[keep, None].astype(np.float32), boxes[keep, 1:]], 1
            )
        # pseudo-labels replace the exact corners for TRAINING only; val keeps
        # exact labels so stage-3 metrics are measured against ground truth
        if self.points_dir is not None and self.action == "train":
            import os

            p = os.path.join(self.points_dir, f"synth_{self.action}_{idx:06d}.npz")
            arr = np.load(p)["pts"]  # (K, 3) [x, y, prob] export schema
            pts = arr[:, :2].astype(np.float32)
        else:
            pts = pts.copy()  # cached array must not leak to mutable consumers
        img3 = np.repeat(img[..., None], 3, axis=2)
        return {
            # u8 payload: the device step (build_training_views) and the
            # host-warp path both normalize; keeps the collate stack and the
            # host->device transfer 4x cheaper on this 1-core host
            "image": img3,
            "boxes": boxes,
            "points": pts,
            "pad": (0, 0, 0, 0),
            "name": f"synth_{self.action}_{idx:06d}",
        }

    def iter_export(self):
        """(name, float image) pairs for homographic-adaptation export."""
        for idx in range(len(self)):
            s = self.get(idx)
            yield s["name"], s["image"].astype(np.float32) / 255.0
