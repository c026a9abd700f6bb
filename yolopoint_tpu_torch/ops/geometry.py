"""Homography point and image warping, and valid masks.

Counterpart of `yolopoint_tpu/ops/geometry.py`, with its conventions:
points are `(..., N, 2)` `(x, y)`; homographies `(..., 3, 3)` act on
`(x, y, 1)`; normalized coordinates span `[-1, 1]` with align-corners
semantics, `x_pix = (x_norm + 1) / 2 * (W - 1)`; images are NHWC.

`warp_image` is the entry point of the image warp. It calls the wrapper
of `ops/cuda_warp.py`, where the one dispatch lies: a CPU tensor takes the
plain version `warp_image_plain` (the JAX package's exact `_warp_image_xla`),
a CUDA tensor launches the hand-written kernel (which stands for both Pallas
warps, K4 and K5) or raises.

`warp_points` is written out element by element, `h0 x + h1 y + h2` and
one division, so that the plain warp and the CUDA kernel round every
source coordinate the same way on every device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops.sampling import grid_sample


def warp_points(points: torch.Tensor, homography: torch.Tensor) -> torch.Tensor:
    """Apply homographies to 2D points.

    `points` `(N, 2)` with `homography` `(3, 3)` gives `(N, 2)`; with `(B, 3, 3)`
    it gives `(B, N, 2)`; `(B, N, 2)` points with `(B, 3, 3)` homographies
    warp each row by its own homography.
    """
    h = homography.to(torch.float32)[..., None, :, :]  # (..., 1, 3, 3)
    x = points[..., 0].to(torch.float32)
    y = points[..., 1].to(torch.float32)
    w = [h[..., k, 0] * x + h[..., k, 1] * y + h[..., k, 2] for k in range(3)]
    return torch.stack([w[0] / w[2], w[1] / w[2]], dim=-1)


def mat3_product(*mats: torch.Tensor) -> torch.Tensor:
    """The product of (batched) 3x3 matrices, formed in f64 and rounded once
    to f32. A device's BLAS rounds an f32 product in its own order (the
    card's and the CPU's differ by ulps); in f64 the rounding to f32 gives
    the same matrix on every device, so a view's homographies, and the
    pixels its points land on, do not depend on where it was built."""
    out = mats[0].to(torch.float64)
    for m in mats[1:]:
        out = out @ m.to(torch.float64)
    return out.to(torch.float32)


def mat3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """The inverse of (batched) 3x3 matrices, in f64 rounded once to f32
    (as `mat3_product`)."""
    return torch.linalg.inv(mat.to(torch.float64)).to(torch.float32)


def homography_scaling(homography: torch.Tensor, height, width) -> torch.Tensor:
    """`T^-1 @ H @ T`: a normalized-coords homography acting on pixel coords,
    where `T` maps pixels to normalized coordinates."""
    trans = torch.tensor([[2.0 / width, 0.0, -1.0], [0.0, 2.0 / height, -1.0], [0.0, 0.0, 1.0]],
                         dtype=torch.float32, device=homography.device)
    return mat3_product(mat3_inverse(trans), homography, trans)


@functools.lru_cache(maxsize=32)
def _linspace_axis(n: int, device: str) -> torch.Tensor:
    """`n` points from -1 to 1, rounded as the JAX package's compiled train
    step rounds `jnp.linspace(-1, 1, n)` (XLA divides by `n - 1` as a
    multiplication by its f32 reciprocal, then `-1 (1 - s) + 1 s`)."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    step = torch.arange(n - 1, dtype=torch.float32) * (torch.tensor(1.0) / (n - 1))
    out = torch.cat([-(1.0 - step) + step, torch.ones(1)])
    return out.to(device)


def grid_axes(height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`(ys (H,), xs (W,))` normalized output coordinates, align-corners."""
    dev = str(torch.device(device))
    return _linspace_axis(height, dev), _linspace_axis(width, dev)


def _normalized_grid(height: int, width: int, device) -> torch.Tensor:
    """`(H, W, 2)` grid of normalized `(x, y)` output coords."""
    ys, xs = grid_axes(height, width, device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _source_pixels(homography: torch.Tensor, height: int, width: int, batch: int):
    """Source pixel coords `(sx, sy)`, each `(B, H, W)`, of every output pixel
    under output -> source normalized-coords homographies."""
    Hm = homography.reshape(-1, 3, 3).to(torch.float32).expand(batch, 3, 3)
    src = warp_points(_normalized_grid(height, width, Hm.device).reshape(-1, 2), Hm)
    sx = (src[..., 0] + 1.0) * 0.5 * (width - 1)
    sy = (src[..., 1] + 1.0) * 0.5 * (height - 1)
    return sx.reshape(batch, height, width), sy.reshape(batch, height, width)


def warp_image_plain(img: torch.Tensor, homography_inv: torch.Tensor,
                     mode: str = "bilinear") -> torch.Tensor:
    """Plain version of the warp (`_warp_image_xla` of the JAX package):
    exact f32, gather-based, differentiable; the CPU path and the kernel's
    reference on the card."""
    if img.dim() == 3:
        img = img[None]
    B, H, W, _ = img.shape
    sx, sy = _source_pixels(homography_inv, H, W, B)
    return grid_sample(img, torch.stack([sx, sy], dim=-1), mode=mode)


def warp_image(img: torch.Tensor, homography_inv: torch.Tensor,
               mode: str = "bilinear") -> torch.Tensor:
    """Inverse-warp `(B, H, W, C)` images by `(B, 3, 3)` or `(3, 3)`
    output -> source homographies in normalized coords; bilinear or nearest,
    align-corners, zero padding.

    A CPU tensor takes the plain version; a CUDA tensor launches the CUDA
    kernel (`ops/cuda_warp.py`) or raises.
    """
    # deferred: cuda_warp imports this module for the plain version
    from yolopoint_tpu_torch.ops.cuda_warp import warp_image_cuda

    return warp_image_cuda(img[None] if img.dim() == 3 else img, homography_inv, mode)


def binary_erosion(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Erode a binary `(B, H, W)` mask with a 0/1 structuring element; a
    pixel survives iff every support pixel is 1. The border counts as 1 and
    the anchor is the kernel centre, as `cv2.erode` does."""
    kh, kw = kernel.shape
    top, left = kh // 2, kw // 2
    bottom, right = kh - 1 - top, kw - 1 - left
    x = F.pad(mask.to(torch.float32)[:, None], (left, right, top, bottom), value=1.0)
    k = torch.as_tensor(kernel, dtype=torch.float32, device=mask.device)[None, None]
    s = F.conv2d(x, k)[:, 0]
    return (s >= float(kernel.sum()) - 0.5).to(mask.dtype)


@functools.lru_cache(maxsize=16)
def ellipse_kernel(radius: int) -> np.ndarray:
    """`cv2.getStructuringElement(MORPH_ELLIPSE, (2r, 2r))`, by OpenCV's
    scanline fill: per row `dy = i - r`, `dx = round(c sqrt((r^2 - dy^2) / r^2))`."""
    size = 2 * radius
    r = c = size // 2
    kernel = np.zeros((size, size), np.uint8)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(size):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(round(c * math.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
        kernel[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return kernel


def _interior(height: int, width: int, device) -> torch.Tensor:
    """`(H, W)` ones with a zero 1-px frame."""
    border = torch.zeros((height, width), dtype=torch.float32, device=device)
    border[1:-1, 1:-1] = 1.0
    return border


def compute_valid_mask(
    image_shape: tuple[int, int],
    homography: torch.Tensor,
    erosion_radius: int = 0,
    pad: tuple[int, int, int, int] = (0, 0, 0, 0),
) -> torch.Tensor:
    """`(B, H, W)` {0, 1} mask of the pixels a warp fills from inside the
    unpadded source frame (nearest rounding), a zero 1-px frame, then an
    optional ellipse erosion. Pure coordinate math: no gather."""
    Hh, Ww = image_shape
    Hm = homography.reshape(-1, 3, 3)
    top, bottom, left, right = pad
    sx, sy = _source_pixels(Hm, Hh, Ww, Hm.shape[0])
    sx, sy = torch.floor(sx + 0.5), torch.floor(sy + 0.5)
    inside = (sx >= left) & (sx <= Ww - 1 - right) & (sy >= top) & (sy <= Hh - 1 - bottom)
    mask = inside.to(torch.float32) * _interior(Hh, Ww, Hm.device)
    if erosion_radius > 0:
        mask = binary_erosion(mask, ellipse_kernel(erosion_radius))
    return mask


def warped_pair_valid_mask(
    image_shape: tuple[int, int],
    h_base: torch.Tensor,
    h_pair: torch.Tensor,
    erosion_radius: int = 0,
    pad: tuple[int, int, int, int] = (0, 0, 0, 0),
) -> torch.Tensor:
    """Closed form of `warp_image(compute_valid_mask(h_base), h_pair,
    "nearest")`: the pair view's valid mask without a gather,

        pair(q) = [p0 in frame] * AND_k base(p0 + k),   p0 = round(H2(q)),

    `k` over the erosion support (offsets off the frame count as valid) and
    `base(p) = [round(H1(p)) in the unpadded rect] * [p in the 1-px interior]`.
    """
    Hh, Ww = image_shape
    Hb = h_base.reshape(-1, 3, 3)
    Hp = h_pair.reshape(-1, 3, 3)
    B = max(Hb.shape[0], Hp.shape[0])
    Hb, Hp = Hb.expand(B, 3, 3), Hp.expand(B, 3, 3)
    top, bottom, left, right = pad

    px, py = _source_pixels(Hp, Hh, Ww, B)
    px, py = torch.floor(px + 0.5), torch.floor(py + 0.5)
    in_frame = (px >= 0) & (px <= Ww - 1) & (py >= 0) & (py <= Hh - 1)

    if erosion_radius > 0:
        k = ellipse_kernel(erosion_radius)
        kh, kw = k.shape
        offsets = [(float(j - kw // 2), float(i - kh // 2))
                   for i in range(kh) for j in range(kw) if k[i, j]]
    else:
        offsets = [(0.0, 0.0)]
    sx_n = 2.0 / max(Ww - 1, 1)
    sy_n = 2.0 / max(Hh - 1, 1)
    hb = Hb[:, None]  # (B, 1, 3, 3): one homography per row of (B, H, W) coords

    def base_at(qx, qy):
        pts = torch.stack([qx * sx_n - 1.0, qy * sy_n - 1.0], dim=-1)
        s1 = warp_points(pts, hb)
        gx = torch.floor((s1[..., 0] + 1.0) * 0.5 * (Ww - 1) + 0.5)
        gy = torch.floor((s1[..., 1] + 1.0) * 0.5 * (Hh - 1) + 0.5)
        inside1 = (gx >= left) & (gx <= Ww - 1 - right) & (gy >= top) & (gy <= Hh - 1 - bottom)
        border = (qx >= 1) & (qx <= Ww - 2) & (qy >= 1) & (qy <= Hh - 2)
        off_frame = (qx < 0) | (qx > Ww - 1) | (qy < 0) | (qy > Hh - 1)
        return (inside1 & border) | off_frame

    acc = in_frame
    for dx, dy in offsets:
        acc = acc & base_at(px + dx, py + dy)
    return acc.to(torch.float32)


def filter_points_mask(points: torch.Tensor, shape_wh) -> torch.Tensor:
    """Boolean mask of points inside `[0, W-1] x [0, H-1]`."""
    wh = torch.as_tensor(shape_wh, dtype=points.dtype, device=points.device)
    return ((points >= 0) & (points <= wh - 1)).all(dim=-1)


def _paint(points, valid, height, width, values) -> torch.Tensor:
    """Max-scatter `values` at the rounded, clamped `(..., N, 2)` points onto
    `(..., H, W)` canvases; invalid points add nothing."""
    xy = torch.round(points).long()
    x = xy[..., 0].clamp(0, width - 1)
    y = xy[..., 1].clamp(0, height - 1)
    lead = points.shape[:-2]
    canvas = torch.zeros(lead + (height * width,), dtype=torch.float32, device=points.device)
    vals = torch.where(valid, values, 0.0).to(torch.float32)
    canvas.scatter_reduce_(-1, y * width + x, vals, reduce="amax")
    return canvas.reshape(lead + (height, width))


def scatter_points(points, valid, height: int, width: int, values=1.0) -> torch.Tensor:
    """Paint rounded points onto `(..., H, W)`; invalid points dropped;
    duplicates keep the max."""
    vals = torch.broadcast_to(torch.as_tensor(values, dtype=torch.float32,
                                              device=points.device), valid.shape)
    return _paint(points, valid, height, width, vals)


def points_to_label_map(points, valid, height: int, width: int) -> torch.Tensor:
    """Binary keypoint label map `(..., H, W)` from `(..., N, 2)` points and
    their validity (rounded points clamped into the image)."""
    return _paint(points, valid, height, width, valid.to(torch.float32))


def warp_label_map(points, valid, height: int, width: int, inv_homography):
    """Floor integer keypoints, warp them by the pixel-space conjugate of
    `inv_homography`, drop those off the frame and rasterize.

    Returns `(label_map (H, W), warped_points (N, 2), valid_out (N,))`.
    """
    pts = torch.floor(points.to(torch.float32))
    warped = warp_points(pts, homography_scaling(inv_homography, height, width))
    valid_out = valid & filter_points_mask(warped, (width, height))
    return scatter_points(warped, valid_out, height, width), warped, valid_out
