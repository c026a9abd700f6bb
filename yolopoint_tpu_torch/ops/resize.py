"""Image resize without OpenCV: `cv2.resize` as the JAX package calls it.

The JAX package resizes with `cv2.resize`, `INTER_LINEAR` when it enlarges
and `INTER_AREA` when it shrinks (`preprocess_frame`, `HPatches`). The
machine that runs the port has no OpenCV, so `resize` computes the same
function in plain torch on the input's device:

* the same size returns a copy;
* `INTER_LINEAR`: half-pixel centres, `s = (d + 0.5) * src / dst - 0.5`,
  two taps per axis, taps off the edge clipped to it (OpenCV zeroes the
  weight of such taps along x, not along y). f32 runs in f32, horizontal
  pass then vertical; uint8 runs OpenCV's fixed-point arithmetic: 11-bit
  weights, the horizontal sums in int32, the vertical blend as its vector
  path computes it, `((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16)`
  rounded by `(x + 2) >> 2`;
* `INTER_AREA`: each output pixel is the area-weighted mean of the source
  pixels its cell covers (OpenCV's `computeResizeAreaTab`), at integer and
  non-integer ratios; at integer ratios OpenCV's fast path takes the plain
  block mean (uint8: rounded half up at ratio 2, as its vector path does).
  Where a shrink leaves one axis at ratio < 1, OpenCV falls back to a
  bilinear variant that this module does not reproduce: it raises.

The weight tables are small (one row per output index) and are made on the
host in the precision OpenCV makes them; the pixels never leave the device.
"""

from __future__ import annotations

import numpy as np
import torch

INTER_LINEAR = "linear"
INTER_AREA = "area"
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_table(src: int, dst: int, clamp: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`(i0, i1, w1)`: per output index the two source indices and the f32
    weight of the second, as `cv2.resize` computes them for `INTER_LINEAR`
    (the scale is `1 / (dst / src)` in f64, the position cast to f32).
    OpenCV zeroes the weight of taps off the edge along x (`clamp`); along
    y it keeps the weights and clips the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    w1 = (f - i0.astype(np.float32)).astype(np.float32)
    if clamp:
        w1[(i0 < 0) | (i0 >= src - 1)] = 0.0
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w1


def _area_table(src: int, dst: int) -> np.ndarray:
    """`(dst, src)` f64 matrix of `INTER_AREA` weights (f32 values), OpenCV's
    `computeResizeAreaTab` for `src / dst >= 1`."""
    scale = 1.0 / (dst / src)
    table = np.zeros((dst, src), np.float64)
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s2 = min(int(np.floor(fs2)), src - 1)
        s1 = min(int(np.ceil(fs1)), s2)
        if s1 - fs1 > 1e-3:
            table[d, s1 - 1] = np.float32((s1 - fs1) / cell)
        table[d, s1:s2] = np.float32(1.0 / cell)
        if fs2 - s2 > 1e-3:
            table[d, s2] = np.float32(min(min(fs2 - s2, 1.0), cell) / cell)
    return table


def _linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`INTER_LINEAR` of an `(H, W, C)` uint8 or f32 image."""
    H, W, _ = img.shape
    dev = img.device
    y0, y1, wy = (torch.from_numpy(a).to(dev) for a in _linear_table(H, h, clamp=False))
    x0, x1, wx = (torch.from_numpy(a).to(dev) for a in _linear_table(W, w, clamp=True))
    if img.dtype == torch.uint8:
        ax1 = torch.round(wx * _COEF_SCALE).to(torch.int32)  # f32 round half even, as cvRound
        ax0 = torch.round((1.0 - wx) * _COEF_SCALE).to(torch.int32)
        by1 = torch.round(wy * _COEF_SCALE).to(torch.int64)
        by0 = torch.round((1.0 - wy) * _COEF_SCALE).to(torch.int64)
        src = img.to(torch.int32)
        rows = src[:, x0] * ax0[None, :, None] + src[:, x1] * ax1[None, :, None]  # (H, w, C)
        h0 = (rows[y0] >> 4).to(torch.int64)
        h1 = (rows[y1] >> 4).to(torch.int64)
        out = ((h0 * by0[:, None, None]) >> 16) + ((h1 * by1[:, None, None]) >> 16)
        return ((out + 2) >> 2).clamp(0, 255).to(torch.uint8)
    src = img.to(torch.float32)
    rows = src[:, x0] * (1.0 - wx)[None, :, None] + src[:, x1] * wx[None, :, None]
    return rows[y0] * (1.0 - wy)[:, None, None] + rows[y1] * wy[:, None, None]


def _area(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`INTER_AREA` of an `(H, W, C)` uint8 or f32 image, `h <= H`, `w <= W`."""
    H, W, _ = img.shape
    dev = img.device
    sy, sx = 1.0 / (h / H), 1.0 / (w / W)
    fast = abs(sy - round(sy)) < np.finfo(np.float64).eps and \
        abs(sx - round(sx)) < np.finfo(np.float64).eps
    if fast:  # integer ratios: the block mean
        ky, kx = int(round(sy)), int(round(sx))
        blocks = img[:h * ky, :w * kx].reshape(h, ky, w, kx, -1)
        if img.dtype == torch.uint8:
            total = blocks.to(torch.int32).sum(dim=(1, 3))
            if ky == kx == 2:
                return ((total + 2) >> 2).to(torch.uint8)
            return torch.round(total.to(torch.float32) * np.float32(1.0 / (ky * kx))).to(
                torch.uint8)
        total = blocks.to(torch.float32).sum(dim=(1, 3))
        return total * np.float32(1.0 / (ky * kx))
    ty = torch.from_numpy(_area_table(H, h)).to(dev)
    tx = torch.from_numpy(_area_table(W, w)).to(dev)
    out = torch.einsum("yh,hwc,xw->yxc", ty, img.to(torch.float64), tx)
    if img.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out.to(torch.float32)


def resize(img: torch.Tensor, size_wh: tuple[int, int], interpolation: str) -> torch.Tensor:
    """`cv2.resize(img, size_wh, interpolation=...)` for an `(H, W)` or
    `(H, W, C)` uint8 or f32 tensor, on its device; `interpolation` is
    `INTER_LINEAR` or `INTER_AREA`. Returns the input's layout and dtype."""
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"resize takes uint8 or float32 images, got {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"resize takes (H, W) or (H, W, C) images, got {tuple(img.shape)}")
    w, h = int(size_wh[0]), int(size_wh[1])
    if w <= 0 or h <= 0:
        raise ValueError(f"bad target size {size_wh}")
    x = img if img.dim() == 3 else img[..., None]
    H, W, _ = x.shape
    if (h, w) == (H, W):
        return img.clone()
    if interpolation == INTER_LINEAR:
        out = _linear(x, h, w)
    elif interpolation == INTER_AREA:
        if h > H or w > W:
            raise NotImplementedError("INTER_AREA enlarging an axis (OpenCV's bilinear "
                                      "variant) is not reproduced")
        out = _area(x, h, w)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return out if img.dim() == 3 else out[..., 0]


def resize_like_cv2(img: torch.Tensor, size_wh: tuple[int, int], scale: float) -> torch.Tensor:
    """The JAX package's call, `INTER_AREA if scale < 1 else INTER_LINEAR`."""
    return resize(img, size_wh, INTER_AREA if scale < 1 else INTER_LINEAR)
