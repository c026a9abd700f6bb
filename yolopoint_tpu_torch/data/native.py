"""The datasets' resize, as the JAX package's native library computes it.

Counterpart of `resize_u8` and `u8_to_f32` in `yolopoint_tpu/data/native.py`,
which run the C++ of `native/preprocess.cc` wherever it builds: bilinear in
f32 (`yp_resize_bilinear_u8`) and area in f64 (`yp_resize_area_u8`),
rounded with `std::lround` (half away from zero). That library is built
with `-O3 -march=native`, where the compiler fuses each `a * b + c` of
those loops into one FMA; these numpy versions keep the loops' order of
operations and the fused steps (`_fma32`, `_fma64`), so they give its
bytes. This is not OpenCV's fixed-point resize, which `ops/resize.py`
copies for serving: the two are kept apart.

`resize_u8` is the numpy version, the plain one; `resize_u8_compiled` runs
the same loops in compiled host code (`ops/csrc/host_image.cpp`, built with
the CUDA kernels), and `resize_for(device)` picks the numpy version for the
CPU only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """`std::lround` of non-negative values."""
    t = np.trunc(x)
    return t + (x - t >= 0.5)


def _fma32(a, b, c) -> np.ndarray:
    """f32 `fma(a, b, c)`: the product of two f32 values is exact in f64, so
    one f64 add rounded to f32 gives the fused result (but for double
    rounding at an exact f32 midpoint)."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def _split(a: np.ndarray):
    t = a * 134217729.0  # 2**27 + 1: Veltkamp's split of a double
    hi = t - (t - a)
    return hi, a - hi


def _fma64(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """f64 `fma(a, b, c)`: the exact product as a pair (Dekker), summed with
    `c` by an error-free addition, rounded once at the end."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bv = s - p
    se = (p - (s - bv)) + (c - bv)
    return s + (pe + se)


def _bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw, _ = src.shape
    sy, sx = np.float32(sh) / np.float32(dh), np.float32(sw) / np.float32(dw)

    def axis(n_out, scale, n_in):
        f = _fma32((np.arange(n_out, dtype=np.float32) + np.float32(0.5)), scale,
                   np.float32(-0.5))
        i0 = np.floor(f).astype(np.int64)
        w = (f - i0.astype(np.float32)).astype(np.float32)
        return np.maximum(i0, 0), np.minimum(i0 + 1, n_in - 1), w

    y0, y1, wy = axis(dh, sy, sh)
    x0, x1, wx = axis(dw, sx, sw)
    s = src.astype(np.float32)
    wx_, wxc = wx[None, :, None], (np.float32(1) - wx)[None, :, None]
    wy_, wyc = wy[:, None, None], (np.float32(1) - wy)[:, None, None]
    top = _fma32(s[y0][:, x0], wxc, s[y0][:, x1] * wx_)
    bot = _fma32(s[y1][:, x0], wxc, s[y1][:, x1] * wx_)
    v = _fma32(top, wyc, bot * wy_)
    return _round_half_away(np.clip(v, 0.0, 255.0)).astype(np.uint8)


def _area(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw, c = src.shape
    sy, sx = sh / dh, sw / dw

    def axis(n_out, scale, n_in):
        f0 = np.arange(n_out) * scale
        f1 = (np.arange(n_out) + 1) * scale
        i0 = f0.astype(np.int64)
        i1 = np.minimum(np.ceil(f1).astype(np.int64), n_in)
        return f0, f1, i0, i1

    fy0, fy1, iy0, iy1 = axis(dh, sy, sh)
    fx0, fx1, ix0, ix1 = axis(dw, sx, sw)
    acc = np.zeros((dh, dw, c))
    area = np.zeros((dh, dw, 1))
    s = src.astype(np.float64)
    for ty in range(int((iy1 - iy0).max())):  # the C++ loop's order: rows, then columns
        yy = iy0 + ty
        hy = np.where(yy < iy1, np.minimum(yy + 1.0, fy1) - np.maximum(yy * 1.0, fy0), 0.0)
        rows = s[np.minimum(yy, sh - 1)]
        for tx in range(int((ix1 - ix0).max())):
            xx = ix0 + tx
            wx = np.where(xx < ix1, np.minimum(xx + 1.0, fx1) - np.maximum(xx * 1.0, fx0), 0.0)
            # taps past the window add 0.0 to both sums, which leaves them exact
            v = rows[:, np.minimum(xx, sw - 1)] * hy[:, None, None]
            wxb = np.broadcast_to(wx[None, :, None], v.shape)
            acc = _fma64(v, wxb, acc)
            area = _fma64(np.broadcast_to(hy[:, None, None], area.shape),
                          np.broadcast_to(wx[None, :, None], area.shape), area)
    return _round_half_away(acc / np.maximum(area, 1e-9)).astype(np.uint8)


def resize_u8(img: np.ndarray, dh: int, dw: int, mode: str = "auto") -> np.ndarray:
    """Resize a uint8 `(H, W, C)` image to `(dh, dw)`: area when `mode` is
    "area", or "auto" and `dh < H` (the height alone decides), else bilinear
    (half-pixel centres, edges clamped)."""
    img = np.ascontiguousarray(img, np.uint8)
    use_area = mode == "area" or (mode == "auto" and dh < img.shape[0])
    return (_area if use_area else _bilinear)(img, dh, dw)


def u8_to_f32(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1], as `x * (1 / 255)` in f32."""
    return np.asarray(img, np.uint8) * np.float32(1.0 / 255.0)


def resize_u8_compiled(img: np.ndarray, dh: int, dw: int, mode: str = "auto") -> np.ndarray:
    """`resize_u8` in compiled host code (`yp_host_resize_*_u8`)."""
    from yolopoint_tpu_torch.ops import _build

    img = np.ascontiguousarray(img, np.uint8)
    sh, sw, c = img.shape
    use_area = mode == "area" or (mode == "auto" and dh < sh)
    lib = _build.library()
    fn = lib.yp_host_resize_area_u8 if use_area else lib.yp_host_resize_bilinear_u8
    out = np.empty((dh, dw, c), np.uint8)
    fn(img.ctypes.data_as(ctypes.c_void_p), sh, sw, c, out.ctypes.data_as(ctypes.c_void_p),
       dh, dw)
    return out


def resize_for(device: str | torch.device):
    """The resize a dataset feeding `device` runs: numpy for the CPU, else
    the compiled host code."""
    return resize_u8 if torch.device(device).type == "cpu" else resize_u8_compiled
