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

The host-warp training path's pixel work is here too, in the same two
forms: `warp_perspective_f32` and `warp_coverage_f32`, the counterparts of
the JAX package's functions of those names (the C++ of
`yp_warp_perspective_f32` and `yp_warp_coverage_f32`, whose `-march=native`
build fuses the coordinate steps and the bilinear sums into FMAs), and
`erode`, the binary erosion that `cv2.erode` computes on 0/1 masks.
`host_warp_for(device)` picks the numpy set for the CPU, else the compiled
one (`*_compiled`), which raises where it cannot be built.

The grey reads' colour conversions (`png_rgb_to_grey`: libpng's, which
OpenCV's PNG decoder asks for; `cv_bgr_to_grey`: OpenCV's own, in its BMP
and PxM decoders) and the ROS layer's covariance packing (`cov_pack_upper`,
`cov_unpack_upper`, the JAX package's functions of those names) come in the
same two forms, chosen by `device` the same way; unlike the JAX package's,
the compiled packing has no numpy fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """`std::lround` of non-negative values."""
    t = np.trunc(x)
    return t + (x - t >= 0.5)


def _fma32(a, b, c) -> np.ndarray:
    """f32 `fma(a, b, c)`, rounded once: the product of two f32 values is
    exact in f64, the f64 sum's rounding error is recovered exactly
    (TwoSum), and the sum is rounded to odd before it is rounded to f32,
    which makes the two roundings one."""
    p = np.float64(1.0) * np.asarray(a, np.float32) * np.asarray(b, np.float32)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    inexact = (err != 0) & np.isfinite(s) & np.isfinite(err) & ((s.view(np.int64) & 1) == 0)
    if np.any(inexact):
        s = np.where(inexact, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return np.asarray(s, np.float64).astype(np.float32)


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


# ---- the host-warp path: perspective warp, warp coverage, erosion ----

_F32 = np.float32


def _warp_units(h: int, w: int, hinv: np.ndarray):
    """The `(h, w)` source coordinates before the scale by the half-size,
    `u = (H (xn, yn, 1))_x / (...)_z + 1` (and `_y`), in the library build's
    order of operations and fused steps, with the half-sizes."""
    hv = np.ascontiguousarray(hinv, _F32).reshape(9)
    nx = _F32(2.0) / _F32(w - 1) if w > 1 else _F32(0.0)
    ny = _F32(2.0) / _F32(h - 1) if h > 1 else _F32(0.0)
    yn = _fma32(ny, np.arange(h, dtype=_F32), _F32(-1.0))[:, None]
    xn = _fma32(nx, np.arange(w, dtype=_F32), _F32(-1.0))[None, :]
    bx, by, bd = (_fma32(hv[i], yn, hv[i + 1]) for i in (1, 4, 7))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = _F32(1.0) / _fma32(hv[6], xn, bd)
        ux = _fma32(_fma32(hv[0], xn, bx), inv, _F32(1.0))
        uy = _fma32(_fma32(hv[3], xn, by), inv, _F32(1.0))
    return ux, uy, _F32(0.5) * _F32(w - 1), _F32(0.5) * _F32(h - 1)


def _inside(f: np.ndarray, n: int) -> np.ndarray:
    """Integer-valued floats (floors) that index an axis of length `n`."""
    return (f >= 0) & (f <= n - 1)


def _index(f: np.ndarray, n: int) -> np.ndarray:
    """`f` as an index clipped into the axis (NaN to 0)."""
    return np.clip(np.nan_to_num(f, nan=0.0, posinf=n - 1, neginf=0.0), 0, n - 1).astype(np.int64)


def warp_perspective_f32(img: np.ndarray, hinv: np.ndarray, mode: str = "bilinear") -> np.ndarray:
    """Inverse-warp an `(H, W, C)` (or `(H, W)`) f32 image by a homography in
    normalized coordinates (align-corners grid, zero padding), `mode`
    "bilinear" or "nearest" (`floor(s + 0.5)`): the bytes of the JAX
    package's `warp_perspective_f32`."""
    img = np.ascontiguousarray(img, _F32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, _ = img.shape
    ux, uy, hx, hy = _warp_units(h, w, hinv)
    with np.errstate(invalid="ignore", over="ignore"):
        sx, sy = ux * hx, uy * hy
        if mode == "nearest":
            fx, fy = np.floor(sx + _F32(0.5)), np.floor(sy + _F32(0.5))
            inside = (_inside(fx, w) & _inside(fy, h))[..., None]
            out = np.where(inside, img[_index(fy, h), _index(fx, w)], _F32(0.0))
            return out[..., 0] if squeeze else out
        fx, fy = np.floor(sx), np.floor(sy)
        wx, wy = (sx - fx)[..., None], (sy - fy)[..., None]
    xs, ys = (_index(fx, w), _index(fx + 1, w)), (_index(fy, h), _index(fy + 1, h))
    one = _F32(1.0)
    with np.errstate(invalid="ignore", over="ignore"):
        # pixels whose four taps are in the frame
        interior = ((fx >= 0) & (fx < w - 1) & (fy >= 0) & (fy < h - 1))[..., None]
        v = _fma32(img[ys[0], xs[0]], (one - wy) * (one - wx),
                   img[ys[0], xs[1]] * ((one - wy) * wx))
        v = _fma32(img[ys[1], xs[0]], wy * (one - wx), v)
        v = _fma32(img[ys[1], xs[1]], wy * wx, v)
        # the others: each in-bounds tap, in the order (0, 0), (0, 1), (1, 0), (1, 1)
        acc = np.zeros_like(img)
        for dy in (0, 1):
            ok_y = _inside(fy + dy, h)
            wyv = wy if dy else one - wy
            for dx in (0, 1):
                ok = (ok_y & _inside(fx + dx, w))[..., None]
                wv = wyv * (wx if dx else one - wx)
                acc = np.where(ok, _fma32(wv, img[ys[dy], xs[dx]], acc), acc)
    out = np.where(interior, v, acc)
    return out[..., 0] if squeeze else out


def warp_coverage_f32(hw: tuple[int, int], hinv: np.ndarray) -> np.ndarray:
    """`(H, W)` f32: 1 where the nearest source tap of the inverse warp is in
    the frame (the nearest warp of ones), the bytes of the JAX package's
    `warp_coverage_f32` (whose build fuses the scale and the `+ 0.5`)."""
    h, w = int(hw[0]), int(hw[1])
    ux, uy, hx, hy = _warp_units(h, w, hinv)
    with np.errstate(invalid="ignore", over="ignore"):
        fx = np.floor(_fma32(ux, hx, _F32(0.5)))
        fy = np.floor(_fma32(uy, hy, _F32(0.5)))
    return (_inside(fx, w) & _inside(fy, h)).astype(_F32)


def erode(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Binary erosion of an `(H, W)` 0/1 mask by a 0/1 structuring element
    anchored at `(kh // 2, kw // 2)`, ones outside the frame: what
    `cv2.erode(mask.astype(uint8), kernel)` gives, in the mask's dtype."""
    kh, kw = kernel.shape
    top, left = kh // 2, kw // 2
    padded = np.pad(mask, ((top, kh - 1 - top), (left, kw - 1 - left)), constant_values=1)
    out = np.ones_like(mask)
    for dy in range(kh):
        for dx in range(kw):
            if kernel[dy, dx]:
                out = np.minimum(out, padded[dy:dy + mask.shape[0], dx:dx + mask.shape[1]])
    return out


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _host_lib(lib):
    if lib is not None:
        return lib
    from yolopoint_tpu_torch.ops import _build

    return _build.library()


def warp_perspective_f32_compiled(img: np.ndarray, hinv: np.ndarray, mode: str = "bilinear",
                                  lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`warp_perspective_f32` in compiled host code (`yp_host_warp_perspective_f32`
    of `lib`, by default the kernel library)."""
    img = np.ascontiguousarray(img, _F32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    hv = np.ascontiguousarray(hinv, _F32).reshape(9)
    out = np.empty_like(img)
    _host_lib(lib).yp_host_warp_perspective_f32(
        _ptr(img), ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c), _ptr(hv), _ptr(out),
        ctypes.c_int(1 if mode == "nearest" else 0))
    return out[..., 0] if squeeze else out


def warp_coverage_f32_compiled(hw: tuple[int, int], hinv: np.ndarray,
                               lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`warp_coverage_f32` in compiled host code (`yp_host_warp_coverage_f32`)."""
    h, w = int(hw[0]), int(hw[1])
    hv = np.ascontiguousarray(hinv, _F32).reshape(9)
    out = np.empty((h, w), _F32)
    _host_lib(lib).yp_host_warp_coverage_f32(ctypes.c_int(h), ctypes.c_int(w), _ptr(hv),
                                             _ptr(out))
    return out


def erode_compiled(mask: np.ndarray, kernel: np.ndarray,
                   lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`erode` in compiled host code (`yp_host_erode_f32`), for f32 masks."""
    src = np.ascontiguousarray(mask, _F32)
    k = np.ascontiguousarray(kernel, np.uint8)
    out = np.empty_like(src)
    _host_lib(lib).yp_host_erode_f32(_ptr(src), ctypes.c_int(src.shape[0]),
                                     ctypes.c_int(src.shape[1]), _ptr(k),
                                     ctypes.c_int(k.shape[0]), ctypes.c_int(k.shape[1]),
                                     _ptr(out))
    return out.astype(mask.dtype, copy=False)


class HostWarp(NamedTuple):
    """One form of the host-warp path's pixel functions."""

    warp: Callable[..., np.ndarray]      # (img, hinv, mode="bilinear")
    coverage: Callable[..., np.ndarray]  # (hw, hinv)
    erode: Callable[..., np.ndarray]     # (mask, kernel)
    name: str


NUMPY_WARP = HostWarp(warp_perspective_f32, warp_coverage_f32, erode, "numpy")
COMPILED_WARP = HostWarp(warp_perspective_f32_compiled, warp_coverage_f32_compiled,
                         erode_compiled, "compiled")


def host_warp_for(device: str | torch.device) -> HostWarp:
    """The host warp a run on `device` takes: numpy for the CPU, else the
    compiled host code."""
    return NUMPY_WARP if torch.device(device).type == "cpu" else COMPILED_WARP


# libpng's rgb_to_gray weights for `png_set_rgb_to_gray(png, 1, 0.299,
# 0.587)`: red and green truncated to 15 bits, blue the rest
PNG_GREY = (9797, 19234, 32768 - 9797 - 19234)
# OpenCV's `icvCvt_BGR2Gray_8u_C3C1R`: weights of 14 bits
CV_GREY = (1868, 9617, 4899)  # B, G, R
# OpenCV 5's `cvtColor(COLOR_BGR2GRAY)` of 8-bit pixels: weights of 15 bits
CVT_GREY = (3735, 19235, 9798)  # B, G, R


def _png_reciprocal(a: int) -> int:
    """libpng's `png_reciprocal` of a gamma in units of 1e-5."""
    return int(np.floor(1e10 / a + 0.5))


def _png_gamma_significant(g: int) -> bool:
    return not 95000 <= g <= 105000


def _png_8bit_table(g: int) -> np.ndarray:
    """`png_build_8bit_table`: identity where the gamma is not significant,
    else `png_gamma_8bit_correct` (its floating-point form) of each value."""
    v = np.arange(256)
    if not _png_gamma_significant(g):
        return v.astype(np.uint8)
    inner = (v > 0) & (v < 255)
    out = v.astype(np.float64)
    out[inner] = np.floor(255 * np.power(v[inner] / 255.0, g * 0.00001) + 0.5)
    return out.astype(np.uint8)


def png_gamma_tables(gamma: int) -> Optional[np.ndarray]:
    """`(3, 256)` uint8 tables of libpng's gamma-corrected rgb_to_gray for a
    file gamma (gAMA, or 45455 for sRGB, in units of 1e-5): `gamma_to_1`,
    `gamma_from_1` and `gamma_table` (grey pixels), as
    `png_init_read_transformations` builds them with no screen gamma set
    (the screen taken as the file's reciprocal); None where libpng takes
    the plain path (no gamma, or one within 5% of 1)."""
    if gamma <= 0:
        return None
    screen = _png_reciprocal(gamma)
    if not (_png_gamma_significant(gamma) or _png_gamma_significant(screen)):
        return None
    both = int(np.floor(1e15 / (gamma * screen) + 0.5))  # png_reciprocal2
    return np.stack([_png_8bit_table(_png_reciprocal(gamma)),
                     _png_8bit_table(_png_reciprocal(screen)), _png_8bit_table(both)])


def _png_gamma_16bit_correct(value: int, g: int) -> int:
    """`png_gamma_16bit_correct` (its floating-point form)."""
    if 0 < value < 65535:
        return int(math.floor(65535 * math.pow(value / 65535.0, g * 0.00001) + 0.5))
    return value


def _png_gamma_shift(sig_bit: int) -> int:
    """`png_build_gamma_table`'s `gamma_shift` for a 16-bit file read down to
    8 bits: the insignificant bits of its sBIT (0 for none), at least
    `16 - PNG_MAX_GAMMA_8` (11), at most 8."""
    shift = 16 - sig_bit if 0 < sig_bit < 16 else 0
    return min(max(shift, 16 - 11), 8)


def _png_16bit_lookup(table: np.ndarray, shift: int) -> np.ndarray:
    """A `[low >> shift][high]` table of libpng as a lookup by the 16-bit value."""
    v = np.arange(65536)
    return table[(v & 0xFF) >> shift, v >> 8].astype(np.uint16)


def _png_16bit_table(shift: int, g: int) -> np.ndarray:
    """`png_build_16bit_table` (floating point) as a lookup by the 16-bit value."""
    num = 1 << (8 - shift)
    ig = (np.arange(256)[None] << (8 - shift)) + np.arange(num)[:, None]  # [i][j]
    if _png_gamma_significant(g):
        fmax = 1.0 / ((1 << (16 - shift)) - 1)
        table = np.array([[math.floor(65535.0 * math.pow(x * fmax, g * 0.00001) + 0.5)
                           for x in row] for row in ig.tolist()])
    else:
        big = (1 << (16 - shift)) - 1
        table = (ig * 65535 + (1 << (15 - shift))) // big if shift else ig
    return _png_16bit_lookup(table, shift)


def _png_16to8_table(shift: int, g: int) -> np.ndarray:
    """`png_build_16to8_table` as a lookup by the 16-bit value: each input
    to the 16-bit form (`i * 257`) of the nearest 8-bit output."""
    num, big = 1 << (8 - shift), (1 << (16 - shift)) - 1
    table = np.zeros((num, 256), np.int64)
    last = 0
    for i in range(255):
        out = i * 257
        bound = (_png_gamma_16bit_correct(out + 128, g) * big + 32768) // 65535 + 1
        while last < bound:
            table[last & (0xFF >> shift), last >> (8 - shift)] = out
            last += 1
    while last < (num << 8):
        table[last & (0xFF >> shift), last >> (8 - shift)] = 65535
        last += 1
    return _png_16bit_lookup(table, shift)


@functools.cache
def png_gamma_tables_16(gamma: int, sig_bit: int = 0) -> Optional[np.ndarray]:
    """`(3, 65536)` uint16 lookups of libpng's gamma-corrected rgb_to_gray of
    16-bit RGB read down to 8 bits, by the 16-bit value: `gamma_16_to_1`,
    `gamma_16_from_1` (`png_build_16bit_table`) and `gamma_16_table`, which
    grey pixels take (`png_build_16to8_table` at `png_product2` of the file
    and screen gammas, as libpng builds it with PNG_16_TO_8 set), each
    indexed as libpng indexes its tables (`[(v & 0xff) >> shift][v >> 8]`);
    None where libpng takes the plain path."""
    if png_gamma_tables(gamma) is None:
        return None
    screen = _png_reciprocal(gamma)
    shift = _png_gamma_shift(sig_bit)
    product = int(math.floor(gamma * 1e-5 * screen + 0.5))  # png_product2
    return np.stack([_png_16bit_table(shift, _png_reciprocal(gamma)),
                     _png_16bit_table(shift, _png_reciprocal(screen)),
                     _png_16to8_table(shift, product)])


def png_rgb_to_grey(rgb: np.ndarray, depth: int = 8, gamma: int = 0,
                    sig_bit: int = 0) -> np.ndarray:
    """uint8 grey of `(..., 3)` RGB samples (uint8, or uint16 at depth 16)
    as libpng's rgb_to_gray gives it: 8-bit sums truncated; 16-bit sums
    rounded, then the high byte (`png_set_strip_16`); with a significant
    file `gamma` through `png_gamma_tables` (8-bit) or `png_gamma_tables_16`
    (16-bit, whose table index depends on the sBIT chunk's `sig_bit`)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        tables = png_gamma_tables_16(gamma, sig_bit)
        if tables is not None:
            to1, from1, same = (t.astype(np.int64) for t in tables)
            s = (PNG_GREY[0] * to1[r] + PNG_GREY[1] * to1[g] + PNG_GREY[2] * to1[b] + 16384) >> 15
            return (np.where((r == g) & (g == b), same[r], from1[s]) >> 8).astype(np.uint8)
        s = PNG_GREY[0] * r + PNG_GREY[1] * g + PNG_GREY[2] * b
        return (((s + 16384) >> 15) >> 8).astype(np.uint8)
    tables = png_gamma_tables(gamma)
    if tables is not None:
        to1, from1, same = (t.astype(np.int64) for t in tables)
        s = (PNG_GREY[0] * to1[r] + PNG_GREY[1] * to1[g] + PNG_GREY[2] * to1[b] + 16384) >> 15
        return np.where((r == g) & (g == b), same[r], from1[s]).astype(np.uint8)
    s = PNG_GREY[0] * r + PNG_GREY[1] * g + PNG_GREY[2] * b
    return (s >> 15).astype(np.uint8)


def cv_bgr_to_grey(bgr: np.ndarray) -> np.ndarray:
    """uint8 grey of `(..., 3)` uint8 BGR as OpenCV's BMP and PxM decoders
    convert (`icvCvt_BGR2Gray_8u_C3C1R`, rounded)."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((CV_GREY[0] * b + CV_GREY[1] * g + CV_GREY[2] * r + 8192) >> 14).astype(np.uint8)


def cv_cvt_bgr_to_grey(bgr: np.ndarray) -> np.ndarray:
    """uint8 grey of `(..., 3)` uint8 BGR as OpenCV 5's `cvtColor(...,
    COLOR_BGR2GRAY)` converts (the Radiance, GIF and TIFF decoders' grey)."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    return ((CVT_GREY[0] * b + CVT_GREY[1] * g + CVT_GREY[2] * r + 16384) >> 15).astype(np.uint8)


def _grey_compiled(src: np.ndarray, kind: int, shape: tuple, tables=None,
                   lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    out = np.empty(shape, np.uint8)
    tab = np.ascontiguousarray(tables if tables is not None else np.zeros((3, 256)), np.uint8)
    if _host_lib(lib).yp_grey_u8(_ptr(src), ctypes.c_int64(out.size), ctypes.c_int(kind),
                                 _ptr(tab), _ptr(out)):
        raise ValueError(f"yp_grey_u8: unknown kind {kind}")
    return out


def png_rgb_to_grey_compiled(rgb: np.ndarray, depth: int = 8, gamma: int = 0,
                             sig_bit: int = 0, lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`png_rgb_to_grey` in compiled host code (`yp_grey_u8` kinds 0, 1, 3, 4)."""
    if depth == 16:
        src = np.ascontiguousarray(rgb[..., :3], ">u2")
        tables16 = png_gamma_tables_16(gamma, sig_bit)
        if tables16 is not None:
            return _grey_compiled(src, 4, rgb.shape[:-1], tables16.view(np.uint8), lib)
        return _grey_compiled(src, 1, rgb.shape[:-1], lib=lib)
    tables = png_gamma_tables(gamma)
    src = np.ascontiguousarray(rgb[..., :3], np.uint8)
    if tables is not None:
        return _grey_compiled(src, 3, rgb.shape[:-1], tables, lib)
    return _grey_compiled(src, 0, rgb.shape[:-1], lib=lib)


def cv_bgr_to_grey_compiled(bgr: np.ndarray, lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`cv_bgr_to_grey` in compiled host code (`yp_grey_u8` kind 2)."""
    return _grey_compiled(np.ascontiguousarray(bgr[..., :3], np.uint8), 2, bgr.shape[:-1], lib=lib)


def cv_cvt_bgr_to_grey_compiled(bgr: np.ndarray,
                                lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`cv_cvt_bgr_to_grey` in compiled host code (`yp_grey_u8` kind 5)."""
    return _grey_compiled(np.ascontiguousarray(bgr[..., :3], np.uint8), 5, bgr.shape[:-1], lib=lib)


class GreyConvert(NamedTuple):
    """One form of the grey reads' conversions."""

    png: Callable[..., np.ndarray]  # (rgb, depth=8, gamma=0, sig_bit=0)
    bgr: Callable[..., np.ndarray]  # (bgr): icvCvt_BGR2Gray
    cvt: Callable[..., np.ndarray]  # (bgr): cvtColor(COLOR_BGR2GRAY)


def grey_for(device: str | torch.device) -> GreyConvert:
    """The grey conversions a run on `device` takes: numpy for the CPU,
    else compiled."""
    if torch.device(device).type == "cpu":
        return GreyConvert(png_rgb_to_grey, cv_bgr_to_grey, cv_cvt_bgr_to_grey)
    return GreyConvert(png_rgb_to_grey_compiled, cv_bgr_to_grey_compiled,
                       cv_cvt_bgr_to_grey_compiled)


def cov_pack_upper(full: np.ndarray, device: str | torch.device = "cuda") -> np.ndarray:
    """Symmetric `(n, n)` -> its upper triangle packed row by row, f32 (the
    packing of `covariance_helper.h`). `device` cpu packs in numpy, any
    other in compiled host code (`yp_cov_pack_upper`)."""
    full = np.ascontiguousarray(full, np.float32)
    n = full.shape[0]
    if torch.device(device).type == "cpu":
        return full[np.triu_indices(n)].astype(np.float32)
    out = np.empty(n * (n + 1) // 2, np.float32)
    _host_lib(None).yp_cov_pack_upper(_ptr(full), ctypes.c_int(n), _ptr(out))
    return out


def cov_unpack_upper(packed: np.ndarray, n: int,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """The packed upper triangle -> the symmetric `(n, n)` f32 matrix."""
    packed = np.ascontiguousarray(packed, np.float32)
    if packed.size != n * (n + 1) // 2:
        raise ValueError(f"{packed.size} packed values for n = {n}, want {n * (n + 1) // 2}")
    if torch.device(device).type == "cpu":
        full = np.zeros((n, n), np.float32)
        iu = np.triu_indices(n)
        full[iu] = packed
        full[(iu[1], iu[0])] = packed
        return full
    out = np.empty((n, n), np.float32)
    _host_lib(None).yp_cov_unpack_upper(_ptr(packed), ctypes.c_int(n), _ptr(out))
    return out
