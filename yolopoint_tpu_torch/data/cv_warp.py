"""OpenCV's 8-bit image warps, as `cv2` 5.0 computes them, without `cv2`.

The synthetic-data tools of the JAX package warp uint8 images with OpenCV:
`tools/make_synthetic_hpatches.py` views a scene through
`cv2.warpPerspective(src, M, (W, H), flags=INTER_LINEAR)` (border constant
0) and `tools/make_synthetic_sequence.py` pans a camera with
`cv2.warpAffine(src, A, (W, H), flags=WARP_INVERSE_MAP,
borderMode=BORDER_REFLECT)`, whose interpolation bits are 0: nearest.
These are their counterparts, equal to them byte for byte:

- `warp_perspective_u8(src, M, (W, H))` and `warp_affine_u8(src, A, (W, H))`
  are the numpy versions, the plain ones, used on the CPU;
- `warp_perspective_u8_compiled` and `warp_affine_u8_compiled` run the same
  arithmetic in compiled host code (`yp_cv_warp_perspective_u8`,
  `yp_cv_warp_affine_u8` of `ops/csrc/host_image.cpp`, built with the CUDA
  kernels) for a GPU run;
- `cv_warp_for(device)` picks one form; there is no fallback from one to
  the other.

OpenCV 5 warps 8-bit images in f32, not with the fixed-point remap of
OpenCV 4 (found by sweeps against `cv2` 5.0.0, `tests/test_torch_cv_warp.py`):

- the matrix is inverted in f64 (`cv::invert`'s closed form for 3x3) unless
  the map is given inverse, then rounded to f32;
- the pixels of a row go 16 at a time through vector code, which computes
  the row's constant `y * m1 + m2` in f32 and then `fma(x, m0, c)`; the
  `W % 16` pixels left at the row's end go through scalar code compiled with
  FMA contraction, `fma(x, m0, y * m1) + m2`. The perspective divides
  `sx / w`, `sy / w`;
- bilinear: `ix = floor(sx)`, `dx = sx - ix`, each row mixed as
  `fma(dx, p01 - p00, p00)` and the rows as `fma(dy, v1 - v0, v0)`, rounded
  to nearest even and saturated; a tap outside the source reads the border
  value;
- nearest: `ix = rint(sx)` (half to even), then the border rule.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.data.native import _fma32, _ptr, _host_lib

_F32 = np.float32
VECTOR_PIXELS = 16  # pixels a step of OpenCV's vector loop (the rest: scalar)
_INT_MIN = -(2 ** 31)


def invert_3x3(m: np.ndarray) -> np.ndarray:
    """`cv::invert(m, DECOMP_LU)` of a 3x3 f64 matrix: the closed form
    OpenCV uses at that size (determinant by cofactors, its reciprocal times
    the adjugate), as 9 values."""
    s = np.asarray(m, np.float64).reshape(3, 3)
    d = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
         - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
         + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if d == 0.0:
        raise ValueError("warp_perspective_u8: the matrix is singular")
    d = 1.0 / d
    return np.array([
        (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1]) * d,
        (s[0, 2] * s[2, 1] - s[0, 1] * s[2, 2]) * d,
        (s[0, 1] * s[1, 2] - s[0, 2] * s[1, 1]) * d,
        (s[1, 2] * s[2, 0] - s[1, 0] * s[2, 2]) * d,
        (s[0, 0] * s[2, 2] - s[0, 2] * s[2, 0]) * d,
        (s[0, 2] * s[1, 0] - s[0, 0] * s[1, 2]) * d,
        (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]) * d,
        (s[0, 1] * s[2, 0] - s[0, 0] * s[2, 1]) * d,
        (s[0, 0] * s[1, 1] - s[0, 1] * s[1, 0]) * d,
    ], np.float64)


def _affine_rows(m: np.ndarray, W: int, H: int) -> tuple[np.ndarray, ...]:
    """`(x*m0 + y*m1 + m2, x*m3 + y*m4 + m5)` in f32, (H, W) each, as
    OpenCV's vector steps and scalar tail compute them."""
    xs = np.arange(W, dtype=_F32)[None, :]
    ys = np.arange(H, dtype=_F32)[:, None]
    nv = (W // VECTOR_PIXELS) * VECTOR_PIXELS
    out = []
    for a, b, c in ((m[0], m[1], m[2]), (m[3], m[4], m[5]), (m[6], m[7], m[8])):
        row = _fma32(xs, a, (ys * b + c).astype(_F32)).astype(_F32)
        tail = (_fma32(xs, a, (ys * b).astype(_F32)).astype(_F32) + c).astype(_F32)
        row[:, nv:] = tail[:, nv:]
        out.append(row)
    return tuple(out)


def _to_int(v: np.ndarray, fn) -> np.ndarray:
    """`fn(v)` as int32 conversion gives it: out of range or NaN -> INT_MIN."""
    r = fn(v.astype(np.float64))
    ok = np.isfinite(r) & (r >= _INT_MIN) & (r < 2 ** 31)
    return np.where(ok, r, _INT_MIN).astype(np.int64)


def _as_hwc(src: np.ndarray) -> tuple[np.ndarray, bool]:
    src = np.ascontiguousarray(src)
    if src.dtype != np.uint8 or src.ndim not in (2, 3):
        raise ValueError(f"a uint8 (H, W) or (H, W, C) image is needed, got {src.dtype} "
                         f"{src.shape}")
    return (src[..., None], True) if src.ndim == 2 else (src, False)


def warp_perspective_u8(src: np.ndarray, M: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """`cv2.warpPerspective(src, M, dsize, flags=cv2.INTER_LINEAR)` (border
    constant 0) of a uint8 `(H, W)` or `(H, W, C)` image:
    `dst(x, y) = src(M^-1 (x, y))`, bilinear. `dsize` is `(W, H)`."""
    img, squeeze = _as_hwc(src)
    W, H = int(dsize[0]), int(dsize[1])
    m = invert_3x3(M).astype(_F32)
    X, Y, Wt = _affine_rows(m, W, H)
    sx, sy = (X / Wt).astype(_F32), (Y / Wt).astype(_F32)
    sh, sw, _ = img.shape
    ix, iy = _to_int(sx, np.floor), _to_int(sy, np.floor)
    dx = (sx - ix.astype(_F32)).astype(_F32)[..., None]
    dy = (sy - iy.astype(_F32)).astype(_F32)[..., None]

    def tap(py, px):
        inside = (px >= 0) & (px < sw) & (py >= 0) & (py < sh)
        got = img[np.clip(py, 0, sh - 1), np.clip(px, 0, sw - 1)].astype(_F32)
        return np.where(inside[..., None], got, _F32(0))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma32(dx, p01 - p00, p00).astype(_F32)
    v1 = _fma32(dx, p11 - p10, p10).astype(_F32)
    v = _fma32(dy, v1 - v0, v0).astype(_F32)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def reflect(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's `BORDER_REFLECT` index (`fedcba|abcdef|fedcba`), any distance."""
    if n == 1:
        return np.zeros_like(p)
    q = np.mod(p, 2 * n)
    return np.where(q >= n, 2 * n - 1 - q, q)


def warp_affine_u8(src: np.ndarray, A: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """`cv2.warpAffine(src, A, dsize, flags=cv2.WARP_INVERSE_MAP,
    borderMode=cv2.BORDER_REFLECT)` of a uint8 `(H, W)` or `(H, W, C)` image:
    `dst(x, y) = src(A (x, y, 1))`, nearest (the flags' interpolation bits
    are 0). `A` is 2x3; `dsize` is `(W, H)`."""
    img, squeeze = _as_hwc(src)
    W, H = int(dsize[0]), int(dsize[1])
    m = np.concatenate([np.asarray(A, np.float64).reshape(6), [0.0, 0.0, 1.0]]).astype(_F32)
    X, Y, _ = _affine_rows(m, W, H)
    sh, sw, _ = img.shape
    ix, iy = _to_int(X, np.rint), _to_int(Y, np.rint)
    out = img[reflect(iy, sh), reflect(ix, sw)]
    return out[..., 0] if squeeze else out


def _compiled(entry: str, src: np.ndarray, m: np.ndarray, dsize,
              lib: Optional[ctypes.CDLL]) -> np.ndarray:
    img, squeeze = _as_hwc(src)
    W, H = int(dsize[0]), int(dsize[1])
    sh, sw, c = img.shape
    mv = np.ascontiguousarray(m, _F32).reshape(9)
    out = np.empty((H, W, c), np.uint8)
    code = getattr(_host_lib(lib), entry)(
        _ptr(img), ctypes.c_int(sh), ctypes.c_int(sw), ctypes.c_int(c), _ptr(mv), _ptr(out),
        ctypes.c_int(H), ctypes.c_int(W))
    if code:
        raise ValueError(f"{entry}: error {code}")
    return out[..., 0] if squeeze else out


def warp_perspective_u8_compiled(src: np.ndarray, M: np.ndarray, dsize: tuple[int, int],
                                 lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`warp_perspective_u8` in compiled host code (`yp_cv_warp_perspective_u8`
    of `lib`, by default the kernel library); the inverse is taken here."""
    return _compiled("yp_cv_warp_perspective_u8", src, invert_3x3(M).astype(_F32), dsize, lib)


def warp_affine_u8_compiled(src: np.ndarray, A: np.ndarray, dsize: tuple[int, int],
                            lib: Optional[ctypes.CDLL] = None) -> np.ndarray:
    """`warp_affine_u8` in compiled host code (`yp_cv_warp_affine_u8`)."""
    m = np.concatenate([np.asarray(A, np.float64).reshape(6), [0.0, 0.0, 1.0]])
    return _compiled("yp_cv_warp_affine_u8", src, m.astype(_F32), dsize, lib)


class CvWarp(NamedTuple):
    """One form of the two warps."""

    perspective: Callable[..., np.ndarray]  # (src, M, (W, H))
    affine: Callable[..., np.ndarray]       # (src, A, (W, H))
    name: str


NUMPY_CV_WARP = CvWarp(warp_perspective_u8, warp_affine_u8, "numpy")
COMPILED_CV_WARP = CvWarp(warp_perspective_u8_compiled, warp_affine_u8_compiled, "compiled")


def cv_warp_for(device: str | torch.device) -> CvWarp:
    """The warps a run on `device` takes: numpy for the CPU, else the
    compiled host code (which raises where it cannot be built)."""
    return NUMPY_CV_WARP if torch.device(device).type == "cpu" else COMPILED_CV_WARP
