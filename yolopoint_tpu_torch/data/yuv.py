"""The YUV-to-BGR conversions `cv2.VideoCapture` runs on decoded frames.

OpenCV converts every decoded frame to `bgr24` with libswscale
(`sws_getCachedContext(..., SWS_BICUBIC)`, same size, default colour
details: ITU-601 coefficients `{104597, 132201, 25675, 53279}` of
`ff_yuv2rgb_coeffs`, limited range for `yuv4xxp`, full range for the JPEG
formats `yuvj4xxp` and grey). Which routine runs depends on the layout; each
rule below was found by sweeps against cv2 5.0 (libswscale 9.5 on x86-64):

* 4:2:0 and 4:2:2 of an even height: the unscaled x86 SIMD converter
  (`libswscale/x86/yuv_2_rgb.asm`, `ff_yuv2rgb_get_func_ptr`), chroma by
  nearest sample (column `x >> 1`; row `y >> 1` in 4:2:0, `y` in 4:2:2; an
  odd width's last column takes the last chroma column). With `cy`, `crv`,
  `cbu`, `cgu`, `cgv` of `ff_yuv2rgb_c_init_tables` (limited range: `cy =
  65536 * 255 / 219`, `oy = 16 << 16`; full range: `cy = 65536`, `oy = 0`
  and the four chroma coefficients times 224 / 255, integer divisions), each
  coefficient `c` enters as the int16 `(c * 2^13 + 2^15) >> 16` and the
  offset as `oy * 2^3 >> 16`; in 16-bit lanes, `pmulhw` being `(a * b) >> 16`:
  `y = ((8 Y - oy') * cy') >> 16` (no saturation: below-black luma makes
  negative terms), `u = 8 U - 1024`, `v = 8 V - 1024`, `b = y + (u cbu' >>
  16)`, `g = y + (u (-cgu') >> 16) + (v (-cgv') >> 16)`, `r = y + (v crv' >>
  16)`, each saturated to 0-255.
* 4:4:4 (any size): swscale's scaled path, which forces full horizontal
  chroma for input whose chroma is not subsampled
  (`SWS_FULL_CHR_H_INT`); at the same size its filters are the identity
  (15-bit samples `x << 7`), and `yuv2rgb_full_1_c` / `yuv2rgb_write_full`
  give `Y' = (512 Y - y_offset) * y_coeff + 2^21`, `R = Y' + 512 (V - 128)
  v2r`, `G = Y' + 512 (V - 128) v2g + 512 (U - 128) u2g`, `B = Y' + 512
  (U - 128) u2b`, clipped to 30 bits and shifted right by 22 (`y_offset =
  oy * 2^9 >> 16`, the coefficients as above, `v2g` and `u2g` negative).
* Grey (`gray8`, full range): the sample in all three channels.

4:2:0 and 4:2:2 of an odd height take swscale's scaled path with the
bicubic vertical chroma filter and the table conversion of `yuv2rgb.c`,
which the port does not reproduce: they raise `NotImplementedError`.

The compiled twin is `yp_yuv_to_bgr` in `ops/csrc/host_video.cpp`.
"""

from __future__ import annotations

import ctypes

import numpy as np

# ff_yuv2rgb_coeffs[SWS_CS_ITU601]: crv, cbu, cgu, cgv
ITU601 = (104597, 132201, 25675, 53279)
# layouts: chroma (horizontal, vertical) subsampling shifts; GREY has no chroma
LAYOUTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "grey": None}
KIND = {"420": 0, "422": 1, "444": 2, "grey": 3}


def coefficients(full_range: bool) -> tuple[int, int, int, int, int, int]:
    """`(cy, crv, cbu, cgu, cgv, oy)` of `ff_yuv2rgb_c_init_tables` (16.16
    fixed point; contrast and saturation at their defaults, brightness 0)."""
    crv, cbu, cgu, cgv = ITU601
    if full_range:
        return 1 << 16, crv * 224 // 255, cbu * 224 // 255, cgu * 224 // 255, cgv * 224 // 255, 0
    return (1 << 16) * 255 // 219, crv, cbu, cgu, cgv, 16 << 16


def _int16(c: int, shift: int) -> int:
    """`roundToInt16(c * 2^shift)` of swscale: `(c * 2^shift + 2^15) >> 16`."""
    return (c * (1 << shift) + (1 << 15)) >> 16


def check_layout(layout: str, height: int) -> None:
    """Raise `NotImplementedError` for a layout swscale converts on its scaled
    path with vertical chroma filtering (an odd height of 4:2:0 or 4:2:2)."""
    if layout not in LAYOUTS:
        raise NotImplementedError(f"pixel layout {layout!r} is not converted by the port")
    if layout in ("420", "422") and height % 2:
        raise NotImplementedError(
            f"a {layout} frame of odd height ({height}): swscale converts it on its scaled "
            "path (bicubic vertical chroma filter), which the port does not reproduce")


def _full_chroma(plane: np.ndarray, layout: str, height: int, width: int) -> np.ndarray:
    hs, vs = LAYOUTS[layout]
    rows = np.arange(height) >> vs
    cols = np.arange(width) >> hs
    return plane[rows[:, None], cols[None, :]].astype(np.int32)


def to_bgr_numpy(y: np.ndarray, u: np.ndarray | None, v: np.ndarray | None, layout: str,
                 full_range: bool) -> np.ndarray:
    """`(H, W, 3)` uint8 BGR of planes `y` `(H, W)` and `u`, `v` at the
    layout's subsampling (at least `ceil` of the halved sides; extra rows and
    columns are not read)."""
    height, width = y.shape
    check_layout(layout, height)
    if layout == "grey":
        return np.repeat(y[:, :, None], 3, axis=2).astype(np.uint8)
    cy, crv, cbu, cgu, cgv, oy = coefficients(full_range)
    uu = _full_chroma(u, layout, height, width)
    vv = _full_chroma(v, layout, height, width)
    yy = y.astype(np.int64)
    if layout == "444":
        yc, off = _int16(cy, 13), _int16(oy, 9)
        y2 = (512 * yy - off) * yc + (1 << 21)
        u2, v2 = 512 * (uu.astype(np.int64) - 128), 512 * (vv.astype(np.int64) - 128)
        bgr = np.stack([y2 + u2 * _int16(cbu, 13),
                        y2 + v2 * -_int16(cgv, 13) + u2 * -_int16(cgu, 13),
                        y2 + v2 * _int16(crv, 13)], -1)
        return (np.clip(bgr, 0, (1 << 30) - 1) >> 22).astype(np.uint8)
    y1 = ((8 * yy - _int16(oy, 3)) * _int16(cy, 13)) >> 16
    u1, v1 = 8 * uu.astype(np.int64) - 1024, 8 * vv.astype(np.int64) - 1024
    bgr = np.stack([y1 + ((u1 * _int16(cbu, 13)) >> 16),
                    y1 + ((u1 * -_int16(cgu, 13)) >> 16) + ((v1 * -_int16(cgv, 13)) >> 16),
                    y1 + ((v1 * _int16(crv, 13)) >> 16)], -1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def to_bgr_compiled(y: np.ndarray, u: np.ndarray | None, v: np.ndarray | None, layout: str,
                    full_range: bool) -> np.ndarray:
    """`to_bgr_numpy` in compiled host code (`yp_yuv_to_bgr`)."""
    from yolopoint_tpu_torch.ops import _build

    height, width = y.shape
    check_layout(layout, height)
    y = np.ascontiguousarray(y, np.uint8)
    if layout == "grey":
        u = v = np.zeros((1, 1), np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    if u.shape != v.shape:
        raise ValueError("chroma planes differ in shape")
    out = np.empty((height, width, 3), np.uint8)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    status = _build.library().yp_yuv_to_bgr(p(y), p(u), p(v), height, width, u.shape[1],
                                             KIND[layout], int(full_range), p(out))
    if status:
        raise RuntimeError(f"yp_yuv_to_bgr: bad parameters (status {status})")
    return out


def to_bgr(y, u, v, layout: str, full_range: bool, compiled: bool) -> np.ndarray:
    """`to_bgr_compiled` or `to_bgr_numpy`."""
    return (to_bgr_compiled if compiled else to_bgr_numpy)(y, u, v, layout, full_range)
