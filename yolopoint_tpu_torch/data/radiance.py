"""Radiance HDR (RGBE) reading without OpenCV.

`decode_radiance(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a Radiance picture, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`, as OpenCV 5's decoder (`grfmt_hdr.cpp` over Bruce
Walter's `rgbe.c`) reads them, found by sweeps against it:

* the header (`RGBE_ReadHeader`), line by line as `fgets` of 128 bytes
  reads them (a line ends after `\\n` or 127 bytes): lines up to the exact
  line `FORMAT=32-bit_rle_rgbe\\n` are skipped (an empty one or a file
  that ends first is refused), the next must be `\\n`, the next holds the
  size as `sscanf(line, "-Y %d +X %d")` reads it. A side of 0 or less is
  refused.
* the pixels (`RGBE_ReadPixels_RLE`): below width 8 or above 32767 every
  pixel is flat (R, G, B, E bytes); else each scanline starts with `2 2`
  and the width in 15 bits, then the four channels in turn as runs (a count
  byte above 128: that many minus 128 of the next byte) and literals (a
  count of 1..128 bytes). A scanline that does not start so is read flat
  from its first pixel to the end of the image. A count of 0, a run past
  its channel's end, a wrong width or data that ends first are refused.
* each pixel's value `(R, G, B) * 2**(E - 136)` (0 where E is 0), times 255
  in float32, rounded to the nearest integer, ties to even, saturated to
  0..255, as B, G, R; a value of 2**31 and up (and infinity: E near 255)
  reads as 0 (`cvRound` gives INT_MIN). A grey read is OpenCV's
  `cvtColor(COLOR_BGR2GRAY)` of the colour read (`native.cv_cvt_bgr_to_grey`).

The scanline decode runs in compiled host code (`yp_hdr_rgbe` in
`ops/csrc/host_image.cpp`) for `device` cuda and in its numpy twin
(`rgbe_numpy`) for `device` cpu only; a failed build or a bad status of the
compiled decoder raises. The conversion to 8 bits is numpy on every device,
the grey conversion compiled for cuda (`native.grey_for`).
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
FORMAT_LINE = b"FORMAT=32-bit_rle_rgbe\n"
RGBE_STATUS = {1: "bad parameters", 2: "bad scanline data", 3: "the data ends before the image"}
_WS = rb"[ \t\n\r\x0b\x0c]*"
_SIZE = re.compile(rb"-Y" + _WS + rb"([+-]?\d+)" + _WS + rb"\+X" + _WS + rb"([+-]?\d+)")


def _fgets(data: bytes, pos: int) -> tuple[bytes | None, int]:
    """C's `fgets(buf, 128, fp)` from offset `pos`: the line as a C string
    (cut at a NUL) and the offset after it; None at the end of the file."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end].split(b"\0", 1)[0], end


def parse_header(data: bytes) -> tuple[int, int, int]:
    """`(width, height, pixel offset)` of a Radiance file."""
    line, pos = _fgets(data, 0)
    while True:
        if line is None:
            raise Unreadable("the file ends before FORMAT")
        if line in (b"", b"\n"):
            raise Unreadable("no FORMAT specifier found")
        if line == FORMAT_LINE:
            break
        line, pos = _fgets(data, pos)
    line, pos = _fgets(data, pos)
    if line != b"\n":
        raise Unreadable("missing blank line after FORMAT specifier")
    line, pos = _fgets(data, pos)
    m = _SIZE.match(line or b"")
    if m is None:
        raise Unreadable("missing image size specifier")
    h, w = int(m.group(1)), int(m.group(2))
    return w, h, pos


def rgbe_numpy(data: bytes, W: int, H: int) -> np.ndarray:
    """uint8 `(H, W, 4)` R, G, B, E bytes of the pixel data `data` (from the
    pixel offset on), as `RGBE_ReadPixels_RLE` reads them: the twin of
    `yp_hdr_rgbe`. Raises `Unreadable` where it refuses the data."""
    out = np.empty((H, W, 4), np.uint8)
    flat = out.reshape(-1)
    n = len(data)

    def read_flat(p: int, start: int) -> None:
        need = (H * W - start) * 4
        if p + need > n:
            raise Unreadable(RGBE_STATUS[3])
        flat[start * 4:] = np.frombuffer(data, np.uint8, need, p)

    if W < 8 or W > 0x7FFF:
        read_flat(0, 0)
        return out
    p = 0
    line = np.empty(4 * W, np.uint8)
    for y in range(H):
        if p + 4 > n:
            raise Unreadable(RGBE_STATUS[3])
        head = data[p:p + 4]
        p += 4
        if head[0] != 2 or head[1] != 2 or head[2] & 0x80:  # not run-length coded
            flat[y * W * 4:y * W * 4 + 4] = np.frombuffer(head, np.uint8)
            read_flat(p, y * W + 1)
            return out
        if (head[2] << 8 | head[3]) != W:
            raise Unreadable(RGBE_STATUS[2] + ": wrong scanline width")
        q = 0
        for c in range(4):
            end = (c + 1) * W
            while q < end:
                if p + 2 > n:
                    raise Unreadable(RGBE_STATUS[3])
                count, value = data[p], data[p + 1]
                p += 2
                if count > 128:  # a run
                    count -= 128
                    if count > end - q:
                        raise Unreadable(RGBE_STATUS[2])
                    line[q:q + count] = value
                    q += count
                else:  # a literal
                    if count == 0 or count > end - q:
                        raise Unreadable(RGBE_STATUS[2])
                    line[q] = value
                    if count > 1:
                        if p + count - 1 > n:
                            raise Unreadable(RGBE_STATUS[3])
                        line[q + 1:q + count] = np.frombuffer(data, np.uint8, count - 1, p)
                        p += count - 1
                    q += count
        out[y] = line.reshape(4, W).T
    return out


def rgbe_compiled(data: bytes, W: int, H: int) -> np.ndarray:
    """`rgbe_numpy` in compiled host code (`yp_hdr_rgbe`)."""
    from yolopoint_tpu_torch.ops import _build

    src = np.frombuffer(data, np.uint8)
    out = np.empty((H, W, 4), np.uint8)
    status = _build.library().yp_hdr_rgbe(src.ctypes.data_as(ctypes.c_void_p), len(src), W, H,
                                          out.ctypes.data_as(ctypes.c_void_p))
    if status == 1:  # only a caller's fault
        raise RuntimeError(f"yp_hdr_rgbe: {RGBE_STATUS[1]}")
    if status:
        raise Unreadable(RGBE_STATUS.get(status, f"status {status}"))
    return out


def _rgbe_table() -> np.ndarray:
    """uint8 `(256, 256)`: OpenCV's 8-bit value of mantissa m at exponent e,
    the float value times 255, rounded, saturated, 2**31 and up read as 0
    (`m * 255 * 2**(e - 136)` is exact in float64, as in OpenCV's float32)."""
    e, m = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    r = np.rint(np.ldexp(m * 255.0, e - 136))
    r[(e == 0) | (r >= 2.0 ** 31)] = 0
    return np.minimum(r, 255).astype(np.uint8)


RGBE_TABLE = _rgbe_table()


def rgbe_to_bgr(rgbe: np.ndarray) -> np.ndarray:
    """uint8 BGR of RGBE pixels as OpenCV converts them (`RGBE_TABLE`)."""
    return RGBE_TABLE[rgbe[..., 3:], rgbe[..., 2::-1]]


def decode_radiance(data: bytes, name: str = "<hdr>", device: str | torch.device = "cuda",
                    grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a Radiance file's bytes, or with
    `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for

    if not data.startswith(SIGNATURES):
        raise Unreadable(f"{name}: not a Radiance file")
    try:
        w, h, pos = parse_header(data)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    if not (0 < w and 0 < h) or max(w, h) > MAX_SIDE or w * h > MAX_PIXELS:
        raise Unreadable(f"{name}: a {w}x{h} image is not read")
    decode = rgbe_numpy if torch.device(device).type == "cpu" else rgbe_compiled
    try:
        rgbe = decode(data[pos:], w, h)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    bgr = rgbe_to_bgr(rgbe)
    return grey_for(device).cvt(bgr) if grey else bgr


def read_radiance(path: str | Path, device: str | torch.device = "cuda",
                  grey: bool = False) -> np.ndarray:
    """`decode_radiance` of a file."""
    return decode_radiance(Path(path).read_bytes(), str(path), device, grey)
