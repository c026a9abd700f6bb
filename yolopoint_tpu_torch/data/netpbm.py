"""Netpbm reading and the binary PPM writer, without OpenCV.

`decode_netpbm(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a PBM, PGM or PPM file (`P1` to `P6`), and with `grey` the
`(H, W)` image of `cv2.IMREAD_GRAYSCALE`, as OpenCV 5's PxM decoder
(`grfmt_pxm.cpp`) reads them, found by sweeps against it:

* the header: `P`, the digit, one whitespace byte (the decoder's
  signature), then the width, height and (but for bitmaps) maxval as its
  `ReadNumber` reads them: `#` comments to the end of the line and any
  whitespace before a number, the one byte after a number taken as its end
  (whatever it is), the pixels starting after the maxval's end byte. A
  maxval of 0 or above 65535, a zero side, any other byte before a number
  or a file that ends inside a number raise.
* ASCII samples (`P2`, `P3`) clamped to the maxval, then scaled to 8 bits
  as `v * 255 // maxval` (maxval up to 255) or taken as their high byte
  (maxval 256 and up); ASCII bits (`P1`) one digit at a time, nonzero as 1.
* binary samples (`P5`, `P6`) as they are (maxval up to 255: not scaled,
  not clamped) or the high byte of each big-endian 16-bit sample; binary
  bits (`P4`) packed MSB first, each row padded to a byte. A bit of 1 is
  black (0), a bit of 0 white (255).
* RGB files go to BGR; a grey read of one goes through OpenCV's own
  converter (`data/native.py:cv_bgr_to_grey`); a grey file is repeated to
  three channels in a colour read.

A malformed file (what `cv2.imread` returns None for) raises `Unreadable`.
The pixel work is numpy on every device; the grey conversion of an RGB
file runs in compiled host code for `device` cuda (`native.grey_for`).

`encode_ppm` / `write_ppm` write the file that `cv2.imwrite("x.ppm", img)`
writes: `P6`, the width and height, maxval 255, each followed by one
newline, then the pixels in RGB order (3-channel BGR images only: a grey
image raises there, and here).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

INT_MAX = (1 << 31) - 1
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_WIDTH / _PIXELS
WHITESPACE = frozenset(b" \t\n\r\x0b\x0c")  # C's isspace
_DIGIT = frozenset(b"0123456789")


def is_netpbm(head: bytes) -> bool:
    """OpenCV's PxM signature: `P1`..`P6` and a whitespace byte."""
    return len(head) >= 3 and head[0:1] == b"P" and 49 <= head[1] <= 54 and head[2] in WHITESPACE


def _read_number(data: bytes, pos: int, maxdigits: int = 0) -> tuple[int, int]:
    """OpenCV's `ReadNumber` from offset `pos`: `(value, offset after the
    byte that ended it)`; with `maxdigits`, the number ends after that many
    digits and the next byte is not read."""
    n = len(data)

    def byte(i: int) -> int:
        if i >= n:
            raise Unreadable("the file ends inside a number")
        return data[i]

    code = byte(pos)
    pos += 1
    while code not in _DIGIT:
        if code == 35:  # '#': a comment to the end of the line
            while code not in (10, 13):
                code = byte(pos)
                pos += 1
            code = byte(pos)
            pos += 1
        elif code in WHITESPACE:
            while code in WHITESPACE:
                code = byte(pos)
                pos += 1
        else:
            raise Unreadable(f"unexpected byte {code:#x} before a number")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > INT_MAX:
            raise Unreadable("a number above INT_MAX")
        digits += 1
        if maxdigits and digits >= maxdigits:
            return val, pos
        code = byte(pos)
        pos += 1
        if code not in _DIGIT:
            return val, pos


def _ascii(data: bytes, pos: int, count: int, bits: bool) -> np.ndarray:
    if count > len(data) - pos:  # a number takes a byte at least
        raise Unreadable("the file ends before its samples")
    out = np.empty(count, np.int64)
    for i in range(count):
        out[i], pos = _read_number(data, pos, 1 if bits else 0)
    if bits:
        out = (out != 0).astype(np.int64)
    return out


def decode_netpbm(data: bytes, name: str = "<pnm>", device: str | torch.device = "cuda",
                  grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a `P1`-`P6` file's bytes, or with
    `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for

    if not is_netpbm(data[:3]):
        raise Unreadable(f"{name}: not a PBM/PGM/PPM file")
    kind = data[1] - 48
    try:
        w, pos = _read_number(data, 2)
        h, pos = _read_number(data, pos)
        maxval = 1
        if kind not in (1, 4):
            maxval, pos = _read_number(data, pos)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    if not (0 < w and 0 < h and 0 < maxval <= 0xFFFF):
        raise Unreadable(f"{name}: bad header (width {w}, height {h}, maxval {maxval})")
    if max(w, h) > MAX_SIDE or w * h > MAX_PIXELS:
        raise Unreadable(f"{name}: a {w}x{h} image is too large to read")
    channels = 3 if kind in (3, 6) else 1
    count = w * h * channels
    if kind in (1, 2, 3):
        try:
            vals = _ascii(data, pos, count, kind == 1)
        except Unreadable as e:
            raise Unreadable(f"{name}: {e}") from e
        if kind == 1:
            img = np.where(vals == 1, 0, 255).astype(np.uint8)
        elif maxval <= 255:
            img = (np.minimum(vals, maxval) * 255 // maxval).astype(np.uint8)
        else:
            img = (np.minimum(vals, maxval) >> 8).astype(np.uint8)
    elif kind == 4:
        pitch = (w + 7) // 8
        if len(data) - pos < pitch * h:
            raise Unreadable(f"{name}: {len(data) - pos} bytes of pixels, want {pitch * h}")
        rows = np.frombuffer(data, np.uint8, pitch * h, pos).reshape(h, pitch)
        img = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255).astype(np.uint8)
    else:
        size = count * (2 if maxval > 255 else 1)
        if len(data) - pos < size:
            raise Unreadable(f"{name}: {len(data) - pos} bytes of pixels, want {size}")
        img = np.frombuffer(data, np.uint8, size, pos)
        if maxval > 255:
            img = img[0::2]  # the high byte of each big-endian sample
    img = img.reshape(h, w, channels)
    if channels == 1:
        return img[..., 0].copy() if grey else np.repeat(img, 3, axis=2)
    bgr = np.ascontiguousarray(img[..., ::-1])  # RGB in the file, BGR out
    return grey_for(device).bgr(bgr) if grey else bgr


def read_netpbm(path: str | Path, device: str | torch.device = "cuda",
                grey: bool = False) -> np.ndarray:
    """`decode_netpbm` of a file."""
    return decode_netpbm(Path(path).read_bytes(), str(path), device, grey)


def encode_ppm(bgr: np.ndarray) -> bytes:
    """The PPM file of a uint8 `(H, W, 3)` BGR image."""
    img = np.asarray(bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_ppm takes a uint8 (H, W, 3) BGR image, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img[..., ::-1]).tobytes()


def write_ppm(path: str | Path, bgr: np.ndarray) -> None:
    """`cv2.imwrite(path, bgr)` for a `.ppm` path: `encode_ppm`'s bytes."""
    Path(path).write_bytes(encode_ppm(bgr))
