"""Sun raster reading without OpenCV.

`decode_sunras(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a Sun raster file, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`, as OpenCV 5's decoder (`grfmt_sunras.cpp`) reads
them, found by sweeps against it:

* the header: eight big-endian 32-bit words (magic `59 A6 6A 95`, width,
  height, depth, length, type, map type, map length). Read are the old (0)
  and standard (1) types only: OpenCV's header check tests its own image
  type field where it means the file's, so a byte-encoded (2, run-length)
  or RGB-order (3) file, as any other type, is one `cv2.imread` returns None
  for. The depth is 1, 8, 24 or 32; the map is none (type 0, length 0) or an
  equal-RGB map (type 1) of 1 to `2**depth` entries at depth 1 or 8 (three
  planes of `length // 3` bytes: red, green, blue; entries past them black).
* rows padded to 16 bits; bits MSB first; 24-bit pixels B, G, R and 32-bit
  ones X, B, G, R.
* a colour read maps 1- and 8-bit pixels through the map, or without one
  through the grey ramp `i * 255 // (2**depth - 1)`. A grey read maps them
  through the map's grey (OpenCV's converter,
  `native.cv_bgr_to_grey`); without a map OpenCV's grey table is left at
  zeros, so a grey read of a 1- or 8-bit file without a map is black.
  24- and 32-bit pixels go to grey through the same converter.

A malformed or short file (what `cv2.imread` returns None for) raises
`Unreadable`. The pixel work is numpy on every device (there is no
sequential decode: the run-length type is never read); the grey conversion
of 24- and 32-bit files runs in compiled host code for `device` cuda
(`native.grey_for`).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE

SIGNATURE = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD = 0, 1
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def decode_sunras(data: bytes, name: str = "<ras>", device: str | torch.device = "cuda",
                  grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of Sun raster bytes, or with `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import cv_bgr_to_grey, grey_for

    if len(data) < 32 or not data.startswith(SIGNATURE):
        raise Unreadable(f"{name}: not a Sun raster file")
    w, h, depth, _, kind, maptype, maplen = struct.unpack_from(">7i", data, 4)
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (w > 0 and h > 0 and depth in (1, 8, 24, 32) and kind in (RT_OLD, RT_STANDARD)
            and ((maptype == RMT_NONE and maplen == 0)
                 or (maptype == RMT_EQUAL_RGB and 0 < maplen <= pal_size and depth <= 8))):
        raise Unreadable(f"{name}: a Sun raster of depth {depth}, type {kind}, map type "
                         f"{maptype} and map length {maplen} is not read by OpenCV")
    if max(w, h) > MAX_SIDE or w * h > MAX_PIXELS:
        raise Unreadable(f"{name}: a {w}x{h} image is too large to read")
    if 32 + maplen > len(data):
        raise Unreadable(f"{name}: the file ends inside the colour map")
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    offset = 32 + maplen
    if offset + pitch * h > len(data):
        raise Unreadable(f"{name}: {len(data) - offset} bytes of pixels, want {pitch * h}")
    rows = np.frombuffer(data, np.uint8, pitch * h, offset).reshape(h, pitch)
    if depth > 8:
        c = depth // 8
        bgr = rows[:, :w * c].reshape(h, w, c)[..., c - 3:]
        return grey_for(device).bgr(bgr) if grey else bgr.copy()
    if depth == 8:
        idx = rows[:, :w]
    else:
        idx = np.unpackbits(rows, axis=1)[:, :w]
    if maplen:
        n = maplen // 3
        pal = np.zeros((256, 3), np.uint8)
        planes = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)  # R, G, B
        pal[:n] = planes[::-1].T
    else:
        ramp = (np.arange(1 << depth) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        pal = np.repeat(ramp[:, None], 3, axis=1)
    if grey:
        table = cv_bgr_to_grey(pal) if maplen else np.zeros(len(pal), np.uint8)
        return table[idx]
    return pal[idx]


def read_sunras(path: str | Path, device: str | torch.device = "cuda",
                grey: bool = False) -> np.ndarray:
    """`decode_sunras` of a file."""
    return decode_sunras(Path(path).read_bytes(), str(path), device, grey)
