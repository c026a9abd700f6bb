"""BMP reading without OpenCV or Pillow.

`decode_bmp(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns
for an uncompressed Windows bitmap: uint8 `(H, W, 3)` in BGR order. Read are
24-bit BGR, 32-bit BGRX / BGRA (`BI_RGB`, or `BI_BITFIELDS` with the
standard masks; the fourth byte is dropped) and 8-bit files with a palette,
stored bottom-up (a positive height) or top-down (a negative one), with any
of the info headers from `BITMAPINFOHEADER` (40 bytes) up, or the 12-byte
`BITMAPCOREHEADER` (palette entries of 3 bytes). Run-length coded files
and other depths raise `NotImplementedError`; a malformed file raises
`ValueError`.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

SIGNATURE = b"BM"
BI_RGB, BI_BITFIELDS = 0, 3
BGRA_MASKS = (0x00FF0000, 0x0000FF00, 0x000000FF)  # R, G, B of a 32-bit BI_BITFIELDS file


def decode_bmp(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of BMP bytes."""
    if len(data) < 26 or not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:
        w, h, _, bpp = struct.unpack_from("<HhHH", data, 18)
        compression, ncolors, entry = BI_RGB, 0, 3
    elif hsize >= 40 and len(data) >= 14 + hsize:
        w, h, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
        (ncolors,) = struct.unpack_from("<I", data, 46)
        entry = 4
    else:
        raise ValueError(f"{name}: unknown BMP header of {hsize} bytes")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: bad size {w}x{h}")
    if bpp not in (8, 24, 32):
        raise NotImplementedError(f"{name}: {bpp}-bit BMP files are not read")
    if compression == BI_BITFIELDS and bpp == 32:
        masks = struct.unpack_from("<III", data, 54) if hsize >= 52 or offset >= 66 else None
        if masks != BGRA_MASKS:
            raise NotImplementedError(f"{name}: 32-bit BMP with masks {masks} is not read")
    elif compression != BI_RGB:
        raise NotImplementedError(f"{name}: compressed (type {compression}) BMP files are not read")
    stride = (w * bpp // 8 + 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: {len(data) - offset} bytes of pixels, want {stride * h}")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        n = ncolors or 256
        start = 14 + hsize
        pal = np.zeros((256, 3), np.uint8)
        avail = min(n, 256, (offset - start) // entry)
        table = np.frombuffer(data, np.uint8, avail * entry, start).reshape(avail, entry)
        pal[:avail] = table[:, :3]
        return np.ascontiguousarray(pal[rows[:, :w]])
    c = bpp // 8
    return np.ascontiguousarray(rows[:, :w * c].reshape(h, w, c)[..., :3])


def read_bmp(path: str | Path) -> np.ndarray:
    """`decode_bmp` of a file."""
    return decode_bmp(Path(path).read_bytes(), str(path))
