"""BMP reading without OpenCV or Pillow.

`decode_bmp(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns
for a Windows bitmap: uint8 `(H, W, 3)` in BGR order. Read are what OpenCV
5's decoder (`grfmt_bmp.cpp`) reads: 1-, 4- and 8-bit files with a palette,
16-bit files (`BI_RGB`, read as 5-5-5, or `BI_BITFIELDS` with the 5-5-5 or
5-6-5 masks, which OpenCV reads just after the info header; each channel's
bits shifted to the top of its byte), 24-bit BGR and 32-bit BGRX / BGRA
(`BI_RGB` or `BI_BITFIELDS` with any masks: OpenCV ignores them and takes
the bytes as B, G, R; the fourth is dropped), stored bottom-up (a positive
height) or top-down (a negative one), with any info header of 36 bytes or
more, or the 12-byte `BITMAPCOREHEADER` (palette entries of 3 bytes); and
run-length coded files (`BI_RLE8` at 8 bits, `BI_RLE4` at 4) as OpenCV's
decoder reads them: end-of-line, end-of-bitmap and delta codes and absolute
runs, the pixels a code skips given palette entry 0 (OpenCV 5's RLE4 reads
a delta as dx pixels and an end-of-bitmap as an end-of-line). With `grey`,
the `(H, W)` image of `cv2.IMREAD_GRAYSCALE`: the colour pixels (palette
entries) through OpenCV's own converter (`data/native.py:cv_bgr_to_grey`).

The run-length decode and the grey conversion run in compiled host code
(`yp_bmp_rle`, `yp_grey_u8` in `ops/csrc/host_image.cpp`) for `device` cuda
and in their numpy twins (`rle_numpy`, `native.cv_bgr_to_grey`) for `device`
cpu only; the uncompressed pixels are numpy on every device. Any other
depth, compression or 16-bit mask set (`cv2.imread` returns None), a
malformed file, or a run that leaves its row (where OpenCV stops and leaves
the rest of its image unset), raises `Unreadable`.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
# the (R, G, B) masks of a 16-bit BI_BITFIELDS file that OpenCV reads: 5-5-5, 5-6-5
MASKS_555, MASKS_565 = (0x7C00, 0x03E0, 0x001F), (0xF800, 0x07E0, 0x001F)
RLE_STATUS = {1: "bad parameters", 2: "a run leaves its row", 3: "the data ends before the image"}


def rle_numpy(data: bytes, bpp: int, W: int, H: int, bottom_up: bool,
              palette: np.ndarray) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR of run-length coded pixels (`data` from the
    pixel offset on) through `palette` (256 BGR entries), as OpenCV's
    `BmpDecoder::readData` decodes `BI_RLE8` (bpp 8) and `BI_RLE4` (bpp 4):
    the twin of `yp_bmp_rle`. Raises `Unreadable` where a run leaves its
    row or the data ends first."""
    out = np.zeros((H, W, 3), np.uint8)
    rows = out[::-1] if bottom_up else out  # file order
    x = y = p = 0
    line_end_flag = False

    def fill(count: int, index: int) -> None:  # FillUniColor: runs on into the next row
        nonlocal x, y
        while True:
            end = min(x + count, W)
            count -= end - x
            rows[y, x:end] = palette[index]
            x = end
            if x >= W:
                x, y = 0, y + 1
                if y >= H:
                    return
            if count <= 0:
                return

    def need(n: int) -> None:
        if p + n > len(data):
            raise Unreadable(RLE_STATUS[3])

    while True:
        need(2)
        n, code = data[p], data[p + 1]
        p += 2
        if n:  # encoded run
            if x + n > W:
                raise Unreadable(RLE_STATUS[2])
            if bpp == 8:
                y0 = y
                fill(n, code)
                line_end_flag = y != y0
                if y >= H:
                    break
            else:
                rows[y, x:x + n] = palette[np.where(np.arange(n) & 1, code & 15, code >> 4)]
                x += n
        elif code > 2:  # absolute run, padded to a word
            if x + code > W:
                raise Unreadable(RLE_STATUS[2])
            size = (code + 1) & ~1 if bpp == 8 else (((code + 1) >> 1) + 1) & ~1
            need(size)
            raw = np.frombuffer(data, np.uint8, size, p)
            idx = raw[:code] if bpp == 8 else np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:code]
            rows[y, x:x + code] = palette[idx]
            x += code
            p += size
            line_end_flag = False
        else:  # end of line (0), end of bitmap (1), delta (2)
            dx, dy = W - x, H - y
            if bpp == 4 or code or not line_end_flag or dx < W:
                if code == 2:
                    need(2)
                    dx, dy = data[p], data[p + 1]
                    p += 2
                if y >= H:
                    break
                # RLE8: a delta moves on by dy rows too, end-of-bitmap fills
                # the rest of the image; RLE4: a delta skips dx pixels,
                # end-of-bitmap ends the row as end-of-line does
                fill(dx + (dy * W if bpp == 8 and code else 0), 0)
                if y >= H:
                    break
            line_end_flag = False
            if y >= H:
                break
    return out


def rle_compiled(data: bytes, bpp: int, W: int, H: int, bottom_up: bool,
                 palette: np.ndarray) -> np.ndarray:
    """`rle_numpy` in compiled host code (`yp_bmp_rle`)."""
    from yolopoint_tpu_torch.ops import _build

    src = np.frombuffer(data, np.uint8)
    pal = np.ascontiguousarray(palette, np.uint8)
    out = np.empty((H, W, 3), np.uint8)
    status = _build.library().yp_bmp_rle(src.ctypes.data_as(ctypes.c_void_p), len(src), bpp, W,
                                         H, int(bottom_up), pal.ctypes.data_as(ctypes.c_void_p),
                                         out.ctypes.data_as(ctypes.c_void_p))
    if status == 1:  # only a caller's fault
        raise RuntimeError(f"yp_bmp_rle: {RLE_STATUS[1]}")
    if status:
        raise Unreadable(RLE_STATUS.get(status, f"status {status}"))
    return out


def decode_bmp(data: bytes, name: str = "<bmp>", device: str | torch.device = "cuda",
               grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of BMP bytes, or with `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for

    if len(data) < 26 or not data.startswith(SIGNATURE):
        raise Unreadable(f"{name}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:
        w, h, _, bpp = struct.unpack_from("<HhHH", data, 18)
        compression, ncolors, entry = BI_RGB, 0, 3
        readable = bpp in (1, 4, 8, 24, 32)
    elif 36 <= hsize < 1 << 31 and len(data) >= 14 + hsize:
        w, h, _, bpp, compression = struct.unpack_from("<iiHHI", data, 18)
        (ncolors,) = struct.unpack_from("<I", data, 46)
        entry = 4
        readable = ((bpp in (1, 4, 8, 24, 32) and compression == BI_RGB)
                    or (bpp in (16, 32) and compression == BI_BITFIELDS)
                    or (bpp, compression) in ((16, BI_RGB), (4, BI_RLE4), (8, BI_RLE8)))
    else:
        raise Unreadable(f"{name}: unknown BMP header of {hsize} bytes")
    if not readable:
        raise Unreadable(f"{name}: {bpp}-bit BMP of compression {compression} is not read "
                         "by OpenCV")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise Unreadable(f"{name}: bad size {w}x{h}")
    depth = bpp
    if bpp == 16:  # 5-5-5 (depth 15) unless the masks say 5-6-5
        depth = 15
        if compression == BI_BITFIELDS:
            if 14 + hsize + 12 > len(data):
                raise Unreadable(f"{name}: the file ends inside the masks")
            masks = struct.unpack_from("<III", data, 14 + hsize)
            if masks not in (MASKS_555, MASKS_565):
                raise Unreadable(f"{name}: 16-bit masks {masks} are not read by OpenCV")
            depth = 16 if masks == MASKS_565 else 15
    to_grey = grey_for(device).bgr
    if bpp <= 8:
        if ncolors > 256:
            raise Unreadable(f"{name}: {ncolors} palette entries")
        n = ncolors or 1 << bpp
        start = 14 + hsize
        pal = np.zeros((256, 3), np.uint8)
        avail = min(n, 256, (offset - start) // entry)
        table = np.frombuffer(data, np.uint8, avail * entry, start).reshape(avail, entry)
        pal[:avail] = table[:, :3]
    if compression in (BI_RLE8, BI_RLE4):
        decode = rle_numpy if torch.device(device).type == "cpu" else rle_compiled
        try:
            img = decode(data[offset:], bpp, w, h, not top_down, pal)
        except Unreadable as e:
            raise Unreadable(f"{name}: {e}") from e
        return to_grey(img) if grey else img
    stride = (w * bpp + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise Unreadable(f"{name}: {len(data) - offset} bytes of pixels, want {stride * h}")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        if bpp == 8:
            idx = rows[:, :w]
        else:  # the first pixel in the high bits of a byte
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp].reshape(h, w, bpp)
            idx = (bits << np.arange(bpp - 1, -1, -1, dtype=np.uint8)).sum(2)
        return to_grey(pal)[idx] if grey else np.ascontiguousarray(pal[idx])
    if bpp == 16:  # little-endian words: each channel's bits at the top of its byte
        t = rows[:, :2 * w].view("<u2").astype(np.int32)
        if depth == 15:
            img = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], 2)
        else:
            img = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], 2)
        img = img.astype(np.uint8)
        return to_grey(img) if grey else img
    c = bpp // 8
    img = rows[:, :w * c].reshape(h, w, c)[..., :3]
    return to_grey(img) if grey else np.ascontiguousarray(img)


def read_bmp(path: str | Path, device: str | torch.device = "cuda",
             grey: bool = False) -> np.ndarray:
    """`decode_bmp` of a file."""
    return decode_bmp(Path(path).read_bytes(), str(path), device, grey)
