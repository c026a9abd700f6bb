"""GIF reading without OpenCV.

`decode_gif(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a GIF file, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`, as OpenCV 5's decoder (`grfmt_gif.cpp`) reads its
first frame, found by sweeps against it:

* the logical screen (its size is the image's) is filled with the global
  colour table's background entry, or black without a global table (a
  background index past the table is refused); the first frame's pixels
  go on it at the frame's offset (a frame that leaves the screen is
  refused), through its local colour table or else the global one (neither:
  OpenCV's own, black, white and the grey ramp from 2; a pixel past the
  table is refused), and pixels of the transparent
  index (a Graphic Control Extension before the frame) keep what was under
  them. A disposal method above 3 is refused; extensions of other kinds
  are skipped. The blocks of the whole file are walked to its trailer
  first (`parse`): a file whose blocks break anywhere is refused.
* the pixels are GIF's LZW (least significant bit first, codes of
  `min_size + 1` bits growing to 12, clear codes, the table full at 4096
  entries without a clear, the `KwKwK` code), in interlaced row order where
  the frame says so, one byte read at a time as OpenCV reads them. A
  minimum code size outside 2..11, a first code after a reset that is not
  a colour, or a code past the table, are refused, as are fewer pixels than
  the frame's. The end-of-information code resets the table as a clear
  code does and the decode goes on to the last sub-block. Past the frame's
  last pixel, codes still count pixels and bad codes are skipped; a code
  whose string runs past the last pixel, or a byte read once the count has
  passed it, is refused.
* a grey read is OpenCV's `cvtColor(COLOR_BGRA2GRAY)` of the screen, the
  colour read's grey (`native.cv_cvt_bgr_to_grey`).

The LZW decode runs in compiled host code (`yp_gif_lzw` in
`ops/csrc/host_image.cpp`) for `device` cuda and in its numpy twin
(`lzw_numpy`) for `device` cpu only; a failed build or a bad status of the
compiled decoder raises. The blocks, the palette lookups and the grey
conversion are numpy on every device (the grey compiled for cuda,
`native.grey_for`).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

SIGNATURES = (b"GIF87a", b"GIF89a")
LZW_STATUS = {1: "bad parameters", 2: "a code past the LZW table",
              3: "a code past the frame's last pixel", 4: "the data ends inside a sub-block",
              5: "fewer pixels than the frame", 6: "a pixel past any colour table"}
MAX_CODES = 4096


def lzw_numpy(blocks: bytes, min_size: int, n: int) -> np.ndarray:
    """uint8 `(n,)` palette indices of a frame's LZW data (`blocks`: its
    sub-blocks with their length bytes, up to and including the zero-length
    terminator), as OpenCV's `GifDecoder::lzwDecode` reads them: the twin of
    `yp_gif_lzw`. Raises `Unreadable` where OpenCV refuses the data."""
    out = np.zeros(n, np.uint8)
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    prefix = [0] * MAX_CODES  # each entry: its prefix code, last index, first index, length
    suffix = list(range(clear)) + [0] * (MAX_CODES - clear)
    first = list(range(clear)) + [0] * (MAX_CODES - clear)
    length = [1] * clear + [0] * (MAX_CODES - clear)
    size, nxt, prev = min_size + 1, eoi + 1, -1
    acc = nacc = idx = 0
    total = len(blocks)
    pos, left = 1, blocks[0] if blocks else 0  # left: bytes left in the sub-block
    while left:
        if nacc < size:  # one byte a read; none once the frame has overflowed
            if idx > n:
                raise Unreadable(LZW_STATUS[3])
            if pos >= total:
                raise Unreadable(LZW_STATUS[4])
            acc |= blocks[pos] << nacc
            nacc += 8
            pos += 1
            left -= 1
        while nacc >= size:
            code = acc & ((1 << size) - 1)
            acc >>= size
            nacc -= size
            if code == clear or code == eoi:  # both reset the table; the decode goes on
                size, nxt, prev = min_size + 1, eoi + 1, -1
                if code == eoi:
                    break
                continue
            if prev < 0:
                if code >= clear:
                    if idx >= n:  # past the frame's end: skipped
                        continue
                    raise Unreadable(LZW_STATUS[2])
            elif code < nxt or code == nxt < MAX_CODES:
                if nxt < MAX_CODES:  # the new entry: prev's string and code's first index
                    prefix[nxt], length[nxt], first[nxt] = prev, length[prev] + 1, first[prev]
                    suffix[nxt] = first[code] if code < nxt else first[prev]
                    nxt += 1
                    if nxt == 1 << size and size < 12:
                        size += 1
            elif idx >= n:
                continue
            else:
                raise Unreadable(LZW_STATUS[2])
            k = length[code]
            if k > 1 and idx < n < idx + k:
                raise Unreadable(LZW_STATUS[3])
            c = code
            for j in range(idx + k - 1, idx - 1, -1):
                if j < n:
                    if suffix[c] > 255:  # past any table: OpenCV's code2pixel refuses it
                        raise Unreadable(LZW_STATUS[6])
                    out[j] = suffix[c]
                c = prefix[c]
            idx += k
            prev = code
        if not left:
            if pos >= total:
                raise Unreadable(LZW_STATUS[4])
            left = blocks[pos]
            pos += 1
    if idx < n:
        raise Unreadable(LZW_STATUS[5])
    return out


def lzw_compiled(stream: bytes, min_size: int, n: int) -> np.ndarray:
    """`lzw_numpy` in compiled host code (`yp_gif_lzw`)."""
    from yolopoint_tpu_torch.ops import _build

    src = np.frombuffer(stream, np.uint8)
    out = np.empty(n, np.uint8)
    status = _build.library().yp_gif_lzw(src.ctypes.data_as(ctypes.c_void_p), len(src),
                                         min_size, out.ctypes.data_as(ctypes.c_void_p), n)
    if status == 1:  # only a caller's fault
        raise RuntimeError(f"yp_gif_lzw: {LZW_STATUS[1]}")
    if status:
        raise Unreadable(LZW_STATUS.get(status, f"status {status}"))
    return out


def _skip_blocks(data: bytes, pos: int) -> int:
    """The offset after the data sub-blocks at `pos` and their terminator."""
    while True:
        if pos >= len(data):
            raise Unreadable("the file ends inside data sub-blocks")
        n = data[pos]
        pos += 1 + n
        if n == 0:
            return pos


def _interlaced_rows(h: int) -> np.ndarray:
    """The screen row of each coded row of an interlaced frame."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def parse(data: bytes) -> dict:
    """The screen, the global table and the first frame of a GIF file:
    the blocks of the whole file are walked to its trailer first, as
    OpenCV's `getFrameCount_` does (any other block, a Graphic Control
    Extension whose first sub-block is not 4 bytes, or a file that ends
    before the trailer, is refused)."""
    if len(data) < 13 or not data.startswith(SIGNATURES):
        raise Unreadable("not a GIF file")
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        if pos + n > len(data):
            raise Unreadable("the file ends inside the global colour table")
        gct = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
        pos += n
    frame = None
    gce = None  # the last Graphic Control Extension before the first frame
    while True:
        if pos >= len(data):
            raise Unreadable("the file ends before its trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            break
        if kind == 0x21:
            if pos >= len(data):
                raise Unreadable("the file ends inside an extension")
            label = data[pos]
            pos += 1
            if label == 0xF9:
                if pos + 5 > len(data):
                    raise Unreadable("the file ends inside a Graphic Control Extension")
                if data[pos] != 4:
                    raise Unreadable(f"a Graphic Control Extension of {data[pos]} bytes")
                if frame is None:
                    gce = data[pos + 1:pos + 5]
            pos = _skip_blocks(data, pos)
        elif kind == 0x2C:
            if pos + 10 > len(data):
                raise Unreadable("the file ends inside an image descriptor")
            left, top, w, h, lflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            lct = None
            if lflags & 0x80:
                n = 3 << ((lflags & 7) + 1)
                if pos + n > len(data):
                    raise Unreadable("the file ends inside a local colour table")
                lct = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
                pos += n
            if pos >= len(data):
                raise Unreadable("the file ends before the LZW code size")
            start = pos + 1
            pos = _skip_blocks(data, start)
            if frame is None:
                frame = dict(left=left, top=top, w=w, h=h, interlaced=bool(lflags & 0x40),
                             table=lct, min_size=data[start - 1], blocks=data[start:pos],
                             gce=gce)
        else:
            raise Unreadable(f"block {kind:#x}")
    if frame is None:
        raise Unreadable("no frame")
    return dict(sw=sw, sh=sh, gct=gct, bg=bg, frame=frame)


def decode_gif(data: bytes, name: str = "<gif>", device: str | torch.device = "cuda",
               grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a GIF file's first frame, or with
    `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for
    from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE

    try:
        g = parse(data)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    sw, sh, gct, bg, f = g["sw"], g["sh"], g["gct"], g["bg"], g["frame"]
    if not (0 < sw and 0 < sh) or max(sw, sh) > MAX_SIDE or sw * sh > MAX_PIXELS:
        raise Unreadable(f"{name}: a {sw}x{sh} screen is not read")
    transparent = -1
    if f["gce"] is not None:
        if (f["gce"][0] >> 2) & 7 > 3:
            raise Unreadable(f"{name}: disposal method {(f['gce'][0] >> 2) & 7}")
        transparent = f["gce"][3] if f["gce"][0] & 1 else -1
    if gct is not None and bg >= len(gct):
        raise Unreadable(f"{name}: background index {bg} past a table of {len(gct)}")
    left, top, w, h = f["left"], f["top"], f["w"], f["h"]
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        raise Unreadable(f"{name}: a {w}x{h} frame at ({left}, {top}) on a {sw}x{sh} screen")
    table = f["table"] if f["table"] is not None else gct
    if table is None:  # OpenCV's own table: black, white, then the grey ramp
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        table[1] = 255
    if not 2 <= f["min_size"] <= 11:
        raise Unreadable(f"{name}: LZW minimum code size {f['min_size']}")
    decode = lzw_numpy if torch.device(device).type == "cpu" else lzw_compiled
    try:
        idx = decode(f["blocks"], f["min_size"], w * h).reshape(h, w)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    if f["interlaced"]:
        rows = np.empty_like(idx)
        rows[_interlaced_rows(h)] = idx
        idx = rows
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(table)] = table[:, ::-1]
    keep = idx != transparent
    if int(np.where(keep, idx, 0).max() if transparent >= 0 else idx.max()) >= len(table):
        raise Unreadable(f"{name}: a pixel past a colour table of {len(table)}")
    if transparent < 0 and (w, h) == (sw, sh):  # the frame is the screen
        screen = pal[idx]
    else:
        screen = np.zeros((sh, sw, 3), np.uint8)
        if gct is not None:
            screen[:] = gct[bg, ::-1]
        frame = screen[top:top + h, left:left + w]
        frame[:] = np.where(keep[..., None], pal[idx], frame)
    return grey_for(device).cvt(screen) if grey else screen


def read_gif(path: str | Path, device: str | torch.device = "cuda",
             grey: bool = False) -> np.ndarray:
    """`decode_gif` of a file."""
    return decode_gif(Path(path).read_bytes(), str(path), device, grey)
