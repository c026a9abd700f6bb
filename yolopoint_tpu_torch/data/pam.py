"""PAM (`P7`) reading without OpenCV.

`decode_pam(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a PAM file, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`, as OpenCV 5's decoder (`grfmt_pam.cpp`) reads
them, found by sweeps against it:

* the header: `P7` and a line break (`\\n` or `\\r`), then lines of
  `WIDTH`, `HEIGHT`, `DEPTH`, `MAXVAL` (each once), `TUPLTYPE` (the last
  one counts) and `ENDHDR`, read as OpenCV's `ReadPAMHeaderLine` reads them:
  whitespace, `#` comments and empty lines skipped; an identifier ends at a
  whitespace byte and must be one of these exactly; its value starts at the
  next non-whitespace byte (line breaks included) and runs to the line
  break, trailing whitespace dropped; numbers are an optional `-` and
  decimal digits. The samples start after the byte that ended `ENDHDR`'s
  line (after `ENDHDR\\r\\n`, at the `\\n`).
* `TUPLTYPE` `BLACKANDWHITE` or `GRAYSCALE` (depth 1), `GRAYSCALE_ALPHA`
  (2), `RGB` (3), `RGB_ALPHA` (4), or none or empty: then depth 1 at maxval
  1 (black and white), depth 1 or 3 below maxval 256; anything else (a
  16-bit RGB file without `TUPLTYPE`, as `cv2.imencode(".pam")` writes it)
  is refused. A maxval above 65535 is refused; 0 is taken.
* samples are not scaled: 8-bit ones as they are, 16-bit ones (maxval
  256 and up) their high byte. At maxval 1, whatever the depth, each row of
  `width * depth` bytes is read as packed bits, MSB first, one a pixel: 1
  white, 0 black.
* a colour read keeps three samples in the file's order (no RGB to BGR
  swap) and repeats one; a grey read keeps one and converts three as RGB
  (OpenCV's converter of the samples reversed, `native.cv_bgr_to_grey`).
  Depths 2 and 4 go through OpenCV's
  `basic_conversion`, which steps one pixel a `depth` samples but stops
  after `ceil(width / depth)` pixels, and in a grey read writes each of
  them to three output bytes: the first sample (grey) or B, G, R = samples
  2, 1, 0. Where that leaves output pixels unwritten (a colour read of
  width 2 and up, a grey read where `3 * ceil(width / depth) < width`)
  `cv2.imread` returns uninitialised memory there, which no reader can
  match: those reads raise `NotImplementedError`.

A malformed or short file (what `cv2.imread` returns None for) raises
`Unreadable`. The pixel work is numpy on every device; the grey conversion
of three samples runs in compiled host code for `device` cuda
(`native.grey_for`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE, WHITESPACE

SIGNATURE = b"P7"
FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
             b"RGB_ALPHA": 4, b"": 0}
_IDENT_MAX, _VALUE_MAX = 8, 255  # MAX_PAM_HEADER_IDENITFIER_LENGTH, _VALUE_LENGTH


def is_pam(head: bytes) -> bool:
    """OpenCV's PAM signature: `P7` and a whitespace byte."""
    return len(head) >= 3 and head[:2] == SIGNATURE and head[2] in WHITESPACE


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise Unreadable("the file ends inside the header")
        self.pos += 1
        return self.data[self.pos - 1]


def _header_line(s: _Stream) -> tuple[bytes | None, bytes]:
    """One `ReadPAMHeaderLine`: `(identifier, value)`; `(None, b"")` for a
    comment or an empty line."""
    code = s.byte()
    while code in WHITESPACE:
        code = s.byte()
    if code == 35:  # '#'
        while code not in (10, 13):
            code = s.byte()
        return None, b""
    ident = bytearray()
    for _ in range(_IDENT_MAX):
        if code in WHITESPACE:
            break
        ident.append(code)
        code = s.byte()
    if code not in WHITESPACE or bytes(ident) not in FIELDS:
        raise Unreadable(f"a bad header identifier {bytes(ident)!r}")
    if code in (10, 13):
        return bytes(ident), b""
    code = s.byte()
    while code in WHITESPACE:
        code = s.byte()
    value = bytearray()
    for _ in range(_VALUE_MAX):
        if code in (10, 13):
            break
        value.append(code)
        code = s.byte()
    if code not in (10, 13):
        raise Unreadable("a header value runs past its line")
    while len(value) > 1 and value[-1] in WHITESPACE:  # the first byte stays
        value.pop()
    return bytes(ident), bytes(value)


def _number(value: bytes) -> int:
    digits = value[1:] if value[:1] == b"-" else value
    if not digits or not digits.isdigit() or len(digits) > 10:
        raise Unreadable(f"a bad header number {value!r}")
    n = int(value)
    if not -(1 << 31) <= n < 1 << 31:
        raise Unreadable(f"a header number out of range {value!r}")
    return n


def parse_header(data: bytes) -> tuple[int, int, int, int, int]:
    """`(width, height, depth, maxval, sample offset)`."""
    if len(data) < 3 or data[:2] != SIGNATURE or data[2] not in (10, 13):
        raise Unreadable("not a PAM file")
    s = _Stream(data, 3)
    seen: dict[bytes, int] = {}
    tupl = 0
    while True:
        ident, value = _header_line(s)
        if ident is None:
            continue
        if ident == b"ENDHDR":
            break
        if ident == b"TUPLTYPE":
            if value not in TUPLTYPES:
                raise Unreadable(f"an unknown TUPLTYPE {value!r}")
            tupl = TUPLTYPES[value]
            continue
        if ident in seen:
            raise Unreadable(f"{ident.decode()} twice")
        seen[ident] = _number(value)
        if ident == b"MAXVAL" and seen[ident] > 65535:
            raise Unreadable(f"maxval {seen[ident]}")
    if len(seen) < 4:
        raise Unreadable(f"the header lacks {sorted(set(FIELDS[:4]) - set(seen))}")
    w, h, depth, maxval = (seen[k] for k in FIELDS[:4])
    if not tupl:
        if depth == 1 and maxval < 256 or depth == 3 and maxval < 256:
            tupl = depth
        else:
            raise Unreadable(f"no TUPLTYPE for depth {depth} at maxval {maxval}")
    if tupl != depth:
        raise Unreadable(f"depth {depth} for a tuple of {tupl}")
    return w, h, depth, maxval, s.pos


def decode_pam(data: bytes, name: str = "<pam>", device: str | torch.device = "cuda",
               grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a PAM file's bytes, or with `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for

    try:
        w, h, depth, maxval, pos = parse_header(data)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    if not (0 < w and 0 < h) or max(w, h) > MAX_SIDE or w * h > MAX_PIXELS:
        raise Unreadable(f"{name}: a {w}x{h} image is not read")
    wide = maxval > 255
    stride = w * depth * (2 if wide else 1)
    if len(data) - pos < stride * h:
        raise Unreadable(f"{name}: {len(data) - pos} bytes of samples, want {stride * h}")
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)
    if maxval == 1:  # packed bits, one a pixel, whatever the depth
        img = np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
        return img if grey else np.repeat(img[..., None], 3, axis=2)
    if wide:
        rows = rows[:, 0::2]  # the high byte of each big-endian sample
    px = rows.reshape(h, w, depth)
    if depth == 1:
        return px[..., 0].copy() if grey else np.repeat(px, 3, axis=2)
    if depth == 3:
        return grey_for(device).bgr(px[..., ::-1]) if grey else px.copy()
    k = -(-w // depth)  # the pixels OpenCV's basic_conversion converts
    if (3 * k if grey else k) < w:
        raise NotImplementedError(
            f"{name}: PAM of depth {depth} at width {w} in a {'grey' if grey else 'colour'} "
            "read: OpenCV leaves pixels of it unset (ROADMAP Queue 1 item 3)")
    done = px.reshape(h, w * depth)[:, :k * depth:depth]  # each pixel's first sample
    if grey:
        return np.repeat(done, 3, axis=1)[:, :w].copy()
    if depth == 2:
        return np.repeat(px[:, :k, :1], 3, axis=2)
    return px[:, :k, 2::-1].copy()


def read_pam(path: str | Path, device: str | torch.device = "cuda",
             grey: bool = False) -> np.ndarray:
    """`decode_pam` of a file."""
    return decode_pam(Path(path).read_bytes(), str(path), device, grey)
