"""PFM (portable float map) reading without OpenCV.

`decode_pfm(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a PFM file, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`, as OpenCV 5's decoder (`grfmt_pfm.cpp`) reads
them, found by sweeps against it:

* the header: `PF` (three channels) or `Pf` (one), a `\\n`, then the
  width, the height and the scale, each a token ended by one whitespace
  byte and read by C's `atoi` / `atof` (a byte above 127 in a token is
  refused). A scale of 0 or NaN is refused; a negative scale means
  little-endian samples, any other big-endian.
* rows of 32-bit floats bottom-up; three channels R, G, B, turned to B,
  G, R; every sample multiplied by `1 / |scale|` in float32, then rounded
  to the nearest integer, ties to even, and saturated to 0..255 (no
  scaling by 255: a [0, 1] image reads as 0s and 1s). A NaN, an infinity or
  a value beyond the 32-bit integers reads as 0 (`cvRound` gives INT_MIN).
* OpenCV's decoder converts the depth but not the channels, and imread
  refuses the reallocated image: a `PF` file read in grey and a `Pf` file
  read in colour are files `cv2.imread` returns None for.

A malformed or short file raises `Unreadable`. The work is numpy on every
device (no sequential decode).
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE, WHITESPACE

_TOKEN_MAX = 2048
_INT = re.compile(rb"[ \t\n\r\x0b\x0c]*([+-]?\d+)")
_FLOAT = re.compile(rb"[ \t\n\r\x0b\x0c]*([+-]?(?:"
                    rb"0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?"
                    rb"|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
                    rb"|inf(?:inity)?|nan(?:\([0-9A-Za-z_]*\))?))", re.IGNORECASE)


def is_pfm(head: bytes) -> bool:
    """OpenCV's PFM signature: `PF` or `Pf` and a whitespace byte."""
    return len(head) >= 3 and head[:2] in (b"PF", b"Pf") and head[2] in WHITESPACE


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """A `read_number` token from `pos`: the bytes up to one whitespace
    byte (at most 2048), and the offset after it."""
    out = bytearray()
    for _ in range(_TOKEN_MAX):
        if pos >= len(data):
            raise Unreadable("the file ends inside the header")
        c = data[pos]
        pos += 1
        if c > 127:
            raise Unreadable(f"a header byte {c:#x}")
        if c in WHITESPACE:
            break
        out.append(c)
    return bytes(out), pos


def _atoi(token: bytes) -> int:
    m = _INT.match(token)
    return int(m.group(1)) if m else 0


def _atof(token: bytes) -> float:
    m = _FLOAT.match(token)
    if not m:
        return 0.0
    text = m.group(1).decode().lower()
    sign = -1.0 if text.startswith("-") else 1.0
    body = text.lstrip("+-")
    if body.startswith("0x"):
        if "p" not in body:
            body += "p0"
        return sign * float.fromhex(body)
    if body.startswith("nan"):
        return math.nan
    return sign * float(body)


def decode_pfm(data: bytes, name: str = "<pfm>", device: str | torch.device = "cuda",
               grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a PFM file's bytes, or with `grey` `(H, W)`."""
    if len(data) < 3 or data[:2] not in (b"PF", b"Pf") or data[2] != 10:
        raise Unreadable(f"{name}: not a PFM file")
    channels = 3 if data[1] == ord("F") else 1
    if grey != (channels == 1):
        raise Unreadable(f"{name}: a {channels}-channel PFM file in a "
                         f"{'grey' if grey else 'colour'} read")
    try:
        tw, pos = _token(data, 3)
        th, pos = _token(data, pos)
        ts, pos = _token(data, pos)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    w, h, scale = _atoi(tw), _atoi(th), _atof(ts)
    if not (0 < w and 0 < h) or max(w, h) > MAX_SIDE or w * h > MAX_PIXELS:
        raise Unreadable(f"{name}: a {w}x{h} image is not read")
    if not abs(scale) > 0:
        raise Unreadable(f"{name}: scale {scale}")
    size = w * h * channels * 4
    if len(data) - pos < size:
        raise Unreadable(f"{name}: {len(data) - pos} bytes of samples, want {size}")
    v = np.frombuffer(data, "<f4" if scale < 0 else ">f4", w * h * channels, pos)
    v = v.astype(np.float32).reshape(h, w, channels)[::-1]
    with np.errstate(invalid="ignore", over="ignore"):
        v = v * np.float32(1.0 / abs(scale))
        r = np.rint(v.astype(np.float64))
        r[~(np.abs(r) < 2.0 ** 31)] = 0  # cvRound's INT_MIN, saturated to 0
    out = np.clip(r, 0, 255).astype(np.uint8)
    return out[..., 0].copy() if grey else np.ascontiguousarray(out[..., ::-1])


def read_pfm(path: str | Path, device: str | torch.device = "cuda",
             grey: bool = False) -> np.ndarray:
    """`decode_pfm` of a file."""
    return decode_pfm(Path(path).read_bytes(), str(path), device, grey)
