"""Video files for the port's video tests and fixtures: moving clips written
by `cv2.VideoWriter`, an AVI muxer for MJPEG and raw frames the tests build
themselves, the g++ build of the compiled decoders, and cv2's read of a
file (the oracle)."""

from __future__ import annotations

import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "yolopoint_tpu_torch" / "ops" / "csrc"


def pan_clip(height: int, width: int, frames: int, seed: int = 0) -> list[np.ndarray]:
    """A camera panning diagonally over a blurred noise canvas (new content
    entering at the edges, so P-VOPs carry vectors that point outside the
    frame), with a bright square moving against the pan."""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (height + 8 * frames, width + 8 * frames, 3), np.uint8)
    canvas = cv2.GaussianBlur(canvas, (9, 9), 3)
    out = []
    for i in range(frames):
        f = canvas[5 * i:5 * i + height, 8 * frames - 7 * i:8 * frames - 7 * i + width].copy()
        x, y = (9 * i) % max(width - 20, 1), (4 * i) % max(height - 16, 1)
        cv2.rectangle(f, (x, y), (x + 17, y + 13), (250, 240, 230), -1)
        out.append(f)
    return out


def write_cv2(path: Path, fourcc: str, frames: list[np.ndarray], fps: int = 10) -> Path:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened(), (path, fourcc)
    for f in frames:
        writer.write(f)
    writer.release()
    return path


def read_cv2(path: Path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body


def avi_bytes(packets: list[bytes], width: int, height: int, fourcc: bytes = b"MJPG",
              bitcount: int = 24, fps: int = 10, index: bool = True) -> bytes:
    """A one-stream AVI of `packets` as `00dc` chunks (with an `idx1`);
    `height` as `biHeight` (negative: a top-down DIB)."""
    n = len(packets)
    avih = struct.pack("<10I4I", 1000000 // fps, 0, 0, 0x10, n, 0, 1, 0, width, abs(height),
                       0, 0, 0, 0)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, 0,
                                          0xFFFFFFFF, 0, 0, 0, width, abs(height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, bitcount, fourcc,
                       width * abs(height) * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, idx = b"", b""
    for p in packets:
        idx += b"00dc" + struct.pack("<III", 0x10, len(movi) + 4, len(p))
        movi += _chunk(b"00dc", p)
    body = b"AVI " + hdrl + _list(b"movi", movi) + (_chunk(b"idx1", idx) if index else b"")
    return b"RIFF" + struct.pack("<I", len(body)) + body


def strip_dht(data: bytes) -> bytes:
    """A JPEG with its DHT segments removed (the default tables apply)."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            out += data[pos:]
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out)


def build_host_library(out_dir: Path) -> ctypes.CDLL | None:
    """`host_image.cpp` and `host_video.cpp` built with g++ into one library
    with the build's signatures, or None without a compiler."""
    from yolopoint_tpu_torch.ops import _build

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    out = out_dir / "host_video.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(CSRC / "host_image.cpp"), str(CSRC / "host_video.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for name, args in _build._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def replace_box(data: bytes, path: list[bytes], kind: bytes, body: bytes) -> bytes:
    """An MP4 with the box at `path` (container types from the top, then
    the box's own type) replaced by a box `kind` holding `body`, each
    enclosing container's size updated (the `moov` of a file whose `mdat`
    comes first: chunk offsets stay valid)."""

    def walk(buf: bytes, depth: int) -> bytes:
        out, pos = b"", 0
        while pos + 8 <= len(buf):
            size, typ = struct.unpack(">I4s", buf[pos:pos + 8])
            box = buf[pos:pos + size]
            if typ == path[depth] and depth == len(path) - 1:
                box = struct.pack(">I4s", 8 + len(body), kind) + body
            elif typ == path[depth]:
                inner = walk(box[8:], depth + 1)
                box = struct.pack(">I4s", 8 + len(inner), typ) + inner
            out += box
            pos += size
        return out + buf[pos:]

    return walk(data, 0)


def mp4_box(data: bytes, path: list[bytes]) -> bytes:
    """The body of the first box at `path`."""
    pos, end = 0, len(data)
    for depth, typ in enumerate(path):
        while pos + 8 <= end:
            size, t = struct.unpack(">I4s", data[pos:pos + 8])
            if t == typ:
                if depth == len(path) - 1:
                    return data[pos + 8:pos + size]
                pos, end = pos + 8, pos + size
                break
            pos += size
        else:
            raise KeyError(typ)
    raise KeyError(path)
