"""PNG reading without OpenCV or Pillow.

`read_png(path)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns
for a PNG file: uint8 `(H, W, 3)` in BGR order. Grey (colour type 0, also
at 1, 2 and 4 bits, scaled to 0-255 as libpng expands it) and grey + alpha
(4) are repeated to three channels; RGB (2) and RGBA (6) are reversed and
the alpha dropped; palette images (3, at 1, 2, 4 and 8 bits) are looked up
in their `PLTE`. 16-bit samples keep their high byte. Adam7-interlaced
files are read pass by pass, each pass's scanlines unfiltered on their own.
With `grey`, the `(H, W)` image of `cv2.IMREAD_GRAYSCALE`: grey samples as
they are, colour ones (and palette entries) through libpng's rgb_to_gray as
OpenCV's decoder asks for it (`data/native.py:png_rgb_to_grey`; 16-bit
samples converted before their high byte is kept; a file gamma from a gAMA
or sRGB chunk takes libpng's gamma-corrected path, through its 8-bit tables
or, for 16-bit samples, its 16-bit tables, whose index an sBIT chunk sets).

`write_png(path, img)` writes the bytes `cv2.imwrite` writes for 8-bit
grey, BGR or BGRA (stored as grey, RGB or RGBA) at OpenCV 5's defaults:
every row with filter type Sub (None in an image one pixel wide, where libpng
drops Sub), deflated by `zlib` at level 1 with the run-length strategy,
libpng's window for a small image (and its rewritten zlib header), in
`IDAT` chunks of 8192 bytes.

The chunks are parsed here (CRC checked, `IDAT`s joined, inflated with
`zlib`); the unfiltering, whose Average and Paeth filters run sequentially
along each row, and the grey conversion run in compiled host code
(`yp_png_unfilter` and `yp_grey_u8` in `ops/csrc/host_image.cpp`, built
with the CUDA kernels) for `device` cuda, and in their numpy twins,
`unfilter_numpy` and `native.png_rgb_to_grey`, for `device` cpu only.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# the seven passes of Adam7: first column and row, column and row steps
SRGB_GAMMA = 45455  # the gamma libpng takes for a file with an sRGB chunk
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def parse_chunks(data: bytes, name: str = "<png>") -> tuple[dict, bytes | None, bytes]:
    """`(ihdr, plte, idat)` of a PNG file's bytes: the header fields (with
    `gamma`: the file gamma in units of 1e-5 as libpng takes it, an sRGB
    chunk's over a gAMA chunk's, 0 for none), the palette's bytes (or None)
    and the concatenated `IDAT` payload. Raises
    `Unreadable` on a bad signature, a CRC mismatch, a truncated chunk or a
    missing `IHDR` / `IDAT` / `IEND`."""
    if data[:8] != SIGNATURE:
        raise Unreadable(f"{name}: not a PNG file")
    pos, ihdr, plte, idat, ended = 8, None, None, [], False
    gamma, srgb, sbit = 0, False, b""
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise Unreadable(f"{name}: truncated {ctype!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) != crc:
            raise Unreadable(f"{name}: CRC mismatch in {ctype!r} chunk")
        if ctype == b"IHDR":
            if length != 13:
                raise Unreadable(f"{name}: IHDR of {length} bytes")
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
            ihdr = dict(width=w, height=h, depth=depth, color=color, compression=comp,
                        filter=filt, interlace=interlace)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"gAMA" and len(body) == 4 and not srgb:
            (gamma,) = struct.unpack(">I", body)
        elif ctype == b"sRGB":
            srgb, gamma = True, SRGB_GAMMA
        elif ctype == b"sBIT":
            sbit = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            ended = True
            break
        pos = end
    if ihdr is None or not idat or not ended:
        raise Unreadable(f"{name}: missing IHDR, IDAT or IEND")
    ihdr["gamma"] = gamma if 0 < gamma <= 0x7FFFFFFF else 0
    # libpng's sig_bit for colour: the most significant bits of R, G, B (an
    # sBIT chunk of the wrong size or with a value outside 1..depth ignored)
    want = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(ihdr["color"], 0)
    limit = 8 if ihdr["color"] == 3 else ihdr["depth"]
    ok = len(sbit) == want and all(1 <= v <= limit for v in sbit)
    ihdr["sbit"] = max(sbit[:3]) if ok and ihdr["color"] in (2, 6) else 0
    return ihdr, plte, b"".join(idat)


def geometry(ihdr: dict) -> tuple[int, int]:
    """`(stride, bpp)`: bytes a scanline (without its filter byte) and the
    filter's byte distance (bytes a pixel, at least 1)."""
    bits = CHANNELS[ihdr["color"]] * ihdr["depth"]
    return (ihdr["width"] * bits + 7) // 8, max(1, bits // 8)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_numpy(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The reconstructed scanlines `(height, stride)` uint8 of the inflated
    data `raw` (each row a filter byte and `stride` filtered bytes)."""
    rows = np.asarray(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pad = (-stride) % bpp
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 in each of the bpp byte lanes
            lanes = np.concatenate([line, np.zeros(pad, np.int32)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 255).reshape(-1)[:stride]
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row, bpp lanes at once
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                n = min(bpp, stride - x)
                up = prev[x:x + n]
                pred = (left[:n] + up) >> 1 if ftype == 3 else _paeth(left[:n], up, upleft[:n])
                cur[x:x + n] = (line[x:x + n] + pred) & 255
                left[:n], upleft[:n] = cur[x:x + n], up
        else:
            raise Unreadable(f"bad PNG filter type {ftype} in row {y}")
        prev = cur & 255
        out[y] = prev
    return out


def unfilter_compiled(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """`unfilter_numpy` in compiled host code (`yp_png_unfilter`)."""
    from yolopoint_tpu_torch.ops import _build

    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise Unreadable(f"{raw.size} bytes of scanlines, want {height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = _build.library().yp_png_unfilter(raw.ctypes.data_as(ctypes.c_void_p),
                                           out.ctypes.data_as(ctypes.c_void_p),
                                           height, stride, bpp)
    if bad:
        raise Unreadable(f"bad PNG filter type {int(raw[(bad - 1) * (stride + 1)])} "
                         f"in row {bad - 1}")
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """`(H, W, channels)` samples of the scanlines: uint8, sub-byte depths
    unpacked (most significant bits first); uint16 at depth 16."""
    H = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(H, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2].reshape(H, width * channels, 2) \
            .view(">u2").astype(np.uint16).reshape(H, width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # 1, 2, 4 bits: one channel
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(H, -1)[:, :width].reshape(H, width, 1)


def decode_png(data: bytes, name: str = "<png>", device: str | torch.device = "cuda",
               grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of PNG bytes, as `cv2.imread(...,
    IMREAD_COLOR)` gives it, or with `grey` the `(H, W)` image of
    `IMREAD_GRAYSCALE`. `device` cpu unfilters and converts in numpy; any
    other device in the compiled host code (raising if it does not build)."""
    from yolopoint_tpu_torch.data.native import grey_for

    ihdr, plte, idat = parse_chunks(data, name)
    color, depth, W, H = ihdr["color"], ihdr["depth"], ihdr["width"], ihdr["height"]
    if color not in CHANNELS or depth not in DEPTHS[color]:
        raise Unreadable(f"{name}: colour type {color} at bit depth {depth} is not valid PNG")
    if ihdr["compression"] != 0 or ihdr["filter"] != 0 or ihdr["interlace"] > 1:
        raise Unreadable(f"{name}: unknown compression, filter or interlace method")
    C = CHANNELS[color]
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise Unreadable(f"{name}: {e}") from e
    unfilter = unfilter_numpy if torch.device(device).type == "cpu" else unfilter_compiled
    px = np.zeros((H, W, C), np.uint16 if depth == 16 else np.uint8)
    offset = 0
    for x0, y0, dx, dy in ADAM7 if ihdr["interlace"] else ((0, 0, 1, 1),):
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no scanlines
        stride, bpp = geometry(dict(ihdr, width=pw))
        n = ph * (stride + 1)
        if raw.size < offset + n:
            raise Unreadable(f"{name}: {raw.size} bytes of scanlines, want at least {offset + n}")
        rows = unfilter(raw[offset:offset + n], ph, stride, bpp)
        px[y0::dy, x0::dx] = _samples(rows, pw, C, depth)
        offset += n
    if color == 3:
        if plte is None:
            raise Unreadable(f"{name}: palette image without PLTE")
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
        if grey:  # the palette expanded to RGB, then converted
            return grey_for(device).png(pal[px[..., 0]], 8, ihdr["gamma"])
        return np.ascontiguousarray(pal[px[..., 0]][..., ::-1])
    if color in (0, 4):
        g = px[..., 0]
        if depth < 8:  # libpng's expansion of low-depth grey to 8 bits
            g = g.astype(np.uint16) * (255 // ((1 << depth) - 1))
        g = (g >> 8 if depth == 16 else g).astype(np.uint8)
        return np.ascontiguousarray(g) if grey else np.repeat(g[..., None], 3, axis=2)
    if grey:
        return grey_for(device).png(px[..., :3], depth, ihdr["gamma"], ihdr["sbit"])
    rgb = (px[..., :3] >> 8).astype(np.uint8) if depth == 16 else px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])  # RGB(A) -> BGR


def read_png(path: str | Path, device: str | torch.device = "cuda",
             grey: bool = False) -> np.ndarray:
    """`decode_png` of a file."""
    return decode_png(Path(path).read_bytes(), str(path), device, grey)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


IDAT_BYTES = 8192  # libpng's zlib output buffer: one IDAT chunk each


def _window_bits(size: int) -> int:
    """libpng's `png_deflate_claim`: the window of a small image shrunk to
    fit its `size` bytes of filtered rows."""
    bits, half = 15, 1 << 14
    if size <= 16384:
        while size + 262 <= half:
            half >>= 1
            bits -= 1
    return max(bits, 9)


def _optimize_cmf(z: bytes, size: int) -> bytes:
    """libpng's `optimize_cmf`: the zlib header's window field lowered to the
    smallest window that holds `size` bytes, its check bits redone."""
    cmf = z[0]
    if size > 16384 or (cmf & 0x0F) != 8 or (cmf & 0xF0) > 0x70:
        return z
    cinfo = cmf >> 4
    half = 1 << (cinfo + 7)
    if size > half:
        return z
    while True:
        half >>= 1
        cinfo -= 1
        if not (cinfo > 0 and size <= half):
            break
    cmf = (cmf & 0x0F) | (cinfo << 4)
    flg = z[1] & 0xE0
    flg += 0x1F - ((cmf << 8) + flg) % 0x1F
    return bytes([cmf, flg]) + z[2:]


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 `(H, W)` / `(H, W, 1)` grey, `(H, W, 3)` BGR or
    `(H, W, 4)` BGRA image: `cv2.imencode(".png", img)`'s bytes."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png takes uint8 grey, BGR or BGRA, got {img.dtype} {img.shape}")
    H, W, C = img.shape
    color = {1: 0, 3: 2, 4: 6}[C]
    px = img if C == 1 else np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    px = px.reshape(H, W * C)
    if W > 1:  # Sub: each byte less the byte a pixel to its left
        px = np.concatenate([px[:, :C], px[:, C:] - px[:, :-C]], axis=1)
    rows = np.concatenate([np.full((H, 1), 1 if W > 1 else 0, np.uint8), px], axis=1)
    deflate = zlib.compressobj(1, zlib.DEFLATED, _window_bits(rows.size), 8, zlib.Z_RLE)
    z = _optimize_cmf(deflate.compress(rows.tobytes()) + deflate.flush(), rows.size)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", z[i:i + IDAT_BYTES]) for i in range(0, len(z), IDAT_BYTES))
            + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    """`cv2.imwrite(path, img)` for a `.png` path: `encode_png`'s bytes."""
    Path(path).write_bytes(encode_png(img))
