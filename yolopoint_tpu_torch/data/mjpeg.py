"""Motion JPEG frames as FFmpeg's mjpeg decoder (`libavcodec/mjpegdec.c`)
gives them to `cv2.VideoCapture`.

A frame is one baseline or extended sequential Huffman-coded JPEG image
(what cameras and `VideoWriter_fourcc(*"MJPG")` write). Its markers and
entropy-coded scans are `data/jpeg.py`'s (`parse_header`; a frame with no
DHT takes the standard tables, as `init_default_huffman_tables` does;
restart intervals reset the DC predictors); then, unlike libjpeg:

* dequantization as `decode_block`: each coefficient times its table entry
  as int16, the DC predictor starting at `4 << 8` = 1024 (the level shift
  folded into the DC, `last_dc`);
* FFmpeg's simple IDCT (`data/idct_ff.py`), each component's plane at its
  own sampling (no upsampling: the frame is `yuvj420p`, `yuvj422p`,
  `yuvj444p` or `gray8`);
* the conversion to BGR is swscale's (`data/yuv.py`), at full range (limited
  range where a COM segment reads `CS=ITU601`).

Interlaced MJPEG (`ff_mjpeg_decode_sof`: an image less than three quarters
of the container's height) holds two fields a packet: the first field's
planes go to the frame's odd rows, the second's to its even rows, whatever
an `AVI1` segment's polarity says, and the frame is converted as one
progressive frame; a packet with one field gives no frame (both found by
sweeps against cv2).

Refused with `NotImplementedError`: progressive, arithmetic-coded and
lossless frames, precisions other than 8, component layouts other than grey
and Y'CbCr 4:2:0, 4:2:2 and 4:4:4, RGB or CMYK frames, and the COM strings
for which FFmpeg flips the image. cv2 stops reading a stream at a packet in
which FFmpeg finds no SOI: `EndOfStream`.

The entropy decode runs in compiled host code (`yp_jpeg_coefficients`,
`ops/csrc/host_image.cpp`) and the dequantization and IDCT in
`yp_mjpeg_idct` (`ops/csrc/host_video.cpp`) where `compiled`, in numpy
(`jpeg.entropy_decode_numpy`, `idct_ff`) otherwise.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from yolopoint_tpu_torch.data import idct_ff, jpeg, yuv
from yolopoint_tpu_torch.data.errors import Unreadable

LAYOUTS = {((2, 2), (1, 1), (1, 1)): "420", ((2, 1), (1, 1), (1, 1)): "422",
           ((1, 1), (1, 1), (1, 1)): "444"}
FLIPPING_COMMENTS = (b"Intel(R) JPEG Library, version 1", b"Metasoft MJPEG Codec")


class EndOfStream(Exception):
    """A packet at which cv2's read fails: the stream ends there."""


def _comments(data: bytes) -> list[bytes]:
    """The COM payloads before the first SOS."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xDA:
            break
        if marker == 0xFF:
            pos += 1
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker == 0xFE:
            out.append(data[pos + 4:pos + 2 + length])
        pos += 2 + length
    return out


def parse_frame(data: bytes) -> tuple[jpeg.Header, str, bool]:
    """`(header, layout, full range)` of one JPEG image; raises for what the
    port does not decode, `EndOfStream` where FFmpeg finds no image."""
    start = data.find(b"\xff\xd8")
    if start < 0:
        raise EndOfStream("no JPEG data found in the packet")
    data = data[start:]
    try:
        hdr = jpeg.parse_header(data, "<mjpeg frame>")
    except Unreadable as e:
        raise NotImplementedError(f"an MJPEG frame the port cannot parse ({e})") from e
    if hdr.progressive or hdr.arithmetic or hdr.lossless:
        kind = "progressive" if hdr.progressive else "arithmetic" if hdr.arithmetic else "lossless"
        raise NotImplementedError(f"{kind} MJPEG frames are not decoded by the port")
    if hdr.precision != 8:
        raise NotImplementedError(f"{hdr.precision}-bit MJPEG frames are not decoded by the port")
    comments = _comments(data)
    for c in comments:
        if c.rstrip(b"\x00").startswith(FLIPPING_COMMENTS):
            raise NotImplementedError("an MJPEG frame FFmpeg flips (its encoder's COM segment)")
    if len(hdr.sampling) == 1:
        layout = "grey"
    elif len(hdr.sampling) == 3 and hdr.color == jpeg.YCC and tuple(hdr.sampling) in LAYOUTS:
        layout = LAYOUTS[tuple(hdr.sampling)]
    else:
        raise NotImplementedError(f"MJPEG frames with {len(hdr.sampling)} components sampled "
                                  f"{hdr.sampling} (colour {hdr.color}) are not decoded by the "
                                  "port")
    full = not any(c.rstrip(b"\x00") == b"CS=ITU601" for c in comments)
    return hdr, layout, full


def dequantize(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """`decode_block`'s int16 levels times the table, DC plus 1024."""
    d = (coef.astype(np.int32) * quant.astype(np.int32)).astype(np.int16)
    d[..., 0] = (d[..., 0].astype(np.int32) + 1024).astype(np.int16)
    return d


def planes_numpy(hdr: jpeg.Header) -> list[np.ndarray]:
    """Each component's plane (its whole block grid)."""
    coefs, _ = jpeg.entropy_decode_numpy(hdr)
    out = []
    for c, co in enumerate(coefs):
        blocks = idct_ff.idct_put(dequantize(co, hdr.quant[c]).reshape(*co.shape[:2], 8, 8))
        out.append(idct_ff.blocks_to_plane(blocks))
    return out


def planes_compiled(hdr: jpeg.Header) -> list[np.ndarray]:
    """`planes_numpy` in compiled host code."""
    from yolopoint_tpu_torch.ops import _build

    lib = _build.library()
    frame, table, _, huff, data = jpeg.compiled_inputs(hdr)
    _, _, blocks, _ = jpeg.geometry(hdr)
    total = sum(r * c for r, c in blocks)
    coef = np.zeros(total * 64, np.int16)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    status = lib.yp_jpeg_coefficients(p(data), p(frame), p(table), len(hdr.scans), p(huff),
                                      p(coef))
    if status == 1:
        raise RuntimeError("yp_jpeg_coefficients: bad parameters")
    if status:
        raise NotImplementedError(f"an MJPEG frame the port cannot decode (status {status})")
    out, start = [], 0
    for c, (r, cc) in enumerate(blocks):
        n = r * cc
        quant = np.ascontiguousarray(hdr.quant[c].astype(np.int32))
        pix = np.empty((n, 64), np.uint8)
        status = lib.yp_mjpeg_idct(p(coef[start * 64:]), n, p(quant), p(pix))
        if status == 2:
            raise idct_ff.IdctOverflow("an MJPEG block whose IDCT row pass leaves 16 bits")
        if status:
            raise RuntimeError("yp_mjpeg_idct: bad parameters")
        out.append(idct_ff.blocks_to_plane(pix.reshape(r, cc, 8, 8)))
        start += n
    return out


def _image(data: bytes, compiled: bool) -> tuple[list[np.ndarray], jpeg.Header, str, bool]:
    """The cropped planes of one JPEG image, its header, layout and range."""
    hdr, layout, full = parse_frame(data)
    planes = (planes_compiled if compiled else planes_numpy)(hdr)
    h, w = hdr.height, hdr.width
    if layout == "grey":
        return [planes[0][:h, :w]], hdr, layout, full
    hs, vs = yuv.LAYOUTS[layout]
    ch, cw = -(-h >> vs), -(-w >> hs)
    return [planes[0][:h, :w], planes[1][:ch, :cw], planes[2][:ch, :cw]], hdr, layout, full


def decode_frame(data: bytes, compiled: bool, container_height: int | None = None
                 ) -> np.ndarray | None:
    """uint8 `(H, W, 3)` BGR of one MJPEG packet, as cv2 reads it, or None
    for an interlaced packet that holds one field."""
    planes, hdr, layout, full = _image(data, compiled)
    if container_height and hdr.height < container_height * 3 // 4:
        end = data.find(b"\xff\xd9")
        second = data.find(b"\xff\xd8", end + 2) if end >= 0 else -1
        if second < 0:
            return None
        other, hdr2, layout2, _ = _image(data[second:], compiled)
        if (hdr2.height, hdr2.width, layout2) != (hdr.height, hdr.width, layout):
            raise NotImplementedError("interlaced MJPEG fields of different sizes or layouts")
        frame = []
        for odd, even in zip(planes, other):
            both = np.empty((odd.shape[0] + even.shape[0], odd.shape[1]), np.uint8)
            both[1::2], both[0::2] = odd, even
            frame.append(both)
        planes = frame
    if layout == "grey":
        return yuv.to_bgr(planes[0], None, None, layout, True, compiled)
    return yuv.to_bgr(*planes, layout, full, compiled)
