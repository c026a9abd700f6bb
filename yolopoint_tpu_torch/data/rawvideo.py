"""Raw video frames as FFmpeg's rawvideo decoder (`libavcodec/rawdec.c`)
gives them to `cv2.VideoCapture`.

* `I420`, `IYUV` (Y, U, V planes) and `YV12` (Y, V, U), packed with no
  padding (chroma `ceil(W / 2) x ceil(H / 2)`), converted by swscale's
  `yuv420p` routine (`data/yuv.py`, limited range);
* BI_RGB (`biCompression` 0) at 24 bits, top-down (negative `biHeight`):
  `bgr24` rows padded to 4 bytes (the DIB stride), copied as they are.
  Bottom-up BI_RGB (positive `biHeight`, the `BottomUp` extradata FFmpeg's
  AVI demuxer hands the decoder) is refused: cv2 5.0 with FFmpeg 8 aborts
  reading such files (heap corruption), so there is no oracle.

A packet shorter than the frame is refused by the decoder, and cv2 stops
reading there (`mjpeg.EndOfStream`); a longer one is read from its start.
The planes are copied; the conversion runs compiled where `compiled`.
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.data import yuv
from yolopoint_tpu_torch.data.mjpeg import EndOfStream

YUV420_TAGS = {b"I420": (1, 2), b"IYUV": (1, 2), b"YV12": (2, 1)}
BI_RGB = b"\x00\x00\x00\x00"


def frame_size(tag: bytes, width: int, height: int) -> int:
    if tag == BI_RGB:
        return (width * 3 + 3) // 4 * 4 * height
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


def check(tag: bytes, height: int, bitcount: int) -> None:
    """Raise `NotImplementedError` for the raw layouts the port does not read."""
    if tag == BI_RGB and bitcount != 24:
        raise NotImplementedError(f"{bitcount}-bit BI_RGB video is not read by the port")
    if tag == BI_RGB and height > 0:
        raise NotImplementedError("bottom-up BI_RGB video is not read by the port (cv2 aborts "
                                  "on it: no oracle)")


def decode_frame(data: bytes, tag: bytes, width: int, height: int,
                 compiled: bool) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR of one raw frame (`height` as the container
    writes it: negative for a top-down DIB)."""
    h = abs(height)
    need = frame_size(tag, width, h)
    if len(data) < need:
        raise EndOfStream(f"raw frame of {len(data)} bytes, {need} expected")
    buf = np.frombuffer(data, np.uint8, need)
    if tag == BI_RGB:
        rows = buf.reshape(h, need // h)[:, :width * 3]
        return np.ascontiguousarray(rows.reshape(h, width, 3))
    cw, ch = (width + 1) // 2, (h + 1) // 2
    y = buf[:width * h].reshape(h, width)
    c1 = buf[width * h:width * h + cw * ch].reshape(ch, cw)
    c2 = buf[width * h + cw * ch:].reshape(ch, cw)
    u, v = (c1, c2) if YUV420_TAGS[tag] == (1, 2) else (c2, c1)
    return yuv.to_bgr(y, u, v, "420", False, compiled)
