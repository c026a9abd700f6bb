"""Video files read frame for frame as `cv2.VideoCapture(path)` and its
`read()` loop read them (the JAX demo's input for any path that is not a
directory), without OpenCV or FFmpeg.

`read_video(path, device)` yields uint8 `(H, W, 3)` BGR frames, bit-equal
to cv2 5.0's (FFmpeg 8: libavformat 62.12, libavcodec 62.28, libswscale
9.5), in its order and number, for:

* containers: AVI (`data/avi.py`; OpenDML too) and MP4/MOV
  (`data/isobmff.py`, the edit list applied);
* codecs: MJPEG (`data/mjpeg.py`; AVI tags `MJPG` and kin, MOV `jpeg` and
  `mjpa`), MPEG-4 Part 2 Simple profile (`data/mpeg4video.py`; `mp4v`,
  `FMP4`, `XVID`, `DIVX` and kin as lavc writes them), raw `I420` /
  `IYUV` / `YV12` and top-down 24-bit BI_RGB (`data/rawvideo.py`), and
  PNG (`MPNG`, `png `: 8-bit grey, RGB, palette and RGBA frames, read by
  `data/png.py`; FFmpeg's decoder gives the same samples as libpng there),
  with swscale's conversions to BGR (`data/yuv.py`). An MP4 names MJPEG and
  PNG tracks by the object type of an `mp4v` entry.

A path that is not a file, an empty file, and a file no demuxer recognises
give no frames and no error (cv2 cannot open them; the JAX loop ends at
once). A file cv2 opens and the port does not read (another container, a
codec or tool the port does not decode, an image file or a text file,
which FFmpeg's image and tty demuxers open) raises `NotImplementedError`
naming the file, the container and the codec; codec tags FFmpeg does not
know raise too (cv2 would open none of those). A packet at which cv2's read
fails (no JPEG data, a short raw frame) ends the stream, as cv2's loop ends
there.

`device` cpu decodes in Python and numpy; any other device in compiled host
code (`ops/csrc/host_video.cpp` and the JPEG entropy decoder of
`host_image.cpp`), which raises if it does not build.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from yolopoint_tpu_torch.data import avi, isobmff, mjpeg, mpeg4video, rawvideo, yuv
from yolopoint_tpu_torch.data.mjpeg import EndOfStream

# AVI codec tags (biCompression) FFmpeg maps to the codecs the port decodes
# (a subset of `ff_codec_bmp_tags`)
MPEG4_TAGS = {b"FMP4", b"DIVX", b"DX50", b"XVID", b"MP4S", b"M4S2", b"\x04\x00\x00\x00",
              b"ZMP4", b"DIV1", b"BLZ0", b"MP4V", b"UMP4", b"WV1F", b"SEDG", b"RMP4", b"3IV2",
              b"WAWV", b"FFDS", b"FVFW", b"DCOD", b"MVXM", b"PM4V", b"SMP4", b"DXGM", b"VIDM",
              b"M4T3", b"GEOX", b"HDX4", b"DMK2", b"DIGI", b"INMC", b"EPHV", b"EM4A", b"M4CC",
              b"SN40", b"VSPX", b"ULDX", b"GEOV", b"SIPP", b"SM4V", b"XVIX", b"DREX", b"QMP4",
              b"PLV1", b"GLV4", b"GMP4", b"MNM4", b"GTM4"}
MJPEG_TAGS = {b"MJPG", b"LJPG", b"JPGL", b"AVRN", b"ACDV", b"QIVG", b"SLMJ", b"CJPG", b"IJLV",
              b"MVJP", b"AVI1", b"AVI2", b"MTSJ", b"ZJPG", b"MMJP", b"DMB1", b"IJPG", b"JPEG"}
PNG_TAGS = {b"MPNG", b"PNG1", b"PNG "}
# MOV sample entries
MOV_MJPEG = {b"jpeg", b"mjpa"}
# an MP4 `mp4v` entry's codec by its esds object type (0x20: MPEG-4 Part 2)
MP4_OBJECT_TYPES = {0x20: b"mp4v", 0x6C: b"jpeg", 0x6D: b"png "}

# first bytes of containers and files FFmpeg opens that the port does not read
OTHER_CONTAINERS = (
    (b"\x1a\x45\xdf\xa3", "Matroska/WebM"), (b"FLV", "FLV"), (b"OggS", "Ogg"),
    (b"\x30\x26\xb2\x75\x8e\x66\xcf\x11", "ASF/WMV"), (b"\x00\x00\x01\xba", "MPEG program stream"),
    (b"\x00\x00\x01\xb3", "MPEG-1/2 video"), (b"\x00\x00\x01\xb0", "MPEG-4 elementary stream"),
    (b"\x00\x00\x00\x01", "H.264/HEVC Annex B stream"), (b"\xff\xd8\xff", "JPEG image"),
    (b"\x89PNG\r\n\x1a\n", "PNG image"), (b"BM", "BMP image"), (b"GIF8", "GIF"),
    (b"II*\x00", "TIFF image"), (b"MM\x00*", "TIFF image"),
    (b"FWS", "SWF"), (b"CWS", "SWF"), (b".RMF", "RealMedia"), (b"DHAV", "DHAV"),
)
TTY_SUFFIXES = {".ans", ".art", ".asc", ".diz", ".ice", ".nfo", ".txt", ".vt"}


def _refuse(path, container: str, codec: str) -> None:
    raise NotImplementedError(f"{path}: {container} with {codec} is not read by the port "
                              "(see ROADMAP Queue 1)")


def _container(path: Path, data: bytes) -> str | None:
    """'avi', 'mp4', or None for bytes no demuxer recognises; raises for a
    container the port does not read."""
    if data[:4] == b"RIFF":
        if data[8:12] in (b"AVI ", b"AVIX"):
            return "avi"
        _refuse(path, f"RIFF {data[8:12]!r}", "its codec")
    if data[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip", b"pnot"):
        return "mp4"
    if len(data) > 376 and data[0] == 0x47 and data[188] == 0x47:
        _refuse(path, "MPEG transport stream", "its codecs")
    for sig, name in OTHER_CONTAINERS:
        if data.startswith(sig):
            _refuse(path, name, "its codec")
    if path.suffix.lower() in TTY_SUFFIXES:
        _refuse(path, "text (FFmpeg's tty demuxer)", "ANSI art rendering")
    return None


def _decoder(path: Path, kind: str, tag: bytes, width: int, height: int, bitcount: int,
             extradata: bytes, compiled: bool, object_type: int = 0):
    """A function packet -> list of BGR frames for a stream."""
    up = tag.upper()
    if kind == "mp4" and tag == b"mp4v" and object_type in MP4_OBJECT_TYPES:
        tag = MP4_OBJECT_TYPES[object_type]
    elif kind == "mp4" and tag == b"mp4v" and object_type:
        _refuse(path, "MP4/MOV", f"`mp4v` entry of object type 0x{object_type:02x}")
    if kind == "avi" and up in MPEG4_TAGS or kind == "mp4" and tag == b"mp4v":
        dec = mpeg4video.Decoder(extradata, tag, compiled)

        def mpeg4(packet: bytes) -> list[np.ndarray]:
            return [yuv.to_bgr(y, u, v, "420", False, compiled) for y, u, v in dec.decode(packet)]

        return mpeg4
    if kind == "avi" and up in MJPEG_TAGS or kind == "mp4" and tag in MOV_MJPEG:
        def mjpeg_frames(packet: bytes) -> list[np.ndarray]:
            frame = mjpeg.decode_frame(packet, compiled, abs(height))
            return [] if frame is None else [frame]

        return mjpeg_frames
    if kind == "avi" and up in PNG_TAGS or kind == "mp4" and tag == b"png ":
        return lambda packet: [_png_frame(packet, compiled)]
    if kind == "avi" and (up in rawvideo.YUV420_TAGS or tag == rawvideo.BI_RGB):
        raw = up if up in rawvideo.YUV420_TAGS else tag
        rawvideo.check(raw, height, bitcount)
        return lambda packet: [rawvideo.decode_frame(packet, raw, width, height, compiled)]
    container = "AVI" if kind == "avi" else "MP4/MOV"
    _refuse(path, container, f"codec tag {tag!r}" + (f" at {bitcount} bits" if bitcount else ""))


def _png_frame(packet: bytes, compiled: bool) -> np.ndarray:
    from yolopoint_tpu_torch.data import png

    ihdr = png.parse_chunks(packet, "<png frame>")[0]
    if ihdr["depth"] != 8 or ihdr["color"] not in (0, 2, 3, 6):
        raise NotImplementedError(f"PNG video frames of colour type {ihdr['color']} at "
                                  f"{ihdr['depth']} bits are not read by the port")
    return png.decode_png(packet, "<png frame>", "cuda" if compiled else "cpu")


def read_video(path: str | Path, device: str | torch.device = "cuda") -> Iterator[np.ndarray]:
    """BGR frames of a video file, as `cv2.VideoCapture(path).read()` gives
    them until it fails."""
    path = Path(path)
    compiled = torch.device(device).type != "cpu"
    try:
        data = path.read_bytes()
    except OSError:
        return
    kind = _container(path, data)
    if kind is None:
        return
    if kind == "avi":
        stream = avi.parse_avi(data)
        if stream is None:
            return
        container, tag = "AVI", stream.compression
        args = (stream.width, stream.height, stream.bitcount, stream.extradata, compiled)
        packets, shown = stream.packets, [True] * len(stream.packets)
    else:
        track = isobmff.parse_mp4(data)
        if track is None:
            return
        if track.matrix != isobmff.IDENTITY:
            _refuse(path, "MP4/MOV", "a display matrix (cv2 rotates such frames)")
        container, tag = "MP4/MOV", track.format
        args = (track.width, track.height, track.depth, track.extradata, compiled,
                track.object_type)
        packets, shown = track.packets, track.shown
    try:
        decode = _decoder(path, kind, tag, *args)
        for packet, show in zip(packets, shown):
            try:
                frames = decode(packet)
            except EndOfStream:
                return
            if show:
                yield from frames
    except NotImplementedError as e:
        if str(e).startswith(str(path)):
            raise
        raise NotImplementedError(f"{path}: {container} with codec tag {tag!r}: {e}") from e
