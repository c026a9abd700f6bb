"""RIFF/AVI demuxing as FFmpeg's AVI demuxer (`libavformat/avidec.c`) gives
a video stream's packets to `cv2.VideoCapture`.

`parse_avi(data)` reads the `hdrl` list (`avih`; each `strl`'s `strh`,
whose type `vids` marks a video stream, and `strf`, a BITMAPINFOHEADER
whose `biCompression` is the codec tag FFmpeg maps to a codec, whose
`biBitCount` and the sign of `biHeight` say how raw frames lie, and whose
bytes past its 40 are the codec's extradata) and returns the first video
stream (the stream OpenCV takes). Its packets are the stream's chunks
(`NNdc`, `NNdb` with NN its index) in file order through every `movi`
list: those of the first `RIFF AVI ` and of the OpenDML `RIFF AVIX`
continuations, inside `LIST rec ` groups too; `JUNK`, OpenDML `ix##`
indexes, other streams' chunks and `idx1` are skipped. A chunk of length 0
gives no packet: cv2 returns no frame for it (found by sweeps against cv2
5.0, with and without an `idx1`). A file that is no RIFF AVI, or has no
video stream, returns None: cv2 cannot open it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class AviVideo:
    """The first video stream of an AVI file."""

    compression: bytes      # strf biCompression: FFmpeg's codec tag
    width: int
    height: int             # biHeight as written (negative: top-down)
    bitcount: int
    extradata: bytes
    index: int              # stream number, the chunk ids' NN
    packets: list[bytes] = field(default_factory=list)


def _chunks(data: bytes, pos: int, end: int):
    """`(id, body start, body size)` of the chunks in `data[pos:end]`;
    a chunk that runs past the end is cut there."""
    while pos + 8 <= end:
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        yield cid, body, min(size, max(end - body, 0))
        pos = body + size + (size & 1)


def _strl(data: bytes, pos: int, end: int, index: int) -> AviVideo | None:
    strh = strf = None
    for cid, body, size in _chunks(data, pos, end):
        if cid == b"strh" and size >= 8:
            strh = data[body:body + size]
        elif cid == b"strf":
            strf = data[body:body + size]
    if strh is None or strh[:4] != b"vids" or strf is None or len(strf) < 40:
        return None
    _, width, height, _, bitcount, compression = struct.unpack("<IiiHH4s", strf[:20])
    (bisize,) = struct.unpack("<I", strf[:4])
    extra = strf[40:] if bisize > 40 else b""
    return AviVideo(compression, width, height, bitcount, extra, index)


def _movi(data: bytes, pos: int, end: int, video: AviVideo) -> None:
    ids = (b"%02ddc" % video.index, b"%02ddb" % video.index)
    for cid, body, size in _chunks(data, pos, end):
        if cid == b"LIST" and data[body:body + 4] == b"rec ":
            _movi(data, body + 4, body + size, video)
        elif cid in ids and size > 0:
            video.packets.append(data[body:body + size])


def parse_avi(data: bytes) -> AviVideo | None:
    """The first video stream and its packets, or None where FFmpeg cannot
    open the file as AVI with a video stream."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] not in (b"AVI ", b"AVIX"):
        return None
    video = None
    for cid, body, size in _chunks(data, 0, len(data)):
        if cid != b"RIFF" or data[body:body + 4] not in (b"AVI ", b"AVIX"):
            continue
        for sub, sbody, ssize in _chunks(data, body + 4, body + size):
            kind = data[sbody:sbody + 4] if sub == b"LIST" else None
            if kind == b"hdrl" and video is None:
                n = 0
                for hid, hbody, hsize in _chunks(data, sbody + 4, sbody + ssize):
                    if hid == b"LIST" and data[hbody:hbody + 4] == b"strl":
                        video = video or _strl(data, hbody + 4, hbody + hsize, n)
                        n += 1
            elif kind == b"movi" and video is not None:
                _movi(data, sbody + 4, sbody + ssize, video)
    return video
