"""MP4/MOV demuxing as FFmpeg's mov demuxer (`libavformat/mov.c`) gives a
video track's packets to `cv2.VideoCapture`.

`parse_mp4(data)` walks the boxes (32- and 64-bit sizes, size 0 to the end
of the file; `moov` before or after `mdat`) and returns the first track
whose `hdlr` is `vide` (the stream OpenCV takes): its `stsd` entry (the
format, e.g. `mp4v`, `jpeg`, `mjpa`, `png `; width, height, depth;
`esds`'s objectTypeIndication, which names the codec of an MP4's `mp4v`
entry, and DecoderSpecificInfo, the MPEG-4 VOL, as extradata) and its samples
in decode order from `stsz` / `stz2`, `stsc` and `stco` / `co64`. Times
come from `stts` and `ctts`; an edit list (`edts`/`elst`) is applied as
`mov_fix_index` applies one to what a decoder outputs: an empty edit
(media time -1) first only delays the track, a single edit starting at
media time M and lasting D (movie timescale; 0 shows nothing, as in cv2)
keeps the frames whose presentation time lies in [M, M + D) (the ones
before M are decoded and discarded, the ones after it are not in the
index; found against cv2 on patched `elst` boxes). More than one edit
raises `NotImplementedError`. A file that is no MP4/MOV, or has no
video track, returns None: cv2 cannot open it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}
# a track header's display matrix that leaves frames as they are
IDENTITY = (0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


@dataclass
class Mp4Video:
    """The first video track of an MP4/MOV file."""

    format: bytes
    width: int
    height: int
    depth: int
    extradata: bytes
    packets: list[bytes] = field(default_factory=list)
    # whether each packet's frame is shown (the edit list's window)
    shown: list[bool] = field(default_factory=list)
    matrix: tuple = IDENTITY  # tkhd's display matrix
    # esds objectTypeIndication, which picks the codec of an `mp4v` entry
    # (`ff_mp4_obj_type`: 0x20 MPEG-4 Part 2, 0x6C JPEG, 0x6D PNG)
    object_type: int = 0


def _boxes(data: bytes, pos: int, end: int):
    """`(type, body start, body end)` of the boxes in `data[pos:end]`."""
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                return
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _tree(data: bytes, pos: int, end: int) -> dict:
    """Boxes by type (each a list), containers parsed into their own dicts."""
    out: dict = {}
    for kind, body, stop in _boxes(data, pos, end):
        node = _tree(data, body, stop) if kind in CONTAINERS else (body, stop)
        out.setdefault(kind, []).append(node)
    return out


def _descriptor(data: bytes, pos: int, end: int):
    """`(tag, body start, body end)` of an MPEG-4 descriptor (`mp4_read_descr`)."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        if pos >= end:
            break
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, min(pos + size, end)


def _esds(data: bytes, pos: int, end: int) -> tuple[int, bytes]:
    """`(objectTypeIndication, DecoderSpecificInfo)` of an `esds` box
    (`ff_mp4_read_dec_config_descr`)."""
    pos += 4  # version, flags
    tag, pos, stop = _descriptor(data, pos, end)
    if tag == 3:  # ES_Descriptor
        pos += 2
        flags = data[pos]
        pos += 1
        if flags & 0x80:
            pos += 2
        if flags & 0x40:
            pos += 1 + data[pos]
        if flags & 0x20:
            pos += 2
        tag, pos, stop = _descriptor(data, pos, stop)
    if tag != 4 or pos >= stop:  # DecoderConfigDescriptor
        return 0, b""
    object_type = data[pos]
    pos += 13
    if pos >= stop:
        return object_type, b""
    tag, pos, stop = _descriptor(data, pos, stop)
    return object_type, data[pos:stop] if tag == 5 else b""


def _full(data: bytes, node, fmt: str, offset: int = 4) -> tuple:
    body, _ = node
    return struct.unpack_from(fmt, data, body + offset)


def _table(data: bytes, node, fmt: str, head: str = ">I") -> list:
    """The entries of a full box that holds a count then fixed entries."""
    body, end = node
    count = struct.unpack_from(head, data, body + 4)[-1]
    start = body + 4 + struct.calcsize(head)
    size = struct.calcsize(fmt)
    count = min(count, max(end - start, 0) // size)
    return [struct.unpack_from(fmt, data, start + i * size) for i in range(count)]


def _sizes(data: bytes, stbl: dict) -> list[int]:
    if b"stsz" in stbl:
        node = stbl[b"stsz"][0]
        size, count = _full(data, node, ">II")
        if size:
            return [size] * count
        return [s for (s,) in _table(data, node, ">I", ">II")[:count]]
    body, end = stbl[b"stz2"][0]
    field_size = data[body + 7]
    (count,) = struct.unpack_from(">I", data, body + 8)
    raw = data[body + 12:end]
    if field_size == 4:
        return [(raw[i >> 1] >> (4 * (1 - (i & 1)))) & 15 for i in range(count)]
    fmt = {8: "B", 16: "H"}.get(field_size)
    if fmt is None:
        raise ValueError(f"stz2 field size {field_size}")
    return list(struct.unpack_from(f">{count}{fmt}", raw))


def _track(data: bytes, trak: dict, movie_scale: int) -> Mp4Video | None:
    mdia = trak.get(b"mdia", [{}])[0]
    hdlr = mdia.get(b"hdlr")
    if not hdlr or data[hdlr[0][0] + 8:hdlr[0][0] + 12] != b"vide":
        return None
    version = data[mdia[b"mdhd"][0][0]]
    (media_scale,) = _full(data, mdia[b"mdhd"][0], ">I", 20 if version == 1 else 12)
    stbl = mdia.get(b"minf", [{}])[0].get(b"stbl", [{}])[0]
    if b"stsd" not in stbl:
        return None
    body, end = stbl[b"stsd"][0]
    entry = body + 8
    (size,) = struct.unpack_from(">I", data, entry)
    fmt = data[entry + 4:entry + 8]
    width, height = struct.unpack_from(">HH", data, entry + 32)
    (depth,) = struct.unpack_from(">H", data, entry + 82)
    extradata, object_type = b"", 0
    for kind, b0, b1 in _boxes(data, entry + 86, min(entry + size, end)):
        if kind == b"esds":
            object_type, extradata = _esds(data, b0, b1)
    video = Mp4Video(fmt, width, height, depth, extradata, object_type=object_type)
    if b"tkhd" in trak:
        body = trak[b"tkhd"][0][0]
        video.matrix = struct.unpack_from(">9i", data, body + (52 if data[body] == 1 else 40))
    sizes = _sizes(data, stbl)
    if b"stco" in stbl:
        offsets = [o for (o,) in _table(data, stbl[b"stco"][0], ">I")]
    else:
        offsets = [o for (o,) in _table(data, stbl[b"co64"][0], ">Q")]
    stsc = _table(data, stbl[b"stsc"][0], ">III")
    n = 0
    for i, (first, per_chunk, _) in enumerate(stsc):
        last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(offsets)
        for chunk in range(first - 1, min(last, len(offsets))):
            pos = offsets[chunk]
            for _ in range(per_chunk):
                if n >= len(sizes):
                    break
                video.packets.append(data[pos:pos + sizes[n]])
                pos += sizes[n]
                n += 1
    dts, t = [], 0
    for count, delta in _table(data, stbl[b"stts"][0], ">II") if b"stts" in stbl else []:
        for _ in range(count):
            dts.append(t)
            t += delta
    dts += [t] * (len(video.packets) - len(dts))
    pts = list(dts)
    if b"ctts" in stbl:
        k = 0
        for count, off in _table(data, stbl[b"ctts"][0], ">Ii"):
            for _ in range(count):
                if k < len(pts):
                    pts[k] += off
                k += 1
    video.shown = [True] * len(video.packets)
    edits = []
    for edts in trak.get(b"edts", []):
        for node in edts.get(b"elst", []):
            v = data[node[0]]
            fmt_e = ">QqI" if v == 1 else ">IiI"
            edits += _table(data, node, fmt_e)
    if edits and edits[0][1] == -1:
        edits = edits[1:]
    if len(edits) > 1:
        raise NotImplementedError("an MP4/MOV edit list of more than one edit")
    if edits:
        duration, start, _ = edits[0]
        stop = start + duration * media_scale // movie_scale
        keep = [p < stop for p in pts]
        video.packets = [p for p, k in zip(video.packets, keep) if k]
        video.shown = [start <= p for p, k in zip(pts, keep) if k]
    return video


def parse_mp4(data: bytes) -> Mp4Video | None:
    """The first video track and its packets, or None where FFmpeg cannot
    open the file as MP4/MOV with a video track."""
    if len(data) < 8 or data[4:8] not in (b"ftyp", b"moov", b"mdat", b"free", b"wide",
                                          b"skip", b"pnot", b"uuid"):
        return None
    top = _tree(data, 0, len(data))
    if b"moov" not in top:
        return None
    moov = top[b"moov"][0]
    movie_scale = 1
    if b"mvhd" in moov:
        version = data[moov[b"mvhd"][0][0]]
        (movie_scale,) = _full(data, moov[b"mvhd"][0], ">I", 20 if version == 1 else 12)
    for trak in moov.get(b"trak", []):
        video = _track(data, trak, max(movie_scale, 1))
        if video is not None:
            return video
    return None
