"""TIFF reading without OpenCV or libtiff.

`decode_tiff(data)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)`
returns for a TIFF file, and with `grey` the `(H, W)` image of
`cv2.IMREAD_GRAYSCALE`. OpenCV 5 reads an 8-bit image of any TIFF through
libtiff's RGBA interface (`TIFFReadRGBAStrip` / `TIFFReadRGBATile`,
`tif_getimage.c` of libtiff 4.7), so this is that interface, found by
sweeps against it:

* the first image file directory, classic (`II*\\0`, `MM\\0*`) or BigTIFF
  (`II+\\0`, `MM\\0+`), in either byte order; strips or tiles, planar
  configurations 1 and 2.
* compressions: none (1), LZW (5, MSB first with the early change of code
  width), Deflate (8, 32946, through `zlib`), PackBits (32773) and JPEG (7:
  each strip or tile a JPEG stream after the `JPEGTables` segments,
  decoded by the port's JPEG decoder, YCbCr to RGB as libjpeg does it);
  horizontal differencing (predictor 2) of 8- and 16-bit samples for LZW
  and Deflate. A codec libtiff is built without here (LZMA, ZSTD, WebP,
  JBIG, LERC, PixarLog) or that refuses every file OpenCV reads (NeXT and
  ThunderScan, of 2- and 4-bit samples) is a file `cv2.imread` returns None
  for; a number libtiff has no codec for reads as zeros; the codecs it has
  and the port does not (CCITT RLE, RLEW, G3, G4, old-style JPEG, SGILog)
  raise `NotImplementedError`, as do the CIELab photometric and old-style
  LZW. FillOrder 2 reverses each byte's bits of the strips before they
  decode (not of JPEG strips), as libtiff does. JPEG strips are YCbCr
  converted to RGB by libjpeg where the samples are YCbCr in one plane,
  else their components as they are (RGB, CMYK, grey, each separate
  plane, extra samples).
* the samples a layout may have, as OpenCV's header check and libtiff's
  `TIFFRGBAImageOK` / `PickContigCase` / `PickSeparateCase` allow them:
  min-is-white and min-is-black at 1, 8 and 16 bits, palette at 1, 4 and
  8, RGB at 8 and 16, separated (CMYK) and YCbCr at 8 (YCbCr subsampled
  1, 2 or 4 across by 1, 2 or 4 down, at most as much down as across; 1x1
  only in separate planes), with extra samples; at most 4 samples a pixel;
  unsigned or signed integer samples. Every other layout (2-bit samples,
  floats, 32-bit integers, a bad colour map, ...) is one `cv2.imread`
  returns None for, and so is a strip whose data lies past the end of the
  file.
* the conversions of libtiff's put routines: grey through its map (`x *
  255 // (2**bits - 1)`, min-is-white inverted; 16-bit grey its high
  byte), a 16-bit colour map to its high byte (an 8-bit one as it is), 16-
  to 8-bit colour `(v + 128) // 257`, unassociated alpha premultiplied
  `(c * a + 127) // 255` (associated alpha, or an unspecified extra sample
  of four or more, as they are), CMYK as `(255 - k) * (255 - c) // 255`,
  YCbCr by libtiff's own fixed-point tables (`TIFFYCbCrToRGBInit`,
  `YCbCrCoefficients` and `ReferenceBlackWhite`, nearest chroma). In
  separate planes grey goes through no map (min-is-white is not inverted,
  16 bits round) and unassociated alpha premultiplies grey too.
* libtiff's errors: a codec that runs out of data or meets a bad code
  leaves what it decoded and zeros after it (no predictor applied); a
  failed read of the second plane and on is zeros.
* the orientation tag applied (libtiff mirrors and flips; OpenCV's EXIF
  step transposes 5 to 8, and refuses its own result unless the image is
  square: a non-square image of orientation 5 to 8 is refused).
* a grey read is OpenCV's `icvCvt_BGRA2Gray` of the colour
  (`native.cv_bgr_to_grey`).

The sequential decoders run in compiled host code for `device` cuda (LZW
and PackBits as `yp_tiff_lzw` and `yp_packbits` in
`ops/csrc/host_image.cpp`, JPEG as `yp_jpeg_decode`) and in their numpy
twins (`lzw_numpy`, `packbits_numpy`, `jpeg.decode_numpy`) for `device`
cpu only; a failed build or a bad status of a compiled decoder raises.
Deflate is `zlib` (compiled C of the standard library) on both; the
predictor, the unpacking of samples and the colour conversions are numpy
on every device (the grey conversion compiled for cuda).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

SIGNATURES = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")
# codecs OpenCV's libtiff has and the port does not read
UNPORTED_CODECS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                   6: "old-style JPEG", 32771: "CCITT RLEW", 34676: "SGILog",
                   34677: "SGILog24"}
PORTED_CODECS = {1, 5, 7, 8, 32773, 32946}
# codecs libtiff knows that refuse every file here: not built into OpenCV's
# libtiff (JBIG, PixarLog, LZMA, ZSTD, WebP, LERC), or needing 2- and 4-bit
# samples, which OpenCV refuses (NeXT, ThunderScan)
REFUSED_CODECS = {34661, 32909, 34925, 50000, 50001, 34887, 32766, 32809}
# any other number is no codec of libtiff's: it reads the strips as zeros
MINISWHITE, MINISBLACK, RGB, PALETTE, SEPARATED, YCBCR = 0, 1, 2, 3, 5, 6
CIELAB, LOGL, LOGLUV = 8, 32844, 32845
ASSOC, UNASSOC = 1, 2
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
              16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d",
             13: "I", 16: "Q", 17: "q", 18: "Q"}
INT_TYPES = {1, 3, 4, 6, 8, 9, 13, 16, 17, 18}
# the integer tags read here and the largest value libtiff takes for each
_U16, _U32, _U64 = 0xFFFF, 0xFFFFFFFF, (1 << 64) - 1
INT_TAGS = {256: _U32, 257: _U32, 258: _U16, 259: _U16, 262: _U16, 266: _U16, 273: _U64,
            274: _U16, 277: _U16, 278: _U32, 279: _U64, 284: _U16, 317: _U16, 320: _U16,
            322: _U32, 323: _U32, 324: _U64, 325: _U64, 332: _U16, 338: _U16, 339: _U16,
            530: _U16}
FLOAT_TAGS = {529, 532}
STRILE_TAGS = (273, 279, 324, 325)  # strip offsets and byte counts, tile ones
# tags whose failed read makes libtiff refuse the directory (any other is ignored)
CRITICAL_TAGS = {256, 257, 258, 259, 262, 273, 277, 278, 279, 284, 322, 323, 324, 325, 338}
LZW_STATUS = {1: "bad parameters", 2: "a corrupted LZW table", 3: "not enough data"}
CODE_CLEAR, CODE_EOI, CODE_FIRST = 256, 257, 258
REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
LZW_CSIZE = 4095 + 1024  # libtiff's table: MAXCODE(12) + 1024 entries


@dataclasses.dataclass
class Directory:
    order: str
    tags: dict  # tag -> tuple of values (ints or floats) or bytes (ASCII, UNDEFINED)
    size: int = 0  # the file's bytes
    overhead: int = 0  # header, directory and out-of-line values: what libtiff
    #                   takes as not strip data where it estimates byte counts
    striles: dict = dataclasses.field(default_factory=dict)  # tag -> (type, count, at)
    data: bytes = b""

    def strile_values(self, tag: int, n: int):
        """The first `n` values (fewer if the tag has fewer) of a strip or tile
        offsets or byte counts tag, or None without it: libtiff reads no more
        than the strips it has."""
        if tag not in self.striles:
            return None
        typ, count, at = self.striles[tag]
        n = min(n, count)
        if at + n * _TYPE_SIZE[typ] > len(self.data):
            raise Unreadable(f"can not read tag {tag}'s values")
        return struct.unpack_from(self.order + _TYPE_FMT[typ] * n, self.data, at)

    def get(self, tag: int, default=None):
        return self.tags.get(tag, default)

    def first(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None or len(v) == 0 else v[0]


def parse_directory(data: bytes) -> Directory:
    """The first image file directory of a TIFF file."""
    if data[:4] not in SIGNATURES:
        raise Unreadable("not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big:
        if len(data) < 16:
            raise Unreadable("the file ends inside the header")
        size, zero, offset = struct.unpack_from(order + "HHQ", data, 4)
        if size != 8 or zero != 0:
            raise Unreadable("a bad BigTIFF header")
        count_fmt, entry_size, inline = "Q", 20, 8
    else:
        if len(data) < 8:
            raise Unreadable("the file ends inside the header")
        (offset,) = struct.unpack_from(order + "I", data, 4)
        count_fmt, entry_size, inline = "H", 12, 4
    csize = struct.calcsize(count_fmt)
    if offset < 8 or offset + csize > len(data):
        raise Unreadable("can not read the directory")
    (n,) = struct.unpack_from(order + count_fmt, data, offset)
    pos = offset + csize
    if n == 0 or pos + n * entry_size > len(data):
        raise Unreadable("can not read the directory's entries")
    tags: dict = {}
    striles: dict = {}
    overhead = (16 + 8 + 8 if big else 8 + 2 + 4) + n * entry_size
    for i in range(n):
        e = pos + i * entry_size
        if big:
            tag, typ, count = struct.unpack_from(order + "HHQ", data, e)
        else:
            tag, typ, count = struct.unpack_from(order + "HHI", data, e)
        if tag in tags or tag in striles:
            continue  # libtiff reads a repeated tag once
        critical = tag in CRITICAL_TAGS
        if typ not in _TYPE_SIZE or tag in INT_TAGS and typ not in INT_TYPES \
                or tag in FLOAT_TAGS and typ in (2, 7):
            if critical:
                raise Unreadable(f"an incompatible type {typ} for tag {tag}")
            continue  # libtiff ignores the tag
        nbytes = _TYPE_SIZE[typ] * count
        overhead += nbytes if nbytes > inline else 0
        if nbytes <= inline:
            at = e + (12 if big else 8)
        else:
            (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + (12 if big else 8))
        if tag in STRILE_TAGS:  # read later, no more values than there are strips
            striles[tag] = (typ, count, at)
            continue
        if nbytes > inline and at + nbytes > len(data):
            if critical:
                raise Unreadable(f"can not read tag {tag}'s values")
            continue
        if typ in (2, 7):
            tags[tag] = data[at:at + nbytes]
        elif typ in (5, 10):
            raw = struct.unpack_from(order + ("II" if typ == 5 else "ii") * count, data, at)
            tags[tag] = tuple(raw[k] / raw[k + 1] if raw[k + 1] else 0.0
                              for k in range(0, len(raw), 2))
        else:
            vals = struct.unpack_from(order + _TYPE_FMT[typ] * count, data, at)
            if tag in INT_TAGS and any(v < 0 or v > INT_TAGS[tag] for v in vals):
                if critical:
                    raise Unreadable(f"a value out of range for tag {tag}")
                continue
            tags[tag] = vals
    return Directory(order, tags, len(data), overhead, striles, data)


# --- the sequential decoders --------------------------------------------------


def lzw_numpy(src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    """libtiff's `LZWDecode` of one strip or tile into `occ` bytes (MSB-first
    codes of 9 to 12 bits, the width growing as the table reaches 511, 1023
    and 2047 entries): `(bytes, ok)`, the bytes it wrote before any error
    and zeros after. The twin of `yp_tiff_lzw`."""
    out = np.zeros(occ, np.uint8)
    prefix = np.zeros(LZW_CSIZE, np.int64)
    first = np.zeros(LZW_CSIZE, np.int64)
    last = np.zeros(LZW_CSIZE, np.int64)
    length = np.zeros(LZW_CSIZE, np.int64)
    first[:256] = last[:256] = np.arange(256)
    length[:256] = 1
    prefix_l, first_l, last_l, length_l = (a.tolist() for a in (prefix, first, last, length))
    nbits, free, old = 9, CODE_FIRST, -1
    maxcode = (1 << nbits) - 2  # the entry after which the width grows
    acc = nacc = pos = op = 0
    total = len(src)
    ok = True
    while op < occ:
        while nacc < nbits and pos < total:
            acc = ((acc << 8) | src[pos]) & 0xFFFFFFFF
            nacc += 8
            pos += 1
        if nacc < nbits:  # no EOI: libtiff takes it as one
            break
        code = (acc >> (nacc - nbits)) & ((1 << nbits) - 1)
        nacc -= nbits
        if code == CODE_EOI:
            break
        if code == CODE_CLEAR:
            nbits, free = 9, CODE_FIRST
            maxcode = (1 << nbits) - 2
            while nacc < nbits and pos < total:
                acc = ((acc << 8) | src[pos]) & 0xFFFFFFFF
                nacc += 8
                pos += 1
            if nacc < nbits:
                break
            code = (acc >> (nacc - nbits)) & ((1 << nbits) - 1)
            nacc -= nbits
            if code == CODE_EOI:
                break
            if code > CODE_CLEAR:
                ok = False
                break
            out[op] = code
            op += 1
            old = code
            continue
        if old < 0 or free >= LZW_CSIZE or code > free:
            ok = False
            break
        # the new entry: old's string and the first byte of code's (old's for
        # code == free)
        prefix_l[free] = old
        first_l[free] = first_l[old]
        length_l[free] = length_l[old] + 1
        last_l[free] = first_l[code] if code < free else first_l[old]
        free += 1
        if free > maxcode:
            nbits = min(nbits + 1, 12)
            maxcode = (1 << nbits) - 2
        k = length_l[code]
        c = code
        for j in range(op + k - 1, op - 1, -1):  # a string past the buffer is cut
            if j < occ:
                out[j] = last_l[c]
            c = prefix_l[c]
        op += k
        old = code
    return out, ok and op >= occ


def packbits_numpy(src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    """libtiff's `PackBitsDecode` of one strip or tile into `occ` bytes:
    `(bytes, ok)`. The twin of `yp_packbits`."""
    out = np.zeros(occ, np.uint8)
    p = op = 0
    cc = len(src)
    while cc > 0 and op < occ:
        n = src[p] - 256 if src[p] > 127 else src[p]
        p += 1
        cc -= 1
        if n < 0:
            if n == -128:
                continue
            n = min(-n + 1, occ - op)
            if cc == 0:
                break
            out[op:op + n] = src[p]
            op += n
            p += 1
            cc -= 1
        else:
            n = min(n, occ - op - 1)
            if cc < n + 1:
                break
            out[op:op + n + 1] = np.frombuffer(src, np.uint8, n + 1, p)
            op += n + 1
            p += n + 1
            cc -= n + 1
    return out, op >= occ


def _compiled(fn: str, src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    from yolopoint_tpu_torch.ops import _build

    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(occ, np.uint8)
    status = getattr(_build.library(), fn)(buf.ctypes.data_as(ctypes.c_void_p), len(buf),
                                           out.ctypes.data_as(ctypes.c_void_p), occ)
    if status == 1:  # only a caller's fault
        raise RuntimeError(f"{fn}: {LZW_STATUS[1]}")
    if status not in (0, 2, 3):
        raise RuntimeError(f"{fn}: status {status}")
    return out, status == 0


def lzw_compiled(src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    """`lzw_numpy` in compiled host code (`yp_tiff_lzw`)."""
    return _compiled("yp_tiff_lzw", src, occ)


def packbits_compiled(src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    """`packbits_numpy` in compiled host code (`yp_packbits`)."""
    return _compiled("yp_packbits", src, occ)


def deflate(src: bytes, occ: int) -> tuple[np.ndarray, bool]:
    """libtiff's `ZIPDecode` of one strip or tile into `occ` bytes: what
    zlib inflated before an error or the end of the data, zeros after."""
    out = np.zeros(occ, np.uint8)
    d = zlib.decompressobj()
    try:
        got = d.decompress(src, occ)
    except zlib.error:  # what inflate wrote before the error, a byte at a time
        d, parts, n = zlib.decompressobj(), [], 0
        for i in range(len(src)):
            try:
                part = d.decompress(src[i:i + 1], occ - n)
            except zlib.error:
                break
            parts.append(part)
            n += len(part)
            if n >= occ:
                break
        got = b"".join(parts)
        out[:len(got)] = np.frombuffer(got, np.uint8)
        return out, False
    out[:len(got)] = np.frombuffer(got, np.uint8)
    return out, len(got) >= occ


# --- the layout ------------------------------------------------------------------


@dataclasses.dataclass
class Layout:
    width: int
    height: int
    bits: int
    spp: int
    photometric: int
    compression: int
    planar: int
    predictor: int
    extras: tuple
    alpha: int
    tiled: bool
    chunk_w: int  # tile width, or the image width for strips
    chunk_h: int  # tile length, or rows a strip
    offsets: tuple
    counts: tuple
    subsampling: tuple
    orientation: int
    ycbcr_jpeg: bool  # YCbCr JPEG that libjpeg converts to RGB
    lsb_first: bool  # FillOrder 2: libtiff reverses the bits of each byte first


def _fail(msg: str):
    raise Unreadable(msg)


def layout_of(d: Directory) -> Layout:
    """The image's layout, or `Unreadable` where OpenCV or libtiff refuses
    it, `NotImplementedError` where they read it and the port does not."""
    tags = d.tags
    if 256 not in tags or 257 not in tags:
        _fail("no image size")
    if 262 not in tags:
        _fail("no photometric interpretation")  # OpenCV requires the tag
    width, height = int(d.first(256)), int(d.first(257))
    photometric = int(d.first(262))
    spp = int(d.first(277, 1))
    bits_all = d.get(258, (1,))
    bits = int(bits_all[0]) if bits_all else 1
    if len(bits_all) != 1 and (len(bits_all) < spp or len(set(bits_all[:spp])) > 1):
        _fail(f"bits a sample {bits_all} for {spp} samples")
    compression = int(d.first(259, 1))
    planar = int(d.first(284, 1))
    sample_format = int(d.first(339, 1))
    if not (0 < width and 0 < height):
        _fail(f"a {width}x{height} image")
    if spp < 1:
        _fail(f"{spp} samples a pixel")
    if planar not in (1, 2):
        _fail(f"planar configuration {planar}")
    unported = None  # raised once every check that makes OpenCV refuse the file has passed
    if compression in UNPORTED_CODECS:
        unported = f"{UNPORTED_CODECS[compression]} compression ({compression})"
    # OpenCV's readHeader
    hbits = 8 if bits > 8 and (photometric > 2 or spp not in (1, 3, 4)) else bits
    if hbits in (1, 8, 10, 12, 14, 16):
        if sample_format not in (1, 2):
            _fail(f"sample format {sample_format} at {hbits} bits")
    elif hbits == 4:
        if photometric != PALETTE:
            _fail("4-bit samples not of a palette")
        if sample_format not in (1, 2):
            _fail(f"sample format {sample_format} at 4 bits")
    elif hbits == 32:
        if sample_format not in (2, 3):
            _fail(f"sample format {sample_format} at 32 bits")
    elif hbits == 64:
        if sample_format != 3:
            _fail(f"sample format {sample_format} at 64 bits")
    else:
        _fail(f"{bits}-bit samples")
    if photometric in (LOGL, LOGLUV):
        if compression in (34676, 34677) and bits in (8, 16):
            _unported(f"SGILog samples (photometric {photometric})")
        _fail(f"photometric {photometric} without SGILog compression")
    if photometric == CIELAB:
        if spp - len(d.get(338, ())) == 3 and bits in (8, 16) and compression in PORTED_CODECS:
            _unported("CIELab samples")
        _fail("CIELab samples")
    tiled = 322 in tags or 324 in d.striles
    if tiled:
        if 322 not in tags or 323 not in tags:
            _fail("a tile size tag is missing")
        chunk_w, chunk_h = int(d.first(322)), int(d.first(323))
        if chunk_w <= 0 or chunk_h <= 0:
            _fail(f"tiles of {chunk_w}x{chunk_h}")
    else:
        rps = int(d.first(278, 0xFFFFFFFF))
        if rps == 0:
            _fail("zero rows a strip")
        chunk_w, chunk_h = width, min(rps, height)
    planes = spp if planar == 2 else 1
    per_plane = -(-height // chunk_h) * (-(-width // chunk_w) if tiled else 1)
    nchunks = per_plane * planes
    offsets = d.strile_values(324 if tiled else 273, nchunks)
    counts = d.strile_values(325 if tiled else 279, nchunks)
    if offsets is None:
        _fail("no strip or tile offsets")
    offsets = tuple(offsets[:nchunks]) + (0,) * (nchunks - len(offsets))
    if counts is None:  # libtiff estimates the counts of one strip a plane
        if nchunks != planes:
            _fail("no byte counts")
        counts = _estimate_counts(d, offsets, compression, planes, nchunks,
                                  _scanline(d, width, spp, bits, photometric, planar,
                                            compression), tiled,
                                  chunk_h * _scanline(d, chunk_w, spp, bits, photometric,
                                                      planar, compression), height)
    else:
        counts = tuple(counts[:nchunks]) + (0,) * (nchunks - len(counts))
        scanline = _scanline(d, width, spp, bits, photometric, planar, compression)
        if nchunks == 1 and not tiled and offsets[0] and (
                counts[0] == 0 or compression == 1 and (
                    offsets[0] <= d.size and counts[0] > d.size - offsets[0]
                    or counts[0] < scanline * height)):  # libtiff's ByteCountLooksBad
            counts = _estimate_counts(d, offsets, compression, planes, nchunks, scanline,
                                      tiled, 0, height)
    # OpenCV's readData checks
    th0 = chunk_h if tiled else (int(d.first(278, 0)) or height)
    if not tiled and th0 == 0xFFFFFFFF:
        th0 = height
    if not (0 < th0 <= 1 << 24) or spp > 4:
        _fail(f"{th0} rows a strip or {spp} samples a pixel")
    # libtiff's TIFFRGBAImageOK / TIFFRGBAImageBegin
    if compression in REFUSED_CODECS:
        _fail(f"compression {compression} is not read by OpenCV's libtiff")
    if bits not in (1, 2, 4, 8, 16):
        _fail(f"{bits}-bit samples")
    if sample_format == 3:
        _fail("floating-point samples")
    extras_vals = tuple(int(v) for v in d.get(338, ()))
    if any(v > 2 for v in extras_vals):
        _fail(f"extra samples {extras_vals}")
    if len(extras_vals) > spp:
        extras_vals = ()  # libtiff refuses the tag
    max_colour = {MINISWHITE: 1, MINISBLACK: 1, PALETTE: 1, RGB: 3, YCBCR: 3, SEPARATED: 4}
    colour = max_colour.get(photometric)
    if colour and spp - len(extras_vals) > colour:  # the rest are unspecified extras
        extras_vals = extras_vals + (0,) * (spp - len(extras_vals) - colour)
    alpha = 0
    if extras_vals:
        if extras_vals[0] == 0 and spp > 3:
            alpha = ASSOC
        elif extras_vals[0] in (ASSOC, UNASSOC):
            alpha = extras_vals[0]
    colour_channels = spp - len(extras_vals)
    if photometric in (MINISWHITE, MINISBLACK, PALETTE):
        if planar == 1 and spp != 1 and bits < 8:
            _fail("contiguous samples below 8 bits")
    elif photometric == RGB:
        if colour_channels < 3:
            _fail(f"RGB of {colour_channels} colour channels")
    elif photometric == SEPARATED:
        if int(d.first(332, 1)) != 1 or spp < 4:
            _fail("separated samples not CMYK")
    elif photometric != YCBCR:
        _fail(f"photometric interpretation {photometric}")
    if photometric == PALETTE and len(d.get(320, ())) != 3 << bits:
        _fail("no colour map of the right size")
    subsampling = tuple(int(v) for v in d.get(530, (2, 2)))[:2]
    if len(subsampling) < 2:
        subsampling = (2, 2)
    ycbcr_jpeg = photometric == YCBCR and compression == 7 and planar == 1
    if ycbcr_jpeg:
        photometric = RGB  # libjpeg converts to RGB (JPEGCOLORMODE_RGB)
    # PickContigCase / PickSeparateCase
    if planar == 1 or spp == 1:
        ok = ((photometric == RGB and bits in (8, 16) and spp >= 3)
              or (photometric == SEPARATED and bits == 8)
              or (photometric == PALETTE and bits in (1, 2, 4, 8))
              or (photometric in (MINISWHITE, MINISBLACK) and bits in (1, 2, 4, 8, 16))
              or (photometric == YCBCR and bits == 8 and spp == 3
                  and subsampling in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1))))
    else:
        ok = ((photometric in (MINISWHITE, MINISBLACK, RGB) and bits in (8, 16))
              or (photometric == SEPARATED and bits == 8 and spp == 4)
              or (photometric == YCBCR and bits == 8 and spp == 3 and subsampling == (1, 1)))
    if not ok:
        _fail(f"libtiff can not handle photometric {photometric} at {bits} bits, "
              f"{spp} samples, planar configuration {planar}")
    predictor = int(d.first(317, 1))
    if compression in (5, 8, 32946) and predictor != 1:
        if predictor != 2 or bits not in (8, 16):
            _fail(f"predictor {predictor} at {bits} bits")
        if photometric == YCBCR and planar == 1 and subsampling != (1, 1):
            unported = unported or "a predictor over YCbCr subsampling blocks"
    else:
        predictor = 1
    if unported:
        _unported(unported)
    return Layout(width, height, bits, spp, photometric, compression, planar, predictor,
                  extras_vals, alpha, tiled, chunk_w, chunk_h, tuple(offsets), tuple(counts),
                  subsampling, int(d.first(274, 1)), ycbcr_jpeg,
                  int(d.first(266, 1)) == 2 and compression != 7)


def _scanline(d: Directory, width: int, spp: int, bits: int, photometric: int,
              planar: int, compression: int) -> int:
    """libtiff's `TIFFScanlineSize64`."""
    if photometric == YCBCR and planar == 1 and compression != 7:
        hs, vs = (tuple(int(v) for v in d.get(530, (2, 2))) + (2, 2))[:2]
        if (hs, vs) != (1, 1) and hs and vs:
            return -(-width // hs) * (hs * vs + 2) * bits // 8 // vs
    return -(-width * (spp if planar == 1 else 1) * bits // 8)


def _estimate_counts(d: Directory, offsets, compression: int, planes: int, nchunks: int,
                     scanline: int, tiled: bool, tile_bytes: int, height: int) -> tuple:
    """libtiff's `EstimateStripByteCounts`."""
    if compression != 1:
        space = max(d.size - d.overhead, 0) // planes
        counts = [space] * nchunks
        if offsets[-1] + space > d.size:
            counts[-1] = 0 if offsets[-1] >= d.size else d.size - offsets[-1]
        return tuple(counts)
    if tiled:
        return (tile_bytes,) * nchunks
    return (scanline * (height // (nchunks // planes)),) * nchunks


def _unported(what: str):
    raise NotImplementedError(f"TIFF of {what} is not read by the port (ROADMAP Queue 1 "
                              "item 3)")


# --- decoding the strips and tiles -----------------------------------------------


def _ycbcr_blocks(L: Layout) -> bool:
    """Whether the samples are YCbCr in subsampling blocks (no JPEG)."""
    return L.photometric == YCBCR and L.planar == 1 and L.subsampling != (1, 1)


def chunk_size(L: Layout, rows: int, cols: int, samples: int) -> int:
    """The bytes libtiff decodes for `rows` x `cols` pixels of `samples`
    samples each. YCbCr blocks: whole blocks for a tile; for a strip, the
    rows rounded up to whole blocks times libtiff's scanline size, a block
    row's bytes over the vertical subsampling rounded down (4x4 blocks of an
    odd count a row lose their last bytes)."""
    if _ycbcr_blocks(L):
        hs, vs = L.subsampling
        block_row = -(-cols // hs) * (hs * vs + 2)
        if L.tiled:
            return -(-rows // vs) * block_row
        return -(-rows // vs) * vs * (block_row // vs)
    return rows * -(-cols * samples * L.bits // 8)


def _jpeg_chunk(raw: bytes, tables: bytes | None, L: Layout, rows: int, cols: int,
                samples: int, last: bool, device) -> tuple[np.ndarray, bool]:
    """One JPEG strip or tile, as libtiff's JPEG codec decodes it through
    libjpeg into `rows` x `cols` x `samples` bytes."""
    from yolopoint_tpu_torch.data import jpeg

    body = raw[2:] if raw[:2] == jpeg.SOI else raw
    head = jpeg.SOI
    if tables:
        t = tables[2:] if tables[:2] == jpeg.SOI else tables
        head += t[:-2] if t[-2:] == b"\xff\xd9" else t
    try:
        hdr = jpeg.parse_header(head + body, raw=True)
    except Unreadable as e:
        raise Unreadable(f"a bad JPEG strip or tile: {e}") from e
    if len(hdr.sampling) != samples:
        raise Unreadable("improper JPEG component count")
    ycc = L.ycbcr_jpeg and samples == 3
    want = L.subsampling if ycc else (1, 1)
    if tuple(hdr.sampling[0]) != tuple(want) or any(tuple(s) != (1, 1) for s in hdr.sampling[1:]):
        raise Unreadable(f"improper JPEG sampling factors {hdr.sampling}")
    height = hdr.height
    if not L.tiled and hdr.width == cols and hdr.height > rows and last:
        height = rows  # a last strip coded at full height: libtiff cuts it
    if hdr.width > cols or height > rows:
        raise Unreadable(f"a JPEG strip or tile of {hdr.width}x{hdr.height}, want {cols}x{rows}")
    if hdr.lossless or hdr.precision != 8:
        raise Unreadable("a lossless or 12-bit JPEG strip or tile")
    hdr = dataclasses.replace(hdr, color=jpeg.YCC if ycc else jpeg.RAW, orientation=0)
    decode = jpeg.decode_numpy if torch.device(device).type == "cpu" else jpeg.decode_compiled
    img = decode(hdr)
    if ycc:
        img = img[..., ::-1]  # BGR to the raster's RGB
    out = np.zeros((rows, cols, samples), np.uint8)
    out[:height, :hdr.width] = img.reshape(hdr.height, hdr.width, samples)[:height]
    return out.reshape(-1), height >= rows


def _predict(buf: np.ndarray, L: Layout, rows: int, cols: int, samples: int,
             order: str) -> np.ndarray:
    """Horizontal differencing undone on `rows` rows of `cols` pixels."""
    if L.bits == 8:  # sums that wrap at 8 and 16 bits, as libtiff's
        v = buf[:rows * cols * samples].reshape(rows, cols, samples)
        buf[:v.size] = np.cumsum(v, axis=1, dtype=np.uint8).reshape(-1)
    else:
        n = rows * cols * samples
        v = buf[:2 * n].view(order + "u2").reshape(rows, cols, samples)
        acc = np.cumsum(v, axis=1, dtype=np.uint16).astype(order + "u2")
        buf[:2 * n] = acc.reshape(-1).view(np.uint8)
    return buf


def decode_chunk(data: bytes, L: Layout, index: int, rows: int, cols: int, samples: int,
                 tables: bytes | None, order: str, device,
                 last: bool = False) -> tuple[np.ndarray | None, bool]:
    """The decoded bytes of strip or tile `index` (`last`: the image's last
    strip) and whether libtiff read it without an error; `(None, False)`
    where its data can not be read at all (`TIFFFillStrip` fails)."""
    size = chunk_size(L, rows, cols, samples)
    off, cnt = int(L.offsets[index]), int(L.counts[index])
    if cnt == 0 or off > len(data) or cnt > len(data) - off:
        return None, False
    if L.tiled and L.compression == 1 and cnt != size:
        return None, False  # libtiff: "Invalid tile byte count"
    raw = data[off:off + cnt]
    if L.lsb_first:
        raw = REVERSED_BITS[np.frombuffer(raw, np.uint8)].tobytes()
    cpu = torch.device(device).type == "cpu"
    if L.compression not in PORTED_CODECS:  # no codec: libtiff's strip read fails
        return np.zeros(size, np.uint8), False
    if L.compression == 1:
        if cnt < size:
            return np.zeros(size, np.uint8), False
        buf, ok = np.frombuffer(raw, np.uint8, size).copy(), True
    elif L.compression == 5:
        if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
            _unported("old-style (LSB first) LZW")
        buf, ok = (lzw_numpy if cpu else lzw_compiled)(raw, size)
    elif L.compression in (8, 32946):
        buf, ok = deflate(raw, size)
    elif L.compression == 32773:
        buf, ok = (packbits_numpy if cpu else packbits_compiled)(raw, size)
    else:  # JPEG
        buf, ok = _jpeg_chunk(raw, tables, L, rows, cols, samples, last, device)
    if ok and L.predictor == 2:
        buf = _predict(buf, L, rows, cols, samples, order)
    return buf, ok


def _skews_in_bytes(L: Layout) -> bool:
    """libtiff's put routines that skip the clipped part of a tile row by its
    pixel count in bytes: `putgreytile` / `putagreytile` (8-bit grey of more
    than one sample), `put16bitbwtile` and `put8bitcmaptile` (of more than
    one sample)."""
    if L.planar == 2 and L.spp > 1:
        return False
    if L.photometric in (MINISWHITE, MINISBLACK):
        return L.bits == 16 or (L.bits == 8 and L.spp > 1)
    return L.photometric == PALETTE and L.bits == 8 and L.spp > 1


def _unpack(buf: np.ndarray, L: Layout, rows: int, cols: int, samples: int) -> np.ndarray:
    """`(rows, cols, samples)` sample values of decoded bytes (16-bit ones
    little-endian, as libtiff's buffer holds them on the host)."""
    if L.bits == 16:
        return buf[:2 * rows * cols * samples].view("<u2").reshape(rows, cols, samples)
    if L.bits == 8:
        return buf[:rows * cols * samples].reshape(rows, cols, samples)
    rowbytes = -(-cols * samples * L.bits // 8)
    bits = np.unpackbits(buf[:rows * rowbytes].reshape(rows, rowbytes), axis=1)
    bits = bits[:, :cols * samples * L.bits].reshape(rows, cols * samples, L.bits)
    weights = (1 << np.arange(L.bits - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(2, dtype=np.uint8).reshape(rows, cols, samples)


def _ycbcr_unblock(buf: np.ndarray, L: Layout, rows: int, cols: int, w: int) -> np.ndarray:
    """`(rows, w, 3)` Y, Cb, Cr of the first `w` of `cols` columns of YCbCr
    subsampling blocks (Y in raster order within its block; each pixel the
    chroma of its block), as libtiff's `putcontig8bitYCbCr*tile` walk them:
    after each row of blocks they skip the blocks past `w`, which the 4x4
    routine counts as 10 bytes a block where a block is 18."""
    hs, vs = L.subsampling
    size = hs * vs + 2
    bw, bh = -(-w // hs), -(-rows // vs)
    skip = (cols - w) // hs * (10 if (hs, vs) == (4, 4) else size)
    starts = np.arange(bh)[:, None] * (bw * size + skip) + np.arange(bw)[None] * size
    idx = starts[..., None] + np.arange(size)
    padded = np.concatenate([buf, np.zeros(max(0, int(idx.max()) + 1 - len(buf)), np.uint8)])
    blocks = padded[idx]
    y = blocks[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3) \
        .reshape(bh * vs, bw * hs)
    cb = np.repeat(np.repeat(blocks[..., hs * vs], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(blocks[..., hs * vs + 1], vs, 0), hs, 1)
    return np.stack([y, cb, cr], 2)[:rows, :w]


def decode_samples(data: bytes, L: Layout, tables: bytes | None, order: str,
                   device) -> np.ndarray:
    """`(H, W, samples)` sample values of every plane (YCbCr blocks as Y,
    Cb, Cr a pixel), as libtiff's strip and tile reads give them."""
    H, W = L.height, L.width
    planes = L.spp if L.planar == 2 and L.spp > 1 else 1
    per_plane = 1 if planes > 1 else L.spp
    if L.compression == 7 and L.photometric == RGB and per_plane == 3:
        per_plane = 3
    out = np.zeros((H, W, planes * per_plane), np.uint16 if L.bits == 16 else np.uint8)
    tw, th = L.chunk_w, L.chunk_h
    across = -(-W // tw)
    down = -(-H // th)
    for p in range(planes):
        for r in range(down):
            for c in range(across):
                index = (p * down + r) * across + c
                y0, x0 = r * th, c * tw
                if L.tiled:
                    rows, cols = th, tw
                else:
                    rows, cols = min(th, H - y0), W
                buf, ok = decode_chunk(data, L, index, rows, cols, per_plane, tables, order,
                                       device, r == down - 1)
                if buf is None:
                    if p == 0:
                        raise Unreadable(f"can not read strip or tile {index}")
                    continue  # a later plane's failed read leaves zeros
                if L.bits == 16 and order == ">" and ok:
                    # libtiff swaps a decoded strip's words to the host's order
                    # (not where the decode failed)
                    buf = buf.view(">u2").astype("<u2").view(np.uint8)
                h, w = min(rows, H - y0), min(cols, W - x0)
                if _ycbcr_blocks(L):
                    vals = _ycbcr_unblock(buf, L, h, cols, w)
                elif w < cols and _skews_in_bytes(L):
                    # the put routine steps a clipped tile's rows by its visible
                    # pixels and `cols - w` bytes more (not pixels)
                    step = w * per_plane * L.bits // 8
                    starts = np.arange(h) * (step + cols - w)
                    rowbuf = buf[(starts[:, None] + np.arange(step)).reshape(-1)]
                    vals = _unpack(rowbuf, L, h, w, per_plane)
                else:
                    vals = _unpack(buf, L, rows, cols, per_plane)
                out[y0:y0 + h, x0:x0 + w, p * per_plane:(p + 1) * per_plane] = vals[:h, :w]
    return out


# --- libtiff's put routines ------------------------------------------------------


def ycbcr_tables(luma, ref_bw) -> tuple[np.ndarray, ...]:
    """libtiff's `TIFFYCbCrToRGBInit`: `(Y, Cr_r, Cb_b, Cr_g, Cb_g)` tables
    indexed by the raw 8-bit sample."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    rbw = [f32(v) for v in ref_bw]

    def fix(x):
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clampf(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    f1 = f32(f32(2) - f32(2) * lr)
    d1 = fix(clampf(f1, f32(0), f32(2)))
    f2 = f32(f32(lr * f1) / lg)
    d2 = -fix(clampf(f2, f32(0), f32(2)))
    f3 = f32(f32(2) - f32(2) * lb)
    d3 = fix(clampf(f3, f32(0), f32(2)))
    f4 = f32(f32(lb * f3) / lg)
    d4 = -fix(clampf(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = f32(rw - rb)
        den = den if den != 0 else f32(1)
        return f32(f32(f32(c - int(rb)) * f32(cr)) / den)

    def to_int(v):
        v = clampf(v, f32(-128 * 32), f32(128 * 32))
        return int(v)  # truncation toward zero

    y_tab, cr_r, cb_b, cr_g, cb_g = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = to_int(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = to_int(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        cr_r[i] = (d1 * cr + 32768) >> 16
        cb_b[i] = (d3 * cb + 32768) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + 32768
        y_tab[i] = to_int(code2v(x + 128, rbw[0], rbw[1], 255))
    return y_tab, cr_r, cb_b, cr_g, cb_g


def ycbcr_to_rgb(ycc: np.ndarray, tables) -> np.ndarray:
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    y, cb, cr = (np.clip(ycc[..., i], 0, 255) for i in range(3))
    yv = y_tab[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255)


# libtiff's Bitdepth16To8 and UaToAa, as tables
_TO8 = ((np.arange(65536) + 128) // 257).astype(np.uint8)
_PREMULTIPLY = ((np.arange(256)[:, None] * np.arange(256)[None] + 127) // 255).astype(np.uint8)


def to_rgb(s: np.ndarray, L: Layout, d: Directory) -> np.ndarray:
    """uint8 `(H, W, 3)` RGB of the samples as libtiff's put routines make
    them (the alpha dropped as OpenCV drops it)."""
    ph, bits, contig = L.photometric, L.bits, L.planar == 1 or L.spp == 1
    if ph in (MINISWHITE, MINISBLACK):
        v = s[..., 0]
        if contig:  # the grey map of 2**bits entries (16 bits: of the high byte)
            rng = 255 if bits == 16 else (1 << bits) - 1
            x = np.arange(rng + 1)
            lut = ((rng - x if ph == MINISWHITE else x) * 255 // rng).astype(np.uint8)
            return np.repeat(lut[v >> 8 if bits == 16 else v][..., None], 3, 2)
        rgb = np.repeat(v[..., None], 3, 2)
        a = s[..., 1] if L.alpha else None
        if bits == 16:
            rgb = _TO8[rgb]
            a = None if a is None else _TO8[a]
        if L.alpha == UNASSOC:
            rgb = _PREMULTIPLY[a[..., None], rgb]
        return rgb
    if ph == PALETTE:
        cmap = np.asarray(d.get(320), np.int64).reshape(3, 1 << bits)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[s[..., 0]]
    if ph == RGB:
        rgb = s[..., :3]
        a = s[..., 3] if L.alpha and L.spp >= 4 else None
        if bits == 16:
            rgb = _TO8[rgb]
            a = None if a is None else _TO8[a]
        if L.alpha == UNASSOC and a is not None:
            rgb = _PREMULTIPLY[a[..., None], rgb]
        return rgb
    if ph == SEPARATED:
        k = 255 - s[..., 3:4].astype(np.int32)
        return (k * (255 - s[..., :3].astype(np.int32)) // 255).astype(np.uint8)
    # YCbCr
    luma = d.get(529, (0.299, 0.587, 0.114))
    ref = d.get(532) or (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)
    if len(luma) < 3 or len(ref) < 6 or not luma[1] or any(np.isnan(luma)):
        _fail("bad YCbCr coefficients or reference black and white")
    return ycbcr_to_rgb(s[..., :3], ycbcr_tables(luma[:3], ref[:6])).astype(np.uint8)


# the orientation tag, as libtiff's flips and OpenCV's EXIF transposition leave it
ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
          4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
          6: lambda a: np.rot90(a, -1), 7: lambda a: np.rot90(a, 2).transpose(1, 0, 2),
          8: lambda a: np.rot90(a, 1)}


def decode_tiff(data: bytes, name: str = "<tiff>", device: str | torch.device = "cuda",
                grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a TIFF file's bytes, or with `grey` `(H, W)`."""
    from yolopoint_tpu_torch.data.native import grey_for
    from yolopoint_tpu_torch.data.netpbm import MAX_PIXELS, MAX_SIDE

    try:
        d = parse_directory(data)
        L = layout_of(d)
        if 5 <= L.orientation <= 8 and L.width != L.height:
            _fail(f"orientation {L.orientation} of a non-square image (OpenCV's transposed "
                  "image is refused)")
        if max(L.width, L.height) > MAX_SIDE or L.width * L.height > MAX_PIXELS:
            _fail(f"a {L.width}x{L.height} image is too large to read")
        tables = d.get(347) if L.compression == 7 else None
        if tables is not None and not isinstance(tables, bytes):
            tables = bytes(int(v) & 0xFF for v in tables)
        s = decode_samples(data, L, tables, d.order, device)
        rgb = to_rgb(s, L, d)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    except NotImplementedError as e:
        raise NotImplementedError(f"{name}: {e}") from e
    rgb = ORIENT[L.orientation if 1 <= L.orientation <= 8 else 1](rgb)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    return grey_for(device).bgr(bgr) if grey else bgr


def read_tiff(path: str | Path, device: str | torch.device = "cuda",
              grey: bool = False) -> np.ndarray:
    """`decode_tiff` of a file."""
    return decode_tiff(Path(path).read_bytes(), str(path), device, grey)
