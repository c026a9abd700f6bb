"""JPEG reading without OpenCV, Pillow or a JPEG library.

`read_jpeg(path)` returns what `cv2.imread(path, cv2.IMREAD_COLOR)` returns
for an 8-bit JPEG file with one, three or four components: baseline or
extended sequential (SOF0, SOF1, SOF9: one scan, or one a component or
group) or progressive (SOF2, SOF10), Huffman or arithmetic coded, and
lossless (SOF3, 2- to 8-bit samples): uint8 `(H, W, 3)` in BGR order, bit
for bit; with `grey`, the `(H, W)` image of `IMREAD_GRAYSCALE` (libjpeg's
JCS_GRAYSCALE: the Y component alone of a YCbCr or grey file, never
upsampled chroma; `rgb_gray_convert` of an RGB one; OpenCV's own grey of a
CMYK or YCCK one). OpenCV decodes with libjpeg-turbo's
default settings (the islow integer IDCT, fancy upsampling, block
smoothing), so its code is the spec:

* Huffman decoding as `jdhuff.c` (sequential) and `jdphuff.c` (DC first
  and refine, AC first and refine with EOB runs): the DC predictors and
  the EOB run reset, with the bit buffer, at each restart marker; `FF 00`
  (and `FF FF .. 00`) is one `FF` byte; a segment that ends early is read
  on as zero bits, and the MCUs after the one that ran out are left as
  they are until a restart marker is read (this is what a truncated file
  gives: libjpeg-turbo's file source ends every file with fake EOI
  markers, which a cut marker segment reads as its bytes). The
  coefficients of every scan go to one buffer on the MCU grid.
* Arithmetic decoding as `jdarith.c` (`data/jpeg_arith.py`: the QM coder,
  DAC conditioning, the same five scan kinds) into the same buffer.
* Lossless files as `jdlhuff.c`, `jddiffct.c` and `jdlossls.c`
  (`data/jpeg_lossless.py`): predicted samples in place of coefficients,
  no IDCT, upsampled by replication, no colour conversion but OpenCV's
  CMYK one (so a one-component file reads in grey only, a three-component
  one in colour only: `lossless_refused`).
* `jdcoefct.c`'s block smoothing of a progressive file whose first nine AC
  coefficients are not complete (`block_smoothing`, `smooth_blocks`).
* `jidctint.c`'s `jpeg_idct_islow` (`CONST_BITS` 13, `PASS1_BITS` 2) as
  its SIMD version saturates (`idct_islow`).
* `jdsample.c`'s choice of upsampler (`h2v1` and `h2v2` fancy only where
  the downsampled width exceeds 2, `h1v2` fancy, replication for every
  other integral ratio) with `jdmainct.c`'s context rows: edges replicated
  at the last real row and column of the downsampled plane.
* `jdcolor.c`'s fixed-point YCbCr tables (`SCALEBITS` 16); grey repeated to
  three channels; Adobe-transform-0 and `R G B`-labelled files copied.
* Four components: CMYK (an Adobe transform of 0, or no Adobe segment) or
  YCCK (any other transform) as `jdapimin.c` infers them, libjpeg-turbo's
  CMYK output (`ycck_cmyk_convert` of YCCK), then OpenCV's
  `icvCvt_CMYK2BGR_8u_C4C3R` or `icvCvt_CMYK2Gray_8u_C4C1R` (`cmyk_bgr`).
* The EXIF orientation (IFD0 tag 0x0112 of the first APP1 segment) applied
  last, as `cv2.imread` applies it.

The markers are parsed here. The decode itself (entropy decoding,
smoothing, IDCT, upsampling, colour conversion) runs in compiled host code
(`yp_jpeg_decode` in `ops/csrc/host_image.cpp`, built with the CUDA
kernels) for `device` cuda, and in its numpy twin, `decode_numpy` (a
Python bit loop, for test sizes), for `device` cpu only. Every kind that
libjpeg-turbo refuses or that `cv2.imread` returns None for (hierarchical
and lossless arithmetic-coded files, other precisions, two components, a
lossless file in a read libjpeg-turbo cannot convert to) and every
malformed stream raises `Unreadable`, which `read_jpeg` turns into the
`FileNotFoundError` that the JAX package's `_imread` raises where
`cv2.imread` returns None.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from yolopoint_tpu_torch.data.errors import Unreadable

SOI = b"\xff\xd8"
# jpeg_natural_order: the natural (row-major) index of zigzag position k,
# with 16 extra entries that absorb a corrupt run past the last coefficient
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
NATURAL = [*ZIGZAG.tolist(), *[63] * 16]
# the Huffman tables of the standard's Annex K.3, which libjpeg-turbo takes
# for a table a file uses but does not define (Motion-JPEG frames): counts
# of codes of each length 1..16, then the symbols
STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272"
        "82090a161718191a25262728292a3435363738393a434445464748494a53545556575859"
        "5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3"
        "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
        "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758"
        "595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
        "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}
# SOFn markers of the coding processes that libjpeg-turbo refuses (so
# `cv2.imread` returns None): hierarchical, and lossless arithmetic-coded
REFUSED_SOF = {0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
               0xCB: "lossless arithmetic-coded", 0xCD: "hierarchical",
               0xCE: "hierarchical", 0xCF: "hierarchical"}
# the processes that are read: baseline and extended sequential, progressive
# and lossless, Huffman (C0-C3) and arithmetic (C9, CA) coded
SEQUENTIAL_SOF, PROGRESSIVE_SOF, LOSSLESS_SOF = (0xC0, 0xC1, 0xC9), (0xC2, 0xCA), 0xC3
ARITHMETIC_SOF = (0xC9, 0xCA)
RST0, EOI = 0xD0, 0xD9
# colour conversion of the three-, one- and four-component files
YCC, RGB, GREY, CMYK, YCCK = 0, 1, 2, 3, 4
# the components as they are, no colour conversion (libjpeg's JCS_UNKNOWN:
# what libtiff reads of a JPEG strip that is not YCbCr)
RAW = 5
MAX_BLOCKS_IN_MCU = 10  # libjpeg's D_MAX_BLOCKS_IN_MCU
MAX_COMPS_IN_SCAN = 4
FAKE_EOI_TAIL = b"\xff\xd9" * 0x8000
# the natural-order positions of the DC and the first nine AC coefficients,
# whose completeness decides libjpeg-turbo's block smoothing
SMOOTHED = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
# frame limits, checked before anything is allocated: a side above
# libjpeg's JPEG_MAX_DIMENSION (`cv2.imread` returns None) or more pixels
# than OpenCV's CV_IO_MAX_IMAGE_PIXELS (`cv2.imread` raises)
MAX_SIDE, MAX_PIXELS = 65500, 1 << 30
# the ints of a scan in `yp_jpeg_decode`'s scan table: 12, then for each of
# four scan components its DC and AC table numbers and the arithmetic
# conditioning (L, U, Kx) of those tables
SCAN_FIELDS = 12 + 4 * 5
NUM_ARITH_TBLS = 16
DEFAULT_CONDITIONING = (0, 1, 5)  # DC L and U, AC Kx: what SOI resets (jdmarker.c)


@dataclass
class Scan:
    """One scan: the frame indices of its components in scan order, its
    spectral band `ss..se` and successive-approximation bits `ah`, `al` (a
    lossless scan's predictor and point transform are `ss` and `al`), the
    `(bits, values)` DC and AC Huffman tables of each component (None where
    the scan reads none, and in an arithmetic-coded file), the restart
    interval in force, its entropy-coded data, closed by an EOI marker (`FF
    D9`), and each component's `(DC, AC)` table numbers and the arithmetic
    conditioning `(L, U, Kx)` of those tables when the scan began."""

    comps: list[int]
    ss: int
    se: int
    ah: int
    al: int
    huffman: list[tuple]
    restart: int
    data: bytes
    tables: list[tuple[int, int]]
    conditioning: list[tuple[int, int, int]]


@dataclass
class Header:
    """What the decoder needs of a file's markers. Components are in frame
    order; `quant` holds each component's table as libjpeg latches it, at
    the first scan that holds the component (zeros for a component no scan
    holds). A file that ends inside a scan ends there, as libjpeg-turbo's
    file source closes it with a fake EOI marker."""

    width: int
    height: int
    sampling: list[tuple[int, int]]      # (h, v) of each component
    quant: np.ndarray                    # (components, 64) int64, natural order
    scans: list[Scan]
    progressive: bool
    color: int
    orientation: int
    arithmetic: bool = False
    lossless: bool = False
    precision: int = 8


def _check_huffman(bits, values, is_dc: bool, name: str, dc_max: int = 15) -> None:
    """libjpeg-turbo's table checks (`jpeg_make_d_derived_tbl`): at most 256
    codes, no code of all ones, DC symbols up to `dc_max` (16 in a lossless
    file)."""
    if sum(bits) > 256 or len(values) < sum(bits):
        raise Unreadable(f"{name}: bad Huffman table")
    code = 0
    for length, count in enumerate(bits, 1):
        code += count
        if count and code >= 1 << length:
            raise Unreadable(f"{name}: bad Huffman table")
        code <<= 1
    if is_dc and any(v > dc_max for v in values[:sum(bits)]):
        raise Unreadable(f"{name}: bad Huffman table")


def _exif_orientation(payload: bytes) -> int:
    """Orientation (1-8, else 0) of an APP1 payload as OpenCV's ExifReader
    reads it: a TIFF header 6 bytes in, IFD0, tag 0x0112 as a SHORT."""
    tiff = payload[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 0
    end = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(end + "H", tiff[2:4])[0] != 0x2A:
        return 0
    ifd = struct.unpack(end + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 0
    (count,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for e in range(ifd + 2, ifd + 2 + 12 * count, 12):
        if e + 12 > len(tiff):
            return 0
        if struct.unpack(end + "H", tiff[e:e + 2])[0] == 0x0112:
            value = struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
            return value if 1 <= value <= 8 else 0
    return 0


def _next_marker(data: bytes, pos: int, name: str) -> tuple[int, int]:
    """`(marker, offset past it)` of the next marker at or after `pos`,
    skipping other bytes and `FF` fill bytes as libjpeg's `next_marker`."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            raise Unreadable(f"{name}: no EOI marker (file ends inside the header)")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise Unreadable(f"{name}: no EOI marker (file ends inside the header)")
        if data[pos]:
            return data[pos], pos + 1


def _scan_end(data: bytes, pos: int) -> int:
    """Offset of the marker that ends the entropy-coded data starting at
    `pos` (its first `FF`), skipping stuffed `FF 00` bytes and restart
    markers; `len(data)` where the file ends first."""
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            return n
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            return n
        if data[k] and not RST0 <= data[k] < RST0 + 8:
            return j
        pos = k + 1


def _check_scan(ss: int, se: int, ah: int, al: int, ns: int, name: str) -> None:
    """`start_pass_phuff_decoder`'s checks of a progressive scan's band and
    bits (`JERR_BAD_PROGRESSION`)."""
    bad = se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1)
    if bad or (ah and al != ah - 1) or al > 13:
        raise Unreadable(f"{name}: bad progressive scan (Ss={ss} Se={se} Ah={ah} Al={al})")


def parse_header(data: bytes, name: str = "<jpeg>", raw: bool = False) -> Header:
    """The markers and scans of a JPEG file. Raises `Unreadable` on a
    malformed stream and on every kind that libjpeg-turbo refuses or that
    `cv2.imread` returns None for (hierarchical and lossless
    arithmetic-coded files, precisions other than 8 (2 to 8 lossless), two
    or more than four components, a lossless scan that is not one, a
    lossless file's restart interval that is not whole MCU rows); which
    reads of a lossless file libjpeg-turbo refuses is `lossless_refused`'s
    to say. A sequential or lossless file whose first scan holds every
    component is one scan
    (libjpeg's single-pass mode); otherwise every scan up to EOI (or the
    end of the file) is kept."""
    if data[:2] != SOI:
        raise Unreadable(f"{name}: not a JPEG file (no SOI marker)")
    pos, frame, quant, tables, restart = 2, None, {}, {}, 0
    conditioning = [list(DEFAULT_CONDITIONING) for _ in range(NUM_ARITH_TBLS)]
    file_size = len(data)
    jfif = adobe = progressive = arithmetic = lossless = False
    precision = 8
    transform = exif = None
    scans, latched = [], {}

    def segment(at: int) -> bytes:
        nonlocal data
        if at + 2 + 0xFFFF > len(data) and not data.endswith(FAKE_EOI_TAIL):
            # where the file ends inside a segment, libjpeg-turbo's file source
            # reads on fake EOI markers: here as many as a segment can hold
            data = data + FAKE_EOI_TAIL
        if at + 2 > len(data):
            raise Unreadable(f"{name}: file ends inside a marker segment")
        (length,) = struct.unpack(">H", data[at:at + 2])
        if length < 2 or at + length > len(data):
            raise Unreadable(f"{name}: bad or truncated marker segment")
        return data[at + 2:at + length]

    while True:
        if scans and pos >= len(data):
            break  # the file ended inside a scan: libjpeg's fake EOI
        marker, pos = _next_marker(data, pos, name)
        if marker == EOI:
            if not scans:
                raise Unreadable(f"{name}: no image (EOI before the first scan)")
            break
        if RST0 <= marker < RST0 + 8 or marker == 0x01:
            continue  # a standalone marker: libjpeg skips it
        body = segment(pos)
        pos += 2 + len(body)
        if marker in REFUSED_SOF:
            raise Unreadable(f"{name}: {REFUSED_SOF[marker]} JPEG files are not read by "
                             "libjpeg-turbo")
        if marker in (*SEQUENTIAL_SOF, *PROGRESSIVE_SOF, LOSSLESS_SOF):
            if frame is not None:
                raise Unreadable(f"{name}: two SOF markers")
            if pos > file_size:  # read on fake EOI markers: libjpeg refuses them as a frame
                raise Unreadable(f"{name}: file ends inside the SOF segment")
            if len(body) < 6:
                raise Unreadable(f"{name}: short SOF segment")
            precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
            lossless = marker == LOSSLESS_SOF
            if not (2 <= precision <= 8 if lossless else precision == 8):
                raise Unreadable(f"{name}: {precision}-bit JPEG files are not read by OpenCV")
            if ncomp not in (1, 3, 4) and not (raw and ncomp == 2):  # no colour conversion
                raise Unreadable(f"{name}: {ncomp}-component JPEG files are not read")
            if height == 0 or width == 0 or len(body) < 6 + 3 * ncomp:
                raise Unreadable(f"{name}: bad SOF segment")
            if max(height, width) > MAX_SIDE or height * width > MAX_PIXELS:
                raise Unreadable(f"{name}: a {width}x{height} frame is too large to read")
            comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(ncomp)]
            for _, hv, tq in comps:
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    raise Unreadable(f"{name}: bad sampling factor or table index")
            frame = (width, height, comps)
            progressive = marker in PROGRESSIVE_SOF
            arithmetic = marker in ARITHMETIC_SOF
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                if i + 17 > len(body):
                    raise Unreadable(f"{name}: short DHT segment")
                index, bits = body[i], tuple(body[i + 1:i + 17])
                count = sum(bits)
                if count > 256 or i + 17 + count > len(body) or (index & 15) > 3 \
                        or index >> 4 > 1:
                    raise Unreadable(f"{name}: bad DHT segment")
                tables[(index >> 4, index & 15)] = (bits, bytes(body[i + 17:i + 17 + count]))
                i += 17 + count
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if tq > 3 or i + 1 + size > len(body):
                    raise Unreadable(f"{name}: bad DQT segment")
                vals = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                i += 1 + size
        elif marker == 0xCC:  # DAC: arithmetic conditioning (get_dac)
            if len(body) % 2:
                raise Unreadable(f"{name}: bad DAC segment length")
            for index, val in zip(body[0::2], body[1::2]):
                if index >= 2 * NUM_ARITH_TBLS:
                    raise Unreadable(f"{name}: bad DAC table index {index}")
                if index >= NUM_ARITH_TBLS:
                    conditioning[index - NUM_ARITH_TBLS][2] = val
                elif val & 15 > val >> 4:
                    raise Unreadable(f"{name}: DAC L above U ({val:#x})")
                else:
                    conditioning[index][:2] = [val & 15, val >> 4]
        elif marker == 0xDD:
            if len(body) < 2:
                raise Unreadable(f"{name}: short DRI segment")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif marker == 0xE1:
            if exif is None:
                exif = _exif_orientation(body)
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe, transform = True, body[11]
        elif marker == 0xDA:
            if frame is None:
                raise Unreadable(f"{name}: SOS before SOF")
            ids = [c[0] for c in frame[2]]
            ns = body[0] if body else 0
            if not 1 <= ns <= MAX_COMPS_IN_SCAN or len(body) < 1 + 2 * ns + 3:
                raise Unreadable(f"{name}: bad SOS segment")
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if progressive:
                _check_scan(ss, se, ah, al, ns, name)
            if lossless and not (1 <= ss <= 7 and se == 0 and ah == 0 and al < precision):
                raise Unreadable(f"{name}: bad lossless scan (Ss={ss} Se={se} Ah={ah} Al={al})")
            members, huffman, numbers = [], [], []
            for i in range(ns):
                cid, td_ta = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids or ids.index(cid) in members:
                    raise Unreadable(f"{name}: bad component in SOS")
                members.append(ids.index(cid))
                numbers.append((td_ta >> 4, td_ta & 15))
                # the Huffman tables the scan reads: DC in a sequential scan
                # and a first DC scan, AC in a sequential scan and every AC
                # scan; a lossless scan's differences on its DC table
                need = ((not progressive or (ss == 0 and ah == 0)),
                        (not progressive and not lossless) or ss > 0)
                pair = []
                for cls, tbl in ((0, td_ta >> 4), (1, td_ta & 15)):
                    found = None
                    if need[cls] and not arithmetic:
                        if tbl > 3:
                            raise Unreadable(f"{name}: Huffman table {cls}/{tbl} is not valid")
                        found = tables.get((cls, tbl)) or STD_HUFFMAN.get((cls, tbl))
                        if found is None:
                            raise Unreadable(f"{name}: Huffman table {cls}/{tbl} is not defined")
                        _check_huffman(*found, cls == 0, name, 16 if lossless else 15)
                    pair.append(found)
                huffman.append(tuple(pair))
            sampling = [(c[1] >> 4, c[1] & 15) for c in frame[2]]
            if ns > 1 and sum(sampling[c][0] * sampling[c][1] for c in members) \
                    > MAX_BLOCKS_IN_MCU:
                raise Unreadable(f"{name}: more than {MAX_BLOCKS_IN_MCU} blocks in an MCU")
            for c in members:  # latch_quant_tables (not in lossless mode)
                if c not in latched and not lossless:
                    if frame[2][c][2] not in quant:
                        raise Unreadable(f"{name}: quantization table is not defined")
                    latched[c] = quant[frame[2][c][2]].copy()
            end = _scan_end(data, pos)
            scans.append(Scan(comps=members, ss=ss, se=se, ah=ah, al=al, huffman=huffman,
                              restart=restart, data=data[pos:end] + b"\xff\xd9",
                              tables=numbers,
                              conditioning=[(*conditioning[d][:2], conditioning[a][2])
                                            for d, a in numbers]))
            pos = end
            if not progressive and len(scans[0].comps) == len(ids):
                break  # single-pass mode: the first scan holds every component
    width, height, comps = frame
    ids = [c[0] for c in comps]
    if len(comps) == 1:
        color = GREY
    elif len(comps) == 4:  # an Adobe transform but 0 is YCCK, else straight CMYK
        color = YCCK if adobe and transform != 0 else CMYK
    elif jfif:
        color = YCC
    elif adobe:  # any transform but 0 is YCbCr (libjpeg warns of one but 1)
        color = RGB if transform == 0 else YCC
    else:  # a lossless file of unknown IDs is RGB (jdapimin.c)
        color = RGB if ids == [82, 71, 66] or lossless else YCC
    quant_out = np.stack([latched.get(c, np.zeros(64, np.int64)) for c in range(len(comps))])
    hdr = Header(width=width, height=height, sampling=[(c[1] >> 4, c[1] & 15) for c in comps],
                 quant=quant_out, scans=scans, progressive=progressive, color=color,
                 orientation=exif or 0, arithmetic=arithmetic, lossless=lossless,
                 precision=precision)
    if lossless:  # jddiffct.c: restart intervals of whole MCU rows only
        mx, _, _, sizes = geometry(hdr, 1)
        for scan in scans:
            row = sizes[scan.comps[0]][1] if len(scan.comps) == 1 else mx
            if scan.restart % row:
                raise Unreadable(f"{name}: a lossless restart interval of {scan.restart} MCUs "
                                 f"is not whole rows of {row}")
    return hdr


def segments(data: bytes) -> list[bytes]:
    """A scan's entropy-coded data split at restart markers, unstuffed: `FF
    00` (and `FF FF .. 00`) is one `FF` byte; the segments end at the first
    marker that is not the next restart marker in sequence."""
    out, seg, pos, expect, n = [], bytearray(), 0, RST0, len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:  # cannot happen: `data` ends with FF D9
            out.append(bytes(seg + data[pos:]))
            return out
        seg += data[pos:j]
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            out.append(bytes(seg))
            return out
        if data[k] == 0:
            seg.append(0xFF)
            pos = k + 1
            continue
        out.append(bytes(seg))
        if data[k] != expect:
            return out
        seg, pos, expect = bytearray(), k + 1, RST0 + (expect - RST0 + 1) % 8


def geometry(hdr: Header, block: int = 8) -> tuple[int, int, list[tuple[int, int]],
                                                   list[tuple[int, int]]]:
    """`(mcus_x, mcus_y, blocks, sizes)`: the frame's MCU grid, each
    component's coefficient grid `(rows, cols)` of blocks (the MCU grid's,
    which covers the blocks of its own non-interleaved scans), and its
    downsampled size `(h, w)`; `block` 1 for a lossless file's samples."""
    hmax = max(h for h, _ in hdr.sampling)
    vmax = max(v for _, v in hdr.sampling)
    sizes = [(-(-hdr.height * v // vmax), -(-hdr.width * h // hmax)) for h, v in hdr.sampling]
    mx, my = -(-hdr.width // (block * hmax)), -(-hdr.height // (block * vmax))
    return mx, my, [(my * v, mx * h) for h, v in hdr.sampling], sizes


def mcu_blocks(hdr: Header, scan: Scan):
    """`(MCUs, blocks_of)` of a DCT scan: `blocks_of(m)` lists `(slot,
    component, offset of the block's first coefficient in the component's
    buffer)` of MCU `m` in the order the scan codes them (an interleaved
    scan: each component's `v x h` blocks of the MCU in turn; a
    non-interleaved one: the component's own blocks, one an MCU)."""
    mx, my, blocks, sizes = geometry(hdr)
    single = len(scan.comps) == 1
    if single:
        dh, dw = sizes[scan.comps[0]]
        ux, uy = -(-dw // 8), -(-dh // 8)
    else:
        ux, uy = mx, my
    layout = [(s, ci, v, h, *((1, 1) if single else hdr.sampling[ci]))
              for s, ci in enumerate(scan.comps)
              for v in range(1 if single else hdr.sampling[ci][1])
              for h in range(1 if single else hdr.sampling[ci][0])]

    def blocks_of(m: int) -> list[tuple[int, int, int]]:
        row, col = divmod(m, ux)
        return [(s, ci, ((row * vs + dv) * blocks[ci][1] + col * hs + dh) * 64)
                for s, ci, dv, dh, hs, vs in layout]

    return ux * uy, blocks_of


def _lut(bits, values) -> list[int]:
    """16-bit lookahead table of a Huffman table: `(length << 8) | symbol`
    for each 16-bit prefix; a prefix of no code reads as 17 bits and symbol
    0, as libjpeg's `jpeg_huff_decode` does."""
    lut = np.full(1 << 16, 17 << 8, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            start = code << (16 - length)
            lut[start:start + (1 << (16 - length))] = (length << 8) | values[k]
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


class _Bits:
    """The bits of one unstuffed segment, read on as zero bits past its end
    (`jpeg_fill_bit_buffer` at a marker)."""

    def __init__(self, seg: bytes):
        raw = np.frombuffer(seg + bytes(4096), np.uint8).astype(np.int64)
        self.words = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8) | raw[3:]).tolist()
        self.nbits, self.pos = 8 * len(seg), 0

    def get(self, s: int) -> int:
        v = (self.words[self.pos >> 3] >> (32 - (self.pos & 7) - s)) & ((1 << s) - 1)
        self.pos += s
        return v

    def decode(self, lut: list[int]) -> int:
        e = lut[(self.words[self.pos >> 3] >> (16 - (self.pos & 7))) & 0xFFFF]
        self.pos += e >> 8
        return e & 255


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _i16(v: int) -> int:
    """A JCOEF store: `v` wrapped to int16."""
    return ((v + 32768) & 0xFFFF) - 32768


def decode_scan_numpy(hdr: Header, scan: Scan, coef: list[list[int]]) -> int:
    """One scan's entropy decode into the coefficient buffers `coef` (per
    component a flat list over `geometry`'s grid, natural order): a
    sequential scan as `jdhuff.c`, a progressive one as `jdphuff.c` (DC
    first and refine, AC first and refine with EOB runs). At each restart
    the DC predictors and the EOB run are zeroed; where a segment runs out,
    its MCUs after the one that ran out are left as they are until a
    restart marker is read (what a truncated file gives)."""
    total, blocks_of = mcu_blocks(hdr, scan)
    luts = [tuple(_lut(*t) if t else None for t in pair) for pair in scan.huffman]
    if not hdr.progressive:
        mode = "sequential"
    elif scan.ss == 0:
        mode = "dc_refine" if scan.ah else "dc_first"
    else:
        mode = "ac_refine" if scan.ah else "ac_first"
    ss, se = scan.ss, scan.se
    al = scan.al if hdr.progressive else 0  # a sequential scan's Al is not read
    p1, m1 = 1 << al, -(1 << al)
    segs = segments(scan.data)
    interval = scan.restart or total
    short, ran_out = False, -1
    for first in range(0, total, interval):
        # a restart: fill bits dropped, DC predictors and the EOB run
        # zeroed; a missing segment (its restart marker was not found) reads
        # as zero bits and keeps the out-of-data state
        index = first // interval
        if index < len(segs):
            seg, short = segs[index], False
        else:
            seg = b""
        bits = _Bits(seg)
        pred = [0] * len(scan.comps)
        eobrun = 0
        for m in range(first, min(first + interval, total)):
            if short:
                continue
            for slot, ci, b in blocks_of(m):
                out = coef[ci]
                dc_lut, ac_lut = luts[slot]
                if mode in ("sequential", "dc_first"):
                    s = bits.decode(dc_lut)
                    pred[slot] += _extend(bits.get(s), s) if s else 0
                    out[b] = _i16(pred[slot] << al)
                elif mode == "dc_refine":
                    if bits.get(1):
                        out[b] = _i16(out[b] | p1)
                if mode == "sequential":
                    k = 1
                    while k < 64:
                        rs = bits.decode(ac_lut)
                        s = rs & 15
                        if s:
                            k += rs >> 4
                            out[b + NATURAL[k]] = _extend(bits.get(s), s)
                        elif rs >> 4 == 15:
                            k += 15
                        else:
                            break
                        k += 1
                elif mode == "ac_first":
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = bits.decode(ac_lut)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            out[b + NATURAL[k]] = _i16(_extend(bits.get(s), s) << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + (bits.get(r) if r else 0) - 1
                            break
                        k += 1
                elif mode == "ac_refine":
                    k = ss
                    if not eobrun:
                        while k <= se:
                            rs = bits.decode(ac_lut)
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if bits.get(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + (bits.get(r) if r else 0)
                                break
                            while True:  # the coefficients the run passes over
                                pos = b + NATURAL[k]
                                if out[pos]:
                                    if bits.get(1) and not out[pos] & p1:
                                        out[pos] = _i16(out[pos] + (p1 if out[pos] >= 0 else m1))
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                                if k > se:
                                    break
                            if s:
                                out[b + NATURAL[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            pos = b + NATURAL[k]
                            if out[pos] and bits.get(1) and not out[pos] & p1:
                                out[pos] = _i16(out[pos] + (p1 if out[pos] >= 0 else m1))
                            k += 1
                        eobrun -= 1
            if bits.pos > bits.nbits:
                short = True
                ran_out = m if ran_out < 0 else ran_out
    return ran_out


def entropy_decode_numpy(hdr: Header) -> tuple[list[np.ndarray], int]:
    """The quantized coefficients of each component after every scan,
    `(rows, cols, 64)` int16 in natural order, on the grid of `geometry`,
    and the MCU of the last scan in which its data ran out (-1: none)."""
    from yolopoint_tpu_torch.data import jpeg_arith

    _, _, blocks, _ = geometry(hdr)
    coef = [[0] * (r * c * 64) for r, c in blocks]
    decode = jpeg_arith.decode_scan if hdr.arithmetic else decode_scan_numpy
    ran_out = [decode(hdr, scan, coef) for scan in hdr.scans]
    return ([np.asarray(c, np.int16).reshape(r, cc, 64) for c, (r, cc) in zip(coef, blocks)],
            ran_out[-1])


FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
       "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
       "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _wrap16(v: np.ndarray) -> np.ndarray:
    """`v` as a 16-bit lane holds it: wrapped, as `paddw` / `psubw` / `pmullw`
    / `psllw` leave it."""
    return ((v + 32768) & 0xFFFF) - 32768


def _idct_1d(x: list[np.ndarray]) -> list[np.ndarray]:
    """One pass of `jpeg_idct_islow` before its descale, on int64 arrays of
    16-bit values, as libjpeg-turbo's SIMD version computes it: the sums it
    forms in 16-bit lanes wrap (`x0 + x4`, `x0 - x4`, and the odd part's
    `z3 = x7 + x3`, `z4 = x5 + x1`); every product and the rest of the sums
    are 32-bit, which these inputs never pass. Outputs 0..7 scaled by
    2**CONST_BITS."""
    z1 = (x[2] + x[6]) * FIX["0_541196100"]
    tmp2 = z1 - x[6] * FIX["1_847759065"]
    tmp3 = z1 + x[2] * FIX["0_765366865"]
    tmp0 = _wrap16(x[0] + x[4]) << 13
    tmp1 = _wrap16(x[0] - x[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * FIX["1_175875602"]
    t0 = t0 * FIX["0_298631336"]
    t1 = t1 * FIX["2_053119869"]
    t2 = t2 * FIX["3_072711026"]
    t3 = t3 * FIX["1_501321110"]
    z1 = z1 * -FIX["0_899976223"]
    z2 = z2 * -FIX["2_562915447"]
    z3 = z3 * -FIX["1_961570560"] + z5
    z4 = z4 * -FIX["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3]


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """uint8 `(rows * 8, cols * 8)` samples of `(rows, cols, 64)` quantized
    coefficients: dequantized, `jpeg_idct_islow`, as libjpeg-turbo's SIMD
    version (the one `cv2` runs) computes it: the dequantized coefficients
    16-bit (a product wraps), the 16-bit sums of each pass wrapped
    (`_idct_1d`), the first pass's outputs saturated to 16 bits, the
    samples saturated to 0-255 (the C code's range-limit table wraps values
    past +-512 instead); a block whose rows 1-7 are all zero skips the
    first pass, its first row shifted left by `PASS1_BITS` in 16 bits (a
    shift that wraps). For valid data nothing overflows and the forms
    agree; for the garbage blocks of a cut file, or low qualities of noisy
    images, only this form gives `cv2`'s pixels."""
    r, c = coef.shape[:2]
    q = quant.astype(np.int16).astype(np.int64)
    blk = _wrap16(coef.reshape(-1, 8, 8).astype(np.int64) * q.reshape(8, 8))
    cols = _idct_1d([blk[:, k, :] for k in range(8)])  # pass 1: along each column
    ws = np.stack([(v + (1 << 10)) >> 11 for v in cols], axis=1)  # CONST_BITS - PASS1_BITS
    ws = np.clip(ws, -32768, 32767)
    dc_only = ~coef.reshape(-1, 64)[:, 8:].any(axis=1)
    ws[dc_only] = _wrap16(blk[dc_only, :1, :] << 2)  # << PASS1_BITS, each column
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2: along each row
    out = np.stack([(v + (1 << 17)) >> 18 for v in rows], axis=2)  # + PASS1_BITS + 3
    out = np.clip(out + 128, 0, 255).astype(np.uint8)
    return out.reshape(r, c, 8, 8).transpose(0, 2, 1, 3).reshape(r * 8, c * 8)


def _edge(p: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """`p` shifted by one along `axis` towards higher and lower indices,
    the edges replicated: `(previous, next)`."""
    first = np.take(p, [0], axis=axis)
    last = np.take(p, [p.shape[axis] - 1], axis=axis)
    n = p.shape[axis]
    return (np.concatenate([first, np.take(p, range(n - 1), axis=axis)], axis=axis),
            np.concatenate([np.take(p, range(1, n), axis=axis), last], axis=axis))


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, hr: int, vr: int, fancy: bool = True) -> np.ndarray:
    """A downsampled plane `(dh, dw)` (its real rows and columns only)
    brought to `(dh * vr, dw * hr)` as `jdsample.c` chooses: fancy `h2v1`
    and `h2v2` where `dw > 2`, fancy `h1v2`, else replication; replication
    only without `fancy` (a lossless file: libjpeg-turbo upsamples fancily
    only where a DCT block is more than one sample)."""
    p = plane.astype(np.int32)
    dw = p.shape[1]
    if (hr, vr) == (1, 1):
        return plane
    if not fancy:
        return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)
    if (hr, vr) == (2, 1) and dw > 2:
        left, right = _edge(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    if (hr, vr) == (1, 2):
        up, down = _edge(p, 0)
        return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0).astype(np.uint8)
    if (hr, vr) == (2, 2) and dw > 2:
        up, down = _edge(p, 0)
        sums = _interleave(3 * p + up, 3 * p + down, 0)  # column sums of each output row
        left, right = _edge(sums, 1)
        return _interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1) \
            .astype(np.uint8)
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


def _ycc_tables() -> tuple[np.ndarray, ...]:
    """`build_ycc_rgb_table`: Cr->R, Cb->B, Cr->G and Cb->G (the last two
    scaled by 2**16, Cb->G with the rounding half added)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


CR_R, CB_B, CR_G, CB_G = _ycc_tables()


def _ycc_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> list[np.ndarray]:
    """`ycc_rgb_convert`'s B, G, R (int64, before the range limit)."""
    return [y + CB_B[cb], y + ((CB_G[cb] + CR_G[cr]) >> 16), y + CR_R[cr]]


def cmyk_bgr(planes: list[np.ndarray], color: int) -> list[np.ndarray]:
    """The B, G, R int64 planes OpenCV makes of a four-component file:
    libjpeg-turbo's CMYK output (`null_convert` of CMYK; `ycck_cmyk_convert`
    of YCCK: `255 - ` each range-limited YCbCr-to-RGB value, K as it is),
    then `icvCvt_CMYK2BGR_8u_C4C3R`'s `k - ((255 - x) * k >> 8)` of C, M
    and Y."""
    p = [q.astype(np.int64) for q in planes]
    k = p[3]
    if color == YCCK:
        b, g, r = (np.clip(v, 0, 255) for v in _ycc_bgr(*p[:3]))
        cmy = [255 - r, 255 - g, 255 - b]
    else:
        cmy = p[:3]
    c, m, y = (k - (((255 - x) * k) >> 8) for x in cmy)
    return [y, m, c]


def color_convert(planes: list[np.ndarray], color: int) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR of the full-size component planes (`RAW`: the
    planes as they are, one channel each)."""
    if color == RAW:
        return np.stack(planes, axis=2)
    if color == GREY:
        return np.repeat(planes[0][..., None], 3, axis=2)
    if color == RGB:
        return np.stack(planes[::-1], axis=2)
    if color in (CMYK, YCCK):
        return np.stack(cmyk_bgr(planes, color), axis=2).astype(np.uint8)
    bgr = _ycc_bgr(*(p.astype(np.int64) for p in planes))
    return np.clip(np.stack(bgr, axis=2), 0, 255).astype(np.uint8)


# rgb_gray_convert's weights (`build_rgb_y_table`, SCALEBITS 16; the
# rounding half rides on blue)
RGB_Y = (19595, 38470, 7471)
# OpenCV's grey of a CMYK row (`icvCvt_CMYK2Gray_8u_C4C1R`): B, G, R weights
# of 14 bits, rounded
CV_GREY = (1868, 9617, 4899)


def needed_components(hdr: Header, grey: bool) -> range:
    """The components a read needs: the Y (or grey) one alone for a grey
    read of a YCbCr or grey file, else all."""
    return range(1) if grey and hdr.color in (YCC, GREY) else range(len(hdr.sampling))


def reconstruct(hdr: Header, coefs: list[np.ndarray], grey: bool = False) -> np.ndarray:
    """The image of the coefficients after the last scan: IDCT of each
    needed component's real blocks, then `compose`."""
    _, _, _, sizes = geometry(hdr)
    planes = {}
    for ci in needed_components(hdr, grey):
        dh, dw = sizes[ci]
        planes[ci] = idct_islow(coefs[ci][:-(-dh // 8), :-(-dw // 8)], hdr.quant[ci])[:dh, :dw]
    return compose(hdr, planes, grey)


def compose(hdr: Header, planes: dict, grey: bool = False) -> np.ndarray:
    """The image of the components' downsampled planes (those
    `needed_components` names): upsampling (`upsample`, fancy unless the
    file is lossless), colour conversion. uint8 `(H, W, 3)` BGR, or `(H, W)`
    grey as libjpeg's `JCS_GRAYSCALE` output gives it (the Y component
    alone of a YCbCr or grey file, `rgb_gray_convert` of an RGB one) or
    OpenCV's grey of a CMYK one."""
    hmax = max(h for h, _ in hdr.sampling)
    vmax = max(v for _, v in hdr.sampling)
    planes = [upsample(planes[ci], hmax // hdr.sampling[ci][0], vmax // hdr.sampling[ci][1],
                       not hdr.lossless)[:hdr.height, :hdr.width]
              for ci in needed_components(hdr, grey)]
    if not grey:
        return color_convert(planes, hdr.color)
    if hdr.color in (YCC, GREY):
        return planes[0]
    if hdr.color in (CMYK, YCCK):  # icvCvt_CMYK2Gray_8u_C4C1R: OpenCV's grey of its BGR
        b, g, r = cmyk_bgr(planes, hdr.color)
        return ((CV_GREY[0] * b + CV_GREY[1] * g + CV_GREY[2] * r + (1 << 13)) >> 14) \
            .astype(np.uint8)
    r, g, b = (p.astype(np.int64) for p in planes)
    return ((RGB_Y[0] * r + RGB_Y[1] * g + RGB_Y[2] * b + (1 << 15)) >> 16).astype(np.uint8)


def decode_numpy(hdr: Header, grey: bool = False) -> np.ndarray:
    """`reconstruct` of a parsed file (integral sampling ratios) after its
    scans' entropy decode (and, where libjpeg-turbo smooths, `smooth_blocks`),
    or `compose` of a lossless file's planes, before its EXIF orientation."""
    if hdr.lossless:
        from yolopoint_tpu_torch.data import jpeg_lossless

        return compose(hdr, dict(enumerate(jpeg_lossless.decode_planes(hdr))), grey)
    coefs, ran_out = entropy_decode_numpy(hdr)
    if block_smoothing(hdr):
        coefs = smooth_blocks(hdr, coefs, ran_out)
    return reconstruct(hdr, coefs, grey)


def compiled_inputs(hdr: Header) -> tuple[np.ndarray, ...]:
    """`yp_jpeg_decode`'s arrays of a parsed file: the frame (width,
    height, components, colour, progressive, arithmetic, lossless,
    precision, then (h, v) of each component), the scan table (`SCAN_FIELDS` ints a scan: data offset and
    length, component count, four frame indices, Ss, Se, Ah, Al, restart
    interval, then for each of four scan components its DC and AC table
    numbers and conditioning L, U, Kx), the latched quantization tables, the
    Huffman tables (a scan, a scan component: DC then AC, 16 code counts and
    256 symbols each; zero counts where the scan reads none) and the scans'
    data end to end."""
    frame = np.array([hdr.width, hdr.height, len(hdr.sampling), hdr.color, hdr.progressive,
                      hdr.arithmetic, hdr.lossless, hdr.precision,
                      *[x for hv in hdr.sampling for x in hv]], np.int32)
    table = np.zeros((len(hdr.scans), SCAN_FIELDS), np.int32)
    huff = np.zeros((len(hdr.scans), MAX_COMPS_IN_SCAN, 2, 16 + 256), np.uint8)
    offset = 0
    for i, scan in enumerate(hdr.scans):
        comps = scan.comps + [0] * (MAX_COMPS_IN_SCAN - len(scan.comps))
        arith = [x for t, c in zip(scan.tables, scan.conditioning) for x in (*t, *c)]
        table[i, :12 + len(arith)] = [offset, len(scan.data), len(scan.comps), *comps, scan.ss,
                                      scan.se, scan.ah, scan.al, scan.restart, *arith]
        offset += len(scan.data)
        for s, tables in enumerate(scan.huffman):
            for t, found in enumerate(tables):
                if found:
                    bits, vals = found
                    huff[i, s, t, :16] = bits
                    huff[i, s, t, 16:16 + len(vals)] = np.frombuffer(vals, np.uint8)
    data = np.frombuffer(b"".join(s.data for s in hdr.scans), np.uint8)
    return frame, table, np.ascontiguousarray(hdr.quant.astype(np.int32)), huff, data


def decode_compiled(hdr: Header, grey: bool = False) -> np.ndarray:
    """`decode_numpy` in compiled host code (`yp_jpeg_decode`)."""
    from yolopoint_tpu_torch.ops import _build

    frame, table, quant, huff, data = compiled_inputs(hdr)
    channels = len(hdr.sampling) if hdr.color == RAW else 3
    out = np.empty((hdr.height, hdr.width) if grey else (hdr.height, hdr.width, channels),
                   np.uint8)
    status = _build.library().yp_jpeg_decode(
        data.ctypes.data_as(ctypes.c_void_p), frame.ctypes.data_as(ctypes.c_void_p),
        table.ctypes.data_as(ctypes.c_void_p), len(hdr.scans),
        quant.ctypes.data_as(ctypes.c_void_p), huff.ctypes.data_as(ctypes.c_void_p),
        int(grey), out.ctypes.data_as(ctypes.c_void_p))
    if status == 1:  # only a caller's fault: the parse checked the file
        raise RuntimeError("yp_jpeg_decode: bad parameters")
    if status:
        raise Unreadable(f"corrupt JPEG data (status {status})")
    return out


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation applied as OpenCV's `ExifTransform`."""
    if orientation >= 5:  # transposed first
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flip) if flip else img)


def coef_bits(hdr: Header) -> tuple[np.ndarray, np.ndarray]:
    """`(bits, prev)`, `(components, 10)`: the successive-approximation bit
    of the DC and the first nine AC coefficients (zigzag order) after the
    last scan begun (-1: never sent, 0: complete), and as libjpeg-turbo's
    `smoothing_ok` latches the bits before it (`start_pass_phuff_decoder`
    keeps them for each scan's components over the band `min(Ss, 1) ..
    max(Se, 9)`, 0 at the first scan; all -1 while one scan has begun)."""
    nc = len(hdr.sampling)
    bits, prev = np.full((nc, 64), -1), np.full((nc, 10), -1)
    for i, scan in enumerate(hdr.scans):
        for c in scan.comps:
            lo, hi = min(scan.ss, 1), min(max(scan.se, 9), 9)
            prev[c, lo:hi + 1] = bits[c, lo:hi + 1] if i else 0
            bits[c, scan.ss:scan.se + 1] = scan.al
    if len(hdr.scans) == 1:
        prev[:] = -1
    return bits[:, :10], prev


def block_smoothing(hdr: Header) -> bool:
    """Whether libjpeg-turbo smooths the blocks of this file
    (`smoothing_ok`): a progressive file, every component's quantization
    table latched with the DC and first nine AC entries nonzero and its DC
    begun, and some component's first nine AC coefficients (zigzag 1-9) not
    complete after the last scan begun (`coef_bits` other than 0). Only
    then does the output differ from the plain reconstruction."""
    if not hdr.progressive:
        return False
    bits, _ = coef_bits(hdr)
    scanned = {c for scan in hdr.scans for c in scan.comps}
    if len(scanned) < len(hdr.sampling) or (hdr.quant[:, list(SMOOTHED)] == 0).any():
        return False
    return bool((bits[:, 0] >= 0).all() and (bits[:, 1:10] != 0).any())


def last_good_row(hdr: Header, ran_out: int) -> int:
    """The last iMCU row (a component's `v` block rows) of the last scan
    that its data reached: the row of the MCU in which it ran out (that row
    takes the latched bits of the last scan, the rows below it the bits
    before it); the last row when it did not run out."""
    mx, my, _, sizes = geometry(hdr)
    scan = hdr.scans[-1]
    if ran_out < 0:
        return my - 1
    if len(scan.comps) > 1:
        return ran_out // mx
    c = scan.comps[0]
    return ran_out // -(-sizes[c][1] // 8) // hdr.sampling[c][1]


def _smooth_pred(num: np.ndarray, q: int, al: np.ndarray) -> np.ndarray:
    """`decompress_smooth_data`'s estimate of a coefficient from `num` (a
    DC sum times Q00) and the coefficient's table entry `q`: rounded, its
    magnitude kept under `1 << Al` where `Al > 0`."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    cap = (1 << np.maximum(al, 0)) - 1
    mag = np.where((al > 0) & (mag > cap), cap, mag)
    return np.where(num >= 0, mag, -mag)


def _w(*rows) -> np.ndarray:
    return np.array(rows, np.int64)


_Z = (0, 0, 0, 0, 0)
# libjpeg-turbo's `decompress_smooth_data`: each estimated coefficient as
# (zigzag index, natural position, the weights of the DC values of the 5x5
# blocks around a block (rows r - 2 .. r + 2, columns c - 2 .. c + 2) where
# some AC coefficient is known (None: no estimate then), the weights where
# only DC is known)
SMOOTH_TERMS = (
    (1, 1, _w(_Z, _Z, (-7, 50, 0, -50, 7), _Z, _Z),
     _w((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3), (-3, 13, 0, -13, 3),
        (-1, -1, 0, 1, 1))),
    (2, 8, _w((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), _Z, (0, 0, -50, 0, 0), (0, 0, 7, 0, 0)),
     _w((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), _Z, (1, -13, -38, -13, 1),
        (1, 3, 3, 3, 1))),
    (3, 16, _w((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0), (0, 0, 13, 0, 0),
               (0, 0, -1, 0, 0)),
     _w((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0), (0, 2, 7, 2, 0), (0, 0, 1, 0, 0))),
    (4, 9, _w((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), _Z, (1, -10, 0, 10, -1), (0, 1, 0, -1, 0)),
     _w((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), _Z, (0, -9, 0, 9, 0), (1, 0, 0, 0, -1))),
    (5, 2, _w(_Z, _Z, (-1, 13, -24, 13, -1), _Z, _Z),
     _w(_Z, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0), _Z)),
    (6, 3, None, _w(_Z, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0), _Z)),
    (7, 10, None, _w(_Z, (0, 1, -3, 1, 0), _Z, (0, -1, 3, -1, 0), _Z)),
    (8, 17, None, _w(_Z, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0), _Z)),
    (9, 24, None, _w(_Z, (0, 1, 2, 1, 0), _Z, (0, -1, -2, -1, 0), _Z)),
)
# the DC's own estimate where only DC is known (weights sum to 256)
SMOOTH_DC = _w((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6), (-8, 42, 152, 42, -8),
               (-6, 6, 42, 6, -6), (-2, -6, -8, -6, -2))


def smooth_blocks(hdr: Header, coefs: list[np.ndarray], ran_out: int) -> list[np.ndarray]:
    """libjpeg-turbo's block smoothing (`decompress_smooth_data`) of the
    coefficients of a progressive file whose first AC coefficients are not
    all known (`block_smoothing`): each unknown (zero, not complete)
    coefficient of zigzag 1-5 estimated from the DC values of the 5x5
    blocks around it, and where only DC is known also zigzag 6-9 and the DC
    itself. The neighbours are clamped at the image's left and right;
    above and below they follow libjpeg's `image_block_row` tests (dummy
    rows below a full iMCU row count). The rows past the one where the last
    scan's data ran out take the bits latched before that scan."""
    mx, my, _, sizes = geometry(hdr)
    bits, prev = coef_bits(hdr)
    good = last_good_row(hdr, ran_out)
    out = list(coefs)
    for ci, (_, v) in enumerate(hdr.sampling):
        R, C = (-(-n // 8) for n in sizes[ci])
        co = coefs[ci].astype(np.int64)
        r = np.arange(R)
        im, br, last = r // v, r % v, my - 1
        # libjpeg's row test: the iMCU row's own count of block rows (fewer
        # in a partial last row) times the iMCU rows, so that below a
        # full row the dummy rows count, and a partial last row reads
        # otherwise (its second row above only from its third iMCU row on)
        rows_here = np.where(im < last, v, R % v or v)
        at, count = im * rows_here + br, rows_here * my
        up1 = np.where(at > 0, r - 1, r)
        up2 = np.where(at > 1, r - 2, up1)
        dn1 = np.where(at < count - 1, r + 1, r)
        dn2 = np.where(at < count - 2, r + 2, dn1)
        cols = [np.clip(np.arange(C) + j - 2, 0, C - 1) for j in range(5)]
        dc = co[..., 0]
        D = np.stack([np.stack([dc[rows][:, cols[j]] for j in range(5)])
                      for rows in (up2, up1, r, dn1, dn2)])  # (5, 5, R, C)
        cb = np.where((im > good)[:, None], prev[ci][None, :], bits[ci][None, :])
        dc_only = (cb[:, 1:10] == -1).all(1)[:, None]
        blk = co[:R, :C].copy()
        q = hdr.quant[ci].astype(np.int64)
        for k, pos, w_known, w_dc in SMOOTH_TERMS:
            total = np.einsum("ij,ijrc->rc", w_dc, D)
            if w_known is not None:
                total = np.where(dc_only, total, np.einsum("ij,ijrc->rc", w_known, D))
            al = cb[:, k][:, None]
            use = (al != 0) & (co[:R, :C, pos] == 0) & (dc_only | (w_known is not None))
            blk[..., pos] = np.where(use, _smooth_pred(q[0] * total, int(q[pos]), al),
                                     blk[..., pos])
        own = _smooth_pred(q[0] * np.einsum("ij,ijrc->rc", SMOOTH_DC, D), int(q[0]),
                           np.zeros((R, 1), np.int64))
        blk[..., 0] = np.where(dc_only, own, blk[..., 0])
        new = co.copy()
        new[:R, :C] = blk
        out[ci] = (((new + 32768) & 0xFFFF) - 32768).astype(np.int16)
    return out


def lossless_refused(hdr: Header, grey: bool) -> bool:
    """Whether libjpeg-turbo refuses this read of a lossless file (so
    `cv2.imread` returns None): it converts no colour in lossless mode, so
    a one-component file reads in grey only, a three-component one in
    colour only and only as RGB (no JFIF segment, an Adobe transform of 0 or
    none), a four-component one as CMYK only (OpenCV converts CMYK itself,
    in both reads)."""
    n = len(hdr.sampling)
    if n == 1:
        return not grey
    if n == 3:
        return grey or hdr.color != RGB
    return hdr.color != CMYK


def decode_jpeg(data: bytes, name: str = "<jpeg>", device: str | torch.device = "cuda",
                grey: bool = False) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of JPEG bytes, as `cv2.imread(...,
    IMREAD_COLOR)` gives it, or with `grey` the `(H, W)` image of
    `IMREAD_GRAYSCALE`. `device` cpu decodes in numpy; any other device in
    the compiled host code (raising if it does not build)."""
    hdr = parse_header(data, name)
    if hdr.lossless and lossless_refused(hdr, grey):
        raise Unreadable(f"{name}: libjpeg-turbo converts no colour of a lossless file "
                         f"({len(hdr.sampling)} components) to this read")
    hmax = max(h for h, _ in hdr.sampling)
    vmax = max(v for _, v in hdr.sampling)
    if any(hmax % h or vmax % v for h, v in hdr.sampling):
        raise Unreadable(f"{name}: fractional sampling ratios are not decoded")
    decode = decode_numpy if torch.device(device).type == "cpu" else decode_compiled
    try:
        img = decode(hdr, grey)
    except Unreadable as e:
        raise Unreadable(f"{name}: {e}") from e
    return orient(img, hdr.orientation)


def read_jpeg(path: str | Path, device: str | torch.device = "cuda",
              grey: bool = False) -> np.ndarray:
    """`decode_jpeg` of a file. Where the stream is malformed (`cv2.imread`
    returns None), raises `FileNotFoundError`, as the JAX package's
    `_imread` does."""
    try:
        return decode_jpeg(Path(path).read_bytes(), str(path), device, grey)
    except Unreadable as e:
        raise FileNotFoundError(str(e)) from e


# ---------------------------------------------------------------------------
# Encoding: the bytes of `cv2.imencode(".jpg", img)` at OpenCV's defaults.
#
# OpenCV hands libjpeg-turbo a BGR (or grey) image with quality 95, 4:2:0
# chroma, no Huffman optimisation, no restarts and the islow FDCT. The C code
# of libjpeg-turbo is the spec, as for the decoder: `jccolor.c`'s
# fixed-point RGB -> YCbCr, `jcsample.c`'s `h2v2_downsample` (the bias
# alternating 1, 2 along a row) over rows and columns replicated past the
# image's edge, `jfdctint.c`'s `jpeg_fdct_islow`, `jcdctmgr.c`'s quantization
# by reciprocal (`compute_reciprocal`, 16-bit `DCTELEM`), `jccoefct.c`'s
# dummy blocks where a component's blocks do not fill the last MCU (zero AC,
# the DC of the block before), and `jchuff.c` with the Annex K tables.

ENCODE_QUALITY = 95
# the quantization tables of the standard's Annex K.1, natural order
STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     *[99] * 32]], np.int64)


def quality_tables() -> np.ndarray:
    """`jpeg_set_quality(ENCODE_QUALITY)`'s `(2, 64)` tables (natural
    order): Annex K.1 scaled by `200 - 2 q` percent (q >= 50), rounded, kept
    within 1..255 (`force_baseline`)."""
    return np.clip((STD_QUANT * (200 - 2 * ENCODE_QUALITY) + 50) // 100, 1, 255)


def _rgb_ycc(img: np.ndarray) -> list[np.ndarray]:
    """`rgb_ycc_convert` of a BGR image: int64 Y, Cb, Cr planes."""
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return [y, cb, cr]


def _fdct_1d(x: list[np.ndarray], shift: int, even_shift) -> list[np.ndarray]:
    """One pass of `jpeg_fdct_islow` on int64 arrays: the even outputs 0, 4
    shifted by `even_shift` (a left shift in pass 1, a descale in pass 2),
    the others descaled by `shift`."""
    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    out[0], out[4] = even_shift(tmp10 + tmp11), even_shift(tmp10 - tmp11)
    z1 = (tmp12 + tmp13) * FIX["0_541196100"]
    out[2] = descale(z1 + tmp13 * FIX["0_765366865"], shift)
    out[6] = descale(z1 - tmp12 * FIX["1_847759065"], shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX["1_175875602"]
    tmp4 = tmp4 * FIX["0_298631336"]
    tmp5 = tmp5 * FIX["2_053119869"]
    tmp6 = tmp6 * FIX["3_072711026"]
    tmp7 = tmp7 * FIX["1_501321110"]
    z1 = z1 * -FIX["0_899976223"]
    z2 = z2 * -FIX["2_562915447"]
    z3 = z3 * -FIX["1_961570560"] + z5
    z4 = z4 * -FIX["0_390180644"] + z5
    out[7] = descale(tmp4 + z1 + z3, shift)
    out[5] = descale(tmp5 + z2 + z4, shift)
    out[3] = descale(tmp6 + z2 + z3, shift)
    out[1] = descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """`jpeg_fdct_islow` of `(N, 8, 8)` level-shifted samples (int64): the
    coefficients scaled up by 8, natural order."""
    rows = _fdct_1d([blocks[:, :, k] for k in range(8)], 11, lambda v: v << 2)
    ws = np.stack(rows, axis=2)
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], 15, lambda v: (v + 2) >> 2)
    return np.stack(cols, axis=1)


def _reciprocal(divisor: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`compute_reciprocal` with a 16-bit `DCTELEM`: `(recip, corr, shift)`
    such that `|x|` quantizes to `((|x| + corr) * recip) >> (16 + shift)`."""
    recips, corrs, shifts = [], [], []
    for d in divisor.tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recips.append(fq)
        corrs.append(c)
        shifts.append(r - 16)
    return (np.asarray(recips, np.int64), np.asarray(corrs, np.int64),
            np.asarray(shifts, np.int64))


def quantize(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """`jcdctmgr.c`'s `quantize` of `(N, 64)` FDCT outputs (natural order)
    by a `(64,)` table, through the reciprocal of each divisor `8 q`."""
    recip, corr, shift = _reciprocal(quant.reshape(64) * 8)
    mag = ((np.abs(coef) + corr) * recip) >> (16 + shift)
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """`(rows, cols, 64)` natural-order 8x8 blocks of the top-left of a plane."""
    p = plane[:rows * 8, :cols * 8]
    return p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(rows, cols, 64)


def _coded(plane: np.ndarray, rows: int, cols: int, quant: np.ndarray) -> np.ndarray:
    """Quantized `(rows, cols, 64)` coefficients of a padded plane."""
    blk = _blocks(plane, rows, cols).reshape(-1, 8, 8) - 128
    return quantize(fdct_islow(blk).reshape(-1, 64), quant).reshape(rows, cols, 64)


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edge replication out to `rows x cols`."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def encode_blocks(img: np.ndarray) -> list[np.ndarray]:
    """The quantized coefficients of each component as the scan codes them:
    `(block rows, block cols, 64)` natural order, dummy blocks included (the
    MCU grid of 16x16 luminance and 8x8 chroma for a BGR image; the 8x8
    block grid for a grey one)."""
    H, W = img.shape[:2]
    quant = quality_tables()
    if img.ndim == 2:
        hy, wy = -(-H // 8), -(-W // 8)
        return [_coded(_pad(img.astype(np.int64), hy * 8, wy * 8), hy, wy, quant[0])]
    y, cb, cr = _rgb_ycc(img)
    my, mx = -(-H // 16), -(-W // 16)
    hy, wy = -(-H // 8), -(-W // 8)
    luma = np.zeros((2 * my, 2 * mx, 64), np.int64)
    luma[:hy, :wy] = _coded(_pad(y, hy * 8, wy * 8), hy, wy, quant[0])
    if wy % 2:  # a dummy column: the DC of the block to its left
        luma[:hy, wy, 0] = luma[:hy, wy - 1, 0]
    if hy % 2:  # a dummy row: each MCU's upper-right DC
        luma[hy, :, 0] = np.repeat(luma[hy - 1, 1::2, 0], 2)
    out = [luma]
    for c in (cb, cr):
        full = _pad(c, H + H % 2, mx * 16)
        s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
        bias = np.tile([1, 2], mx * 4)
        out.append(_coded(_pad((s + bias) >> 2, my * 8, mx * 8), my, mx, quant[1]))
    return out


def _code_table(bits, values) -> tuple[np.ndarray, np.ndarray]:
    """`(code, length)` of each of the 256 symbols of a canonical table."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            code_of[values[k]], len_of[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _nbits(v: np.ndarray) -> np.ndarray:
    """JPEG magnitude category: the bit length of `|v|`."""
    a = np.abs(v)
    n = np.zeros_like(a)
    while (a >> n).any():
        n += (a >> n) > 0
    return n


def entropy_encode_numpy(comps: list[np.ndarray]) -> bytes:
    """`jchuff.c`'s scan data of `encode_blocks`' output with the Annex K
    tables (component 0 on tables 0, the others on tables 1): the MCUs in
    raster order, the DC predictor per component, `FF` stuffed with `00`,
    the last byte filled with 1-bits."""
    if len(comps) == 1:
        per_mcu = [comps[0].reshape(-1, 1, 64)]
    else:
        r, c = comps[1].shape[:2]
        per_mcu = [comps[0].reshape(r, 2, c, 2, 64).transpose(0, 2, 1, 3, 4).reshape(r * c, 4, 64),
                   comps[1].reshape(-1, 1, 64), comps[2].reshape(-1, 1, 64)]
    table = np.concatenate([np.full(p.shape[1], min(i, 1)) for i, p in enumerate(per_mcu)])
    comp = np.concatenate([np.full(p.shape[1], i) for i, p in enumerate(per_mcu)])
    zz = np.concatenate(per_mcu, axis=1)[..., ZIGZAG]  # (MCUs, blocks, 64) zigzag
    n_mcu, nb = zz.shape[:2]
    coefs = zz.reshape(-1, 64)
    table = np.tile(table, n_mcu)
    comp = np.tile(comp, n_mcu)
    n = len(coefs)
    diff = coefs[:, 0].copy()
    for ci in range(len(per_mcu)):
        idx = np.nonzero(comp == ci)[0]
        diff[idx[1:]] -= coefs[idx[:-1], 0]
    codes = {key: _code_table(*STD_HUFFMAN[key]) for key in STD_HUFFMAN}
    keys, vals, lens = [], [], []

    def emit(key, cls, tbl, sym, extra, nextra):
        for t in (0, 1):
            sel = tbl == t
            code, length = codes[(cls, t)]
            keys.append(key[sel])
            vals.append((code[sym[sel]] << nextra[sel]) | extra[sel])
            lens.append(length[sym[sel]] + nextra[sel])

    def extra(v, s):  # negative values as v - 1 in s bits
        return np.where(v < 0, v + (1 << s) - 1, v)

    s = _nbits(diff)
    emit(np.arange(n) * 4096, 0, table, s, extra(diff, s), s)
    blk, kk = np.nonzero(coefs[:, 1:])
    k = kk + 1
    v = coefs[blk, k]
    prev = np.concatenate([[0], k[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = k - prev - 1
    s = _nbits(v)
    emit(blk * 4096 + k * 8 + 7, 1, table[blk], ((run % 16) << 4) | s, extra(v, s), s)
    zrl = np.repeat(np.arange(len(k)), run // 16)  # a run of 16 zeros each
    j = np.arange(len(zrl)) - np.repeat(np.cumsum(run // 16) - run // 16, run // 16)
    none = np.zeros(len(zrl), np.int64)
    emit(blk[zrl] * 4096 + k[zrl] * 8 + j, 1, table[blk[zrl]], none + 0xF0, none, none)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.nonzero(last < 63)[0]
    none = np.zeros(len(eob), np.int64)
    emit(eob * 4096 + 512, 1, table[eob], none, none, none)
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    vals, lens = vals[order], lens[order]
    fill = int(-lens.sum() % 8)
    vals, lens = np.append(vals, (1 << fill) - 1), np.append(lens, fill)
    starts = np.cumsum(lens) - lens
    item = np.repeat(np.arange(len(vals)), lens)
    bit = np.arange(int(lens.sum())) - starts[item]
    packed = np.packbits(((vals[item] >> (lens[item] - 1 - bit)) & 1).astype(np.uint8))
    return packed.tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def jpeg_headers(height: int, width: int, channels: int) -> bytes:
    """The markers libjpeg-turbo writes before the scan data: SOI, the JFIF
    APP0 (version 1.01, no density unit, 1:1), one DQT a table, SOF0, one
    DHT a table in the scan's order (DC then AC of each table), SOS."""
    quant = quality_tables()
    ntab = 1 if channels == 1 else 2
    out = bytearray(SOI)
    out += _segment(0xE0, b"JFIF\0\x01\x01\0" + struct.pack(">HH", 1, 1) + b"\0\0")
    for t in range(ntab):
        out += _segment(0xDB, bytes([t]) + quant[t][ZIGZAG].astype(np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, height, width, channels)
    for ci in range(channels):
        sof += bytes([ci + 1, 0x22 if channels == 3 and ci == 0 else 0x11, min(ci, 1)])
    out += _segment(0xC0, sof)
    for t in range(ntab):
        for cls in (0, 1):
            bits, values = STD_HUFFMAN[(cls, t)]
            out += _segment(0xC4, bytes([(cls << 4) | t, *bits]) + bytes(values))
    sos = bytes([channels])
    for ci in range(channels):
        sos += bytes([ci + 1, 0x11 * min(ci, 1)])
    out += _segment(0xDA, sos + b"\x00\x3f\x00")
    return bytes(out)


def _check_encode(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"encode_jpeg takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not 0 < img.shape[0] <= MAX_SIDE or not 0 < img.shape[1] <= MAX_SIDE:
        raise ValueError(f"encode_jpeg: bad size {img.shape[:2]}")
    return np.ascontiguousarray(img)


def encode_numpy(img: np.ndarray) -> bytes:
    """`encode_jpeg` in numpy."""
    img = _check_encode(img)
    channels = 1 if img.ndim == 2 else 3
    return (jpeg_headers(*img.shape[:2], channels) + entropy_encode_numpy(encode_blocks(img))
            + b"\xff\xd9")


def encode_compiled(img: np.ndarray) -> bytes:
    """`encode_numpy` in compiled host code (`yp_jpeg_encode`)."""
    from yolopoint_tpu_torch.ops import _build

    img = _check_encode(img)
    H, W = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    quant = np.ascontiguousarray(quality_tables().astype(np.int32))
    # at most ~1.7 kbit a block, doubled for the stuffing
    cap = (-(-H // 16) * -(-W // 16) * 6 + 4) * 512
    out = np.empty(cap, np.uint8)
    n = _build.library().yp_jpeg_encode(
        img.ctypes.data_as(ctypes.c_void_p), H, W, channels,
        quant.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise RuntimeError(f"yp_jpeg_encode failed ({n})")
    return jpeg_headers(H, W, channels) + out[:n].tobytes() + b"\xff\xd9"


def encode_jpeg(img: np.ndarray, device: str | torch.device = "cuda") -> bytes:
    """The bytes of `cv2.imencode(".jpg", img)[1]` (OpenCV's defaults) for a
    uint8 `(H, W, 3)` BGR or `(H, W)` grey image. `device` cpu encodes in
    numpy; any other device in the compiled host code (raising if it does
    not build)."""
    encode = encode_numpy if torch.device(device).type == "cpu" else encode_compiled
    return encode(img)


def write_jpeg(path: str | Path, img: np.ndarray, device: str | torch.device = "cuda") -> None:
    """`cv2.imwrite(path, img)` for a `.jpg` path: `encode_jpeg`'s bytes."""
    Path(path).write_bytes(encode_jpeg(img, device))
