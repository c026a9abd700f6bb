"""MPEG-4 Part 2 (Simple profile) decoding as FFmpeg decodes it.

`cv2.VideoCapture` reads `mp4v`, `XVID`, `DIVX`, `FMP4` and the other
MPEG-4 Part 2 streams with FFmpeg's decoder (`libavcodec/mpeg4videodec.c`,
`h263dec.c`, `mpegvideo_dec.c`); this module gives its frames, bit for bit:

* Headers: the visual object sequence, visual object, video object layer
  (`decode_vol_header`: rectangular shape, 4:2:0, the time increment's bit
  count `av_log2(resolution - 1) + 1`, H.263 or MPEG quantization with the
  VOL's matrices loaded in zigzag order with the last value repeated), user
  data (`decode_user_data`: the encoder's name), the group of VOPs, and the
  VOP header (`decode_vop_header`: coding type, time, `vop_coded`,
  `vop_rounding_type`, `intra_dc_vlc_thr` as `ff_mpeg4_dc_threshold`, the
  quantizer and `f_code`). A VOP with `vop_coded` 0 gives no frame.
* I-VOPs and intra macroblocks (`mpeg4_decode_mb`, `mpeg4_decode_block`):
  MCBPC with stuffing, `ac_pred_flag`, CBPY, DQUANT; the intra DC by its
  size VLC and `ff_mpeg4_pred_dc` (the gradient rule over the stored
  `level * dc_scale`, clipped to 0-2047; 1024 outside the video packet by
  `first_slice_line` and `resync_mb_x`); `ff_mpeg4_pred_ac` (the stored
  first row and column of quantized levels, rescaled by `ROUNDED_DIV` where
  the neighbour's quantizer differs); the zigzag or, with AC prediction,
  the alternate horizontal or vertical scan; the intra TCOEF VLC with its
  three escapes (`max_level` / `max_run` of the tables); then
  `dct_unquantize_h263_intra` (or, with MPEG quantization,
  `dct_unquantize_mpeg2_intra`) and the IDCT put.
* P-VOPs: the not-coded bit, MCBPC (inter, intra, 4MV, with DQUANT),
  CBPY inverted, motion vectors by `ff_h263_pred_motion` (the median of the
  left, top and top-right blocks, the first-line rules) and
  `ff_h263_decode_motion` (`f_code`, the modulo by `sign_extend`); the
  inter TCOEF VLC dequantized as it is read (`rl_vlc[qscale]`: `level * 2q
  +- ((q - 1) | 1)`, the third escape clipped to -2048..2047; MPEG
  quantization: `dct_unquantize_mpeg2_inter` at twice the quantizer, the
  last coefficient's low bit flipped where the levels' sum is even; intra
  `dct_unquantize_mpeg2_intra` likewise, `level * q * W >> 3`, found by
  sweeps against cv2). An intra DC level below 0 is an error to FFmpeg.
  Motion compensation as `mpeg_motion_internal` / `apply_8x8` /
  `chroma_4mv_motion`: half-pel bilinear averages, rounded or not by
  `vop_rounding_type` (x86's approximate 8-wide averages where rounding is
  off: `_halfpel`), over the reference with its edges replicated
  (`emulated_edge_mc`: coordinates clamped to the edge positions); H.263
  chroma vectors (`(mx >> 2)` with a half sample where `mx & 3`;
  `ff_h263_round_chroma` of the four vectors' sum in 4MV); intra
  macroblocks' vectors count as zero. Residuals added with the IDCT's add
  form.
* Video packets (`resync_marker_disable` 0): the resync marker after an
  MB's stuffing, the packet header (MB number, quantizer, header
  extension), `ff_mpeg4_clean_buffers` of the AC predictors.

The IDCT is `data/idct_ff.py`'s simple IDCT: FFmpeg takes it for every
stream but those whose user data names XviD. Refused with
`NotImplementedError` naming the tool: B-VOPs, S(GMC)-VOPs, quarter-pel,
interlace, data partitioning and reversible VLCs, shapes other than
rectangular, sprites, reduced resolution, NEWPRED, scalability, complexity
estimation, precisions other than 8 bits, chroma formats other than 4:2:0,
object types other than Simple, and XviD- or DivX-tagged streams (FFmpeg
switches to the XviD IDCT or to DivX workarounds for those). A stream
that FFmpeg would conceal errors in raises `NotImplementedError` too.

The decode of a VOP's macroblocks runs in compiled host code
(`yp_mpeg4_decode_vop`, `ops/csrc/host_video.cpp`) where `compiled`, and in
this module's Python and numpy otherwise (the CPU path and the compiled
code's oracle). Both give `yuv420p` planes of the coded (macroblock-aligned)
size; `Decoder.decode` crops them to the frame.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass

import numpy as np

from yolopoint_tpu_torch.data import idct_ff

# --- FFmpeg's tables (libavcodec/h263data.c, mpeg4data.h, mpegvideodata.c) --

# ff_h263_intra_MCBPC_code / _bits: index = mb type * 4 + cbpc; 8 stuffing
INTRA_MCBPC = ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9))
# ff_h263_inter_MCBPC_code / _bits: inter, intra, inter+Q, intra+Q, 4MV,
# stuffing (20), 4MV+Q (24-27); (0, 0) unused
INTER_MCBPC = (
    (1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7),
    (3, 3), (7, 7), (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9),
    (2, 3), (5, 7), (4, 7), (5, 8), (1, 9), (0, 0), (0, 0), (0, 0),
    (2, 11), (12, 13), (14, 13), (15, 13))
# ff_h263_cbpy_tab
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
# ff_mvtab
MVTAB = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9),
         (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10),
         (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11),
         (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12))
# ff_mpeg4_DCtab_lum / _chrom: index = dct_dc_size
DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
          (1, 9), (1, 10), (1, 11))
DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
            (1, 10), (1, 11), (1, 12))
# ff_inter_vlc (H.263 TCOEF, 102 codes + escape) and ff_inter_run; the
# levels count up within each (last, run) run of entries; last from 58
INTER_VLC = (
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12),
    (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7))
INTER_RUN = (0,) * 12 + (1,) * 6 + (2,) * 4 + (3,) * 3 + (4,) * 3 + (5,) * 3 + (6,) * 3 + \
    (7, 7, 8, 8, 9, 9, 10, 10) + tuple(range(11, 27)) + (0, 0, 0, 1, 1) + tuple(range(2, 41))
INTER_LAST = 58
# ff_mpeg4_intra_vlc and ff_mpeg4_intra_run; last from 67
INTRA_VLC = (
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11),
    (0x21, 11), (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7),
    (0x1c, 8), (0x20, 9), (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5),
    (0x15, 7), (0x1e, 9), (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10),
    (0x10, 6), (0x22, 9), (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9),
    (0x54, 12), (0x14, 7), (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11),
    (0x17, 8), (0x19, 9), (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8),
    (0x17, 9), (0x6, 10), (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10),
    (0xe, 6), (0x4, 10), (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12),
    (0x15, 8), (0x5b, 12), (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9),
    (0x12, 9), (0x11, 9), (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12),
    (0x5f, 12), (0x3, 7))
INTRA_RUN = (0,) * 27 + (1,) * 10 + (2,) * 5 + (3,) * 4 + (4,) * 3 + (5,) * 3 + (6,) * 3 + \
    (7,) * 3 + (8, 8, 9, 9, 10, 11, 12, 13, 14) + (0,) * 8 + (1,) * 3 + (2, 2, 3, 3, 4, 4, 5, 5,
                                                                     6, 6) + tuple(range(7, 21))
INTRA_LAST = 67
Y_DC_SCALE = (0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
              30, 31, 32, 34, 36, 38, 40, 42, 44, 46)
C_DC_SCALE = (0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
              17, 18, 18, 19, 20, 21, 22, 23, 24, 25)
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)  # ff_mpeg4_dc_threshold
QUANT_TAB = (-1, -2, 1, 2)
CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)  # h263_chroma_roundtab
DEFAULT_INTRA_MATRIX = (
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26, 28,
    30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32,
    35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45)
DEFAULT_INTER_MATRIX = (
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23, 24,
    25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27,
    28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33)
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
          44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
ALT_HORIZONTAL = (0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24, 25,
                  32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43,
                  36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60,
                  61, 62, 63)
ALT_VERTICAL = (0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,
                11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21, 29,
                36, 44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47,
                55, 63)

VOS, VISUAL_OBJECT, USER_DATA, GOV, VOP = 0xB0, 0xB5, 0xB2, 0xB3, 0xB6
I_VOP, P_VOP, B_VOP, S_VOP = 0, 1, 2, 3
ESCAPE = -1
# macroblock kinds of a decoded VOP (the compiled decoder's too)
MB_SKIP, MB_INTER, MB_INTER4V, MB_INTRA = 0, 1, 2, 3


def _levels(runs: tuple[int, ...], last: int) -> tuple[int, ...]:
    out, prev = [], None
    for i, r in enumerate(runs):
        key = (i >= last, r)
        out.append(out[-1] + 1 if key == prev else 1)
        prev = key
    return tuple(out)


INTER_LEVEL, INTRA_LEVEL = _levels(INTER_RUN, INTER_LAST), _levels(INTRA_RUN, INTRA_LAST)


def _max_tables(runs, levels, last):
    """`ff_rl_init`'s `max_level[last][run]` and `max_run[last][level]`."""
    max_level = [[0] * 64 for _ in range(2)]
    max_run = [[0] * 65 for _ in range(2)]
    for i, (r, lv) in enumerate(zip(runs, levels)):
        lst = int(i >= last)
        max_level[lst][r] = max(max_level[lst][r], lv)
        max_run[lst][lv] = max(max_run[lst][lv], r)
    return max_level, max_run


def _vlc(codes, symbols=None) -> tuple[list, int]:
    """Lookup table of a VLC: entry `peek(bits)` -> `(symbol, length)`;
    `(None, 0)` for no code."""
    bits = max(n for _, n in codes)
    table: list = [(None, 0)] * (1 << bits)
    for i, (code, n) in enumerate(codes):
        if n == 0:
            continue
        sym = i if symbols is None else symbols[i]
        base = code << (bits - n)
        for k in range(1 << (bits - n)):
            table[base + k] = (sym, n)
    return table, bits


def _tcoef(vlc, runs, levels, last):
    syms = [(int(i >= last), r, lv) for i, (r, lv) in enumerate(zip(runs, levels))] + [ESCAPE]
    return _vlc(vlc, syms)


TAB_INTRA_MCBPC = _vlc(INTRA_MCBPC)
TAB_INTER_MCBPC = _vlc(INTER_MCBPC)
TAB_CBPY = _vlc(CBPY)
TAB_MV = _vlc(MVTAB)
TAB_DC = (_vlc(DC_LUM), _vlc(DC_CHROM))
TAB_INTRA = _tcoef(INTRA_VLC, INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
TAB_INTER = _tcoef(INTER_VLC, INTER_RUN, INTER_LEVEL, INTER_LAST)
MAX_INTRA = _max_tables(INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
MAX_INTER = _max_tables(INTER_RUN, INTER_LEVEL, INTER_LAST)


class Corrupt(NotImplementedError):
    """A stream FFmpeg would decode with error concealment."""


class Bits:
    """MSB-first bit reader over a byte string (reads past the end as zero
    bits, as FFmpeg's padded reader does)."""

    __slots__ = ("buf", "pos", "size")

    def __init__(self, data: bytes, pos: int = 0):
        self.buf = bytes(data) + bytes(8)
        self.pos = pos
        self.size = len(data) * 8

    def peek(self, n: int) -> int:
        i = self.pos >> 3
        v = int.from_bytes(self.buf[i:i + 5], "big")
        return (v >> (40 - (self.pos & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self) -> int:
        v = (self.buf[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return v

    def vlc(self, tab) -> object:
        table, bits = tab
        sym, n = table[self.peek(bits)]
        if n == 0:
            raise Corrupt(f"invalid VLC code at bit {self.pos}")
        self.pos += n
        return sym

    def xbits(self, n: int) -> int:
        """`get_xbits`: n bits, negative where the first is 0."""
        v = self.read(n)
        return v if v >> (n - 1) else v - (1 << n) + 1

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def left(self) -> int:
        return self.size - self.pos


def start_codes(data: bytes) -> list[tuple[int, int]]:
    """`(code byte, offset of the byte after it)` of each `00 00 01 xx`."""
    out, i = [], data.find(b"\x00\x00\x01")
    while 0 <= i < len(data) - 3:
        out.append((data[i + 3], i + 4))
        i = data.find(b"\x00\x00\x01", i + 3)
    return out


def _log2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


@dataclass
class Vol:
    """What the decoder keeps of a video object layer header."""

    width: int = 0
    height: int = 0
    vo_type: int = 0
    time_increment_bits: int = 1
    mpeg_quant: bool = False
    intra_matrix: tuple = DEFAULT_INTRA_MATRIX   # natural order
    inter_matrix: tuple = DEFAULT_INTER_MATRIX
    resync_marker: bool = False
    quant_precision: int = 5


def _refuse(tool: str) -> None:
    raise NotImplementedError(f"MPEG-4 Part 2 {tool} is not decoded by the port")


def _marker(gb: Bits) -> None:
    gb.bit()  # check_marker only logs


def _load_matrix(gb: Bits, default: tuple) -> tuple:
    """A custom quantizer matrix in zigzag order, 0 ending it early, the
    last value repeated (`decode_vol_header`)."""
    m = list(default)
    i, last = 0, 0
    while i < 64:
        v = gb.read(8)
        if v == 0:
            break
        last = v
        m[ZIGZAG[i]] = v
        i += 1
    for k in range(i, 64):
        m[ZIGZAG[k]] = last
    return tuple(m)


def parse_vol(data: bytes) -> Vol:
    """`decode_vol_header` from the byte after a `00 00 01 2x` start code;
    every tool the port does not decode raises."""
    gb = Bits(data)
    vol = Vol()
    gb.bit()  # random_accessible_vol
    vol.vo_type = gb.read(8)
    verid = 1
    if gb.bit():  # is_object_layer_identifier
        verid = gb.read(4)
        gb.read(3)
    if vol.vo_type not in (0, 1):
        _refuse(f"object type {vol.vo_type} (not Simple)")
    if gb.read(4) == 15:  # aspect_ratio_info: extended PAR
        gb.read(16)
    if gb.bit():  # vol_control_parameters
        if gb.read(2) != 1:
            _refuse("chroma format other than 4:2:0")
        gb.bit()  # low_delay
        if gb.bit():  # vbv parameters
            gb.read(15), _marker(gb), gb.read(15), _marker(gb), gb.read(15), _marker(gb)
            gb.read(3), gb.read(11), _marker(gb), gb.read(15), _marker(gb)
    if gb.read(2) != 0:
        _refuse("non-rectangular shape")
    _marker(gb)
    resolution = gb.read(16)
    if resolution == 0:
        raise Corrupt("vop_time_increment_resolution 0")
    vol.time_increment_bits = max(_log2(resolution - 1) + 1, 1)
    _marker(gb)
    if gb.bit():  # fixed_vop_rate
        gb.read(vol.time_increment_bits)
    _marker(gb)
    vol.width = gb.read(13)
    _marker(gb)
    vol.height = gb.read(13)
    _marker(gb)
    if gb.bit():
        _refuse("interlace")
    gb.bit()  # obmc_disable
    if gb.read(1 if verid == 1 else 2):
        _refuse("sprite (GMC)")
    if gb.bit():
        _refuse("precision other than 8 bits (not_8_bit)")
    vol.mpeg_quant = bool(gb.bit())
    if vol.mpeg_quant:
        if gb.bit():
            vol.intra_matrix = _load_matrix(gb, DEFAULT_INTRA_MATRIX)
        if gb.bit():
            vol.inter_matrix = _load_matrix(gb, DEFAULT_INTER_MATRIX)
    if verid != 1 and gb.bit():
        _refuse("quarter-pel motion compensation")
    if not gb.bit():
        _refuse("complexity estimation header")
    vol.resync_marker = not gb.bit()
    if gb.bit():
        _refuse("data partitioning")
    if verid != 1:
        if gb.bit():
            _refuse("NEWPRED")
        if gb.bit():
            _refuse("reduced resolution VOP")
    if gb.bit():
        _refuse("scalability")
    if vol.width <= 0 or vol.height <= 0:
        raise Corrupt("VOL with a zero side")
    return vol


def encoder_tag(data: bytes) -> str | None:
    """The encoder `decode_user_data` recognises in a user data string:
    'xvid', 'divx', 'lavc' or None."""
    s = data.split(b"\x00\x00\x01")[0][:255].decode("latin-1")
    if re.match(r"DivX\d+(Build\d+|b\d+)", s):
        return "divx"
    if re.match(r"(FFmpe.*b\d+|FFmpeg v\d+\.\d+\.\d+ / libavcodec build: \d+|Lavc\d+\.\d+\.\d+)",
                s):
        return "lavc"
    if s.startswith("XviD") and re.match(r"XviD\d+", s):
        return "xvid"
    return None


@dataclass
class VopHeader:
    kind: int
    coded: bool
    rounding: int = 0
    dc_threshold: int = 99
    qscale: int = 1
    f_code: int = 1
    data_pos: int = 0  # bit offset of the first macroblock in the packet


def parse_vop(data: bytes, start: int, vol: Vol) -> VopHeader:
    """`decode_vop_header` from byte `start` (after `00 00 01 B6`)."""
    gb = Bits(data, start * 8)
    kind = gb.read(2)
    if kind == B_VOP:
        _refuse("B-VOP")
    if kind == S_VOP:
        _refuse("S(GMC)-VOP")
    while gb.bit():  # modulo_time_base
        pass
    _marker(gb)
    gb.read(vol.time_increment_bits)
    _marker(gb)
    if not gb.bit():
        return VopHeader(kind, False)
    hdr = VopHeader(kind, True)
    if kind == P_VOP:
        hdr.rounding = gb.bit()
    hdr.dc_threshold = DC_THRESHOLD[gb.read(3)]
    hdr.qscale = gb.read(vol.quant_precision)
    if hdr.qscale == 0:
        raise Corrupt("VOP quantizer 0")
    if kind != I_VOP:
        hdr.f_code = gb.read(3)
        if hdr.f_code == 0:
            raise Corrupt("f_code 0")
    hdr.data_pos = gb.pos
    return hdr


# --- the macroblock layer -----------------------------------------------------


class Frame:
    """One VOP's parse: per macroblock its kind, quantizer, four luma
    vectors (half-pel) and six dequantized blocks (natural order)."""

    def __init__(self, mbh: int, mbw: int):
        self.kind = np.zeros((mbh, mbw), np.int32)
        self.mv = np.zeros((mbh, mbw, 4, 2), np.int32)
        self.blocks = np.zeros((mbh, mbw, 6, 64), np.int16)


class _State:
    """The decoder's prediction buffers, laid out as FFmpeg's so that its
    writes at the edges (`ff_mpeg4_clean_buffers`, the `A = 0` of
    `ff_h263_pred_motion`) land where they land there: luma blocks in rows of
    `2 mbw + 1` (the extra column is also the next row's left neighbour),
    chroma in rows of `mbw + 1`, each with one padding row and column
    before."""

    def __init__(self, mbh: int, mbw: int):
        self.mbh, self.mbw = mbh, mbw
        self.s8, self.sm = 2 * mbw + 1, mbw + 1
        n8 = self.s8 * (2 * mbh + 4)
        nm = self.sm * (mbh + 4)
        self.dc = [[1024] * n8, [1024] * nm, [1024] * nm]
        self.ac = [[[0] * 16 for _ in range(n8)], [[0] * 16 for _ in range(nm)],
                   [[0] * 16 for _ in range(nm)]]
        self.mv = [[0, 0] for _ in range(n8)]
        self.qscale = np.zeros((mbh, mbw), np.int32)

    def luma(self, by: int, bx: int) -> int:
        return (by + 1) * self.s8 + bx + 1

    def chroma(self, y: int, x: int) -> int:
        return (y + 1) * self.sm + x + 1

    def index(self, n: int, mby: int, mbx: int) -> tuple[int, int, int]:
        """`(plane, index, wrap)` of block n of an MB."""
        if n < 4:
            return 0, self.luma(2 * mby + (n >> 1), 2 * mbx + (n & 1)), self.s8
        return n - 3, self.chroma(mby, mbx), self.sm

    def clean_ac(self, mby: int, mbx: int) -> None:
        """`ff_mpeg4_clean_buffers` at a video packet's first MB."""
        start = self.luma(2 * mby - 1, 2 * mbx - 1)
        for i in range(start, start + 2 * self.s8 + 1):
            self.ac[0][i] = [0] * 16
        start = self.chroma(mby - 1, mbx - 1)
        for p in (1, 2):
            for i in range(start, start + self.sm + 1):
                self.ac[p][i] = [0] * 16

    def clean_intra(self, mby: int, mbx: int) -> None:
        """`ff_clean_intra_table_entries` of a non-intra MB."""
        for n in range(6):
            p, i, _ = self.index(n, mby, mbx)
            self.dc[p][i] = 1024
            self.ac[p][i] = [0] * 16


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


class _Vop:
    """The macroblock parse of one VOP (Python: the CPU path and the
    compiled decoder's oracle)."""

    def __init__(self, data: bytes, hdr: VopHeader, vol: Vol):
        self.gb = Bits(data, hdr.data_pos)
        self.hdr, self.vol = hdr, vol
        self.mbw, self.mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
        self.mb_num = self.mbw * self.mbh
        self.st = _State(self.mbh, self.mbw)
        self.frame = Frame(self.mbh, self.mbw)
        self.set_qscale(hdr.qscale)

    def set_qscale(self, q: int) -> None:
        self.qscale = min(max(q, 1), 31)
        self.y_dc, self.c_dc = Y_DC_SCALE[self.qscale], C_DC_SCALE[self.qscale]

    # ---- slices
    def run(self) -> Frame:
        mbx = mby = 0
        while True:
            mbx, mby = self.slice(mbx, mby)
            if mby >= self.mbh:
                return self.frame
            mbx, mby = self.resync()
            self.st.clean_ac(mby, mbx)

    def slice(self, mbx: int, mby: int) -> tuple[int, int]:
        self.resync_x, self.resync_y, self.first_line = mbx, mby, True
        while mby < self.mbh:
            while mbx < self.mbw:
                if mbx == self.resync_x and mby == self.resync_y + 1:
                    self.first_line = False
                self.macroblock(mbx, mby)
                nxt = self.is_resync() if self.vol.resync_marker else 0
                if nxt and mby * self.mbw + mbx + 1 >= nxt:
                    mbx += 1
                    if mbx >= self.mbw:
                        mbx, mby = 0, mby + 1
                    return mbx, mby
                mbx += 1
            mbx, mby = 0, mby + 1
        return mbx, mby

    def prefix_length(self) -> int:
        return 16 if self.hdr.kind == I_VOP else self.hdr.f_code + 15

    def is_resync(self) -> int:
        """`mpeg4_is_resync`: the next packet's MB number where stuffing and
        a resync marker follow, else 0."""
        gb = self.gb
        pos = gb.pos
        v = gb.peek(16)
        kind = self.hdr.kind + 1  # AV_PICTURE_TYPE_I = 1, P = 2
        while v <= 0xFF:
            if v >> (8 - kind) != 1:
                break
            gb.pos += 8 + kind
            v = gb.peek(16)
        bits = gb.pos
        if bits + 8 >= gb.size:
            gb.pos = pos
            v = (v >> 8) | (0x7F >> (7 - (bits & 7)))
            return self.mb_num if v == 0x7F else 0
        prefix = (0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000)[bits & 7]
        result = 0
        if v == prefix:
            gb.pos += 1
            gb.align()
            n = 0
            while n < 32 and not gb.bit():
                n += 1
            mb_num = gb.read(_log2(self.mb_num - 1) + 1)
            if not mb_num or mb_num > self.mb_num or gb.pos + 6 > gb.size:
                mb_num = -1
            if n >= self.prefix_length():
                result = mb_num
        gb.pos = pos
        return result

    def resync(self) -> tuple[int, int]:
        """`ff_h263_resync` + `ff_mpeg4_decode_video_packet_header`."""
        gb = self.gb
        gb.bit()  # the stuffing's 0, then its 1s
        gb.align()
        n = 0
        while n < 32 and not gb.bit():
            n += 1
        if n != self.prefix_length():
            raise Corrupt("resync marker does not match f_code")
        mb_num = gb.read(_log2(self.mb_num - 1) + 1)
        if mb_num >= self.mb_num or mb_num == 0:
            raise Corrupt("illegal MB number in a video packet")
        q = gb.read(self.vol.quant_precision)
        if q:
            self.set_qscale(q)
        if gb.bit():  # header_extension_code
            while gb.bit():
                pass
            _marker(gb)
            gb.read(self.vol.time_increment_bits)
            _marker(gb)
            gb.read(2)
            gb.read(3)
            if self.hdr.kind != I_VOP:
                gb.read(3)
        return mb_num % self.mbw, mb_num // self.mbw

    # ---- macroblocks
    def macroblock(self, mbx: int, mby: int) -> None:
        gb, st, fr = self.gb, self.st, self.frame
        if self.hdr.kind == P_VOP:
            while True:
                if gb.bit():  # not coded
                    fr.kind[mby, mbx] = MB_SKIP
                    self.store_mv(mbx, mby, [(0, 0)] * 4)
                    st.clean_intra(mby, mbx)
                    st.qscale[mby, mbx] = self.qscale
                    return
                cbpc = gb.vlc(TAB_INTER_MCBPC)
                if cbpc != 20:
                    break
            dquant, intra = cbpc & 8, cbpc & 4
        else:
            while True:
                cbpc = gb.vlc(TAB_INTRA_MCBPC)
                if cbpc != 8:
                    break
            dquant, intra = cbpc & 4, 4
        if intra:
            ac_pred = gb.bit()
            cbp = (cbpc & 3) | (gb.vlc(TAB_CBPY) << 2)
            use_dc_vlc = self.qscale < self.hdr.dc_threshold
            if dquant:
                self.set_qscale(self.qscale + QUANT_TAB[gb.read(2)])
            st.qscale[mby, mbx] = self.qscale
            fr.kind[mby, mbx] = MB_INTRA
            for n in range(6):
                fr.blocks[mby, mbx, n] = self.intra_block(n, mbx, mby, cbp & (32 >> n),
                                                          ac_pred, use_dc_vlc)
            if self.hdr.kind == P_VOP:
                self.store_mv(mbx, mby, [(0, 0)] * 4)
            return
        cbp = (cbpc & 3) | ((gb.vlc(TAB_CBPY) ^ 0xF) << 2)
        if dquant:
            self.set_qscale(self.qscale + QUANT_TAB[gb.read(2)])
        st.qscale[mby, mbx] = self.qscale
        if cbpc & 16:
            fr.kind[mby, mbx] = MB_INTER4V
            mvs = []
            for n in range(4):
                px, py = self.pred_motion(mbx, mby, n)
                mv = (self.motion(px), self.motion(py))
                st.mv[st.luma(2 * mby + (n >> 1), 2 * mbx + (n & 1))] = list(mv)
                mvs.append(mv)
        else:
            fr.kind[mby, mbx] = MB_INTER
            px, py = self.pred_motion(mbx, mby, 0)
            mvs = [(self.motion(px), self.motion(py))] * 4
        self.store_mv(mbx, mby, mvs)
        fr.mv[mby, mbx] = mvs
        for n in range(6):
            if cbp & (32 >> n):
                fr.blocks[mby, mbx, n] = self.inter_block()
        st.clean_intra(mby, mbx)

    def store_mv(self, mbx: int, mby: int, mvs) -> None:
        st = self.st
        for n, mv in enumerate(mvs):
            st.mv[st.luma(2 * mby + (n >> 1), 2 * mbx + (n & 1))] = list(mv)

    def pred_motion(self, mbx: int, mby: int, block: int) -> tuple[int, int]:
        """`ff_h263_pred_motion` (h263_pred set, as for MPEG-4)."""
        st = self.st
        wrap = st.s8
        xy = st.luma(2 * mby + (block >> 1), 2 * mbx + (block & 1))
        off = (2, 1, 1, -1)[block]
        mv = st.mv
        a = mv[xy - 1]
        if self.first_line and block < 3:
            if block == 0:
                if mbx == self.resync_x:
                    return 0, 0
                if mbx + 1 == self.resync_x:
                    c = mv[xy + off - wrap]
                    if mbx == 0:
                        return c[0], c[1]
                    return _mid(a[0], 0, c[0]), _mid(a[1], 0, c[1])
                return a[0], a[1]
            if block == 1:
                if mbx + 1 == self.resync_x:
                    c = mv[xy + off - wrap]
                    return _mid(a[0], 0, c[0]), _mid(a[1], 0, c[1])
                return a[0], a[1]
            b, c = mv[xy - wrap], mv[xy + off - wrap]
            if mbx == self.resync_x:
                a[0] = a[1] = 0
            return _mid(a[0], b[0], c[0]), _mid(a[1], b[1], c[1])
        b, c = mv[xy - wrap], mv[xy + off - wrap]
        return _mid(a[0], b[0], c[0]), _mid(a[1], b[1], c[1])

    def motion(self, pred: int) -> int:
        """`ff_h263_decode_motion` (no long vectors)."""
        gb = self.gb
        code = gb.vlc(TAB_MV)
        if code == 0:
            return pred
        sign = gb.bit()
        shift = self.hdr.f_code - 1
        val = code
        if shift:
            val = ((val - 1) << shift) | gb.read(shift)
            val += 1
        if sign:
            val = -val
        val += pred
        bits = 5 + self.hdr.f_code
        val &= (1 << bits) - 1
        return val - (1 << bits) if val >> (bits - 1) else val

    def tcoef(self, tab, max_tables) -> tuple[int, int, int]:
        """One `(last, run, level)` of the TCOEF VLC with its escapes, level
        signed and not dequantized."""
        gb = self.gb
        sym = gb.vlc(tab)
        if sym != ESCAPE:
            last, run, level = sym
            return last, run, -level if gb.bit() else level
        max_level, max_run = max_tables
        if gb.bit():
            if gb.bit():  # third escape: fixed-length
                last = gb.bit()
                run = gb.read(6)
                if not gb.bit():
                    raise Corrupt("marker bit missing in the third escape")
                level = gb.read(12)
                if level >= 2048:
                    level -= 4096
                if not gb.bit():
                    raise Corrupt("marker bit missing in the third escape")
                if level == 0:
                    raise Corrupt("zero level in the third escape")
                return last, run, level
            sym = gb.vlc(tab)  # second escape: run offset
            if sym == ESCAPE:
                raise Corrupt("escape after the second escape")
            last, run, level = sym
            run += max_run[last][level] + 1
            return last, run, -level if gb.bit() else level
        sym = gb.vlc(tab)  # first escape: level offset
        if sym == ESCAPE:
            raise Corrupt("escape after the first escape")
        last, run, level = sym
        level += max_level[last][run]
        return last, run, -level if gb.bit() else level

    def pred_dc(self, n: int, mbx: int, mby: int) -> tuple[int, int, int, int]:
        """`ff_mpeg4_pred_dc`: `(prediction, direction (0 left, 1 top),
        plane, index)`."""
        p, i, wrap = self.st.index(n, mby, mbx)
        dc = self.st.dc[p]
        a, b, c = dc[i - 1], dc[i - 1 - wrap], dc[i - wrap]
        if self.first_line and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and mbx == self.resync_x:
                b = a = 1024
        if mbx == self.resync_x and mby == self.resync_y + 1 and n in (0, 4, 5):
            b = 1024
        if abs(a - b) < abs(b - c):
            return c, 1, p, i
        return a, 0, p, i

    def intra_block(self, n: int, mbx: int, mby: int, coded: int, ac_pred: int,
                    use_dc_vlc: bool) -> np.ndarray:
        gb = self.gb
        scale = self.y_dc if n < 4 else self.c_dc
        block = [0] * 64
        pred, direction, p, idx = self.pred_dc(n, mbx, mby)
        if use_dc_vlc:
            size = gb.vlc(TAB_DC[n >= 4])
            if size > 9:
                raise Corrupt("illegal DC VLC")
            level = 0
            if size:
                level = gb.xbits(size)
                if size > 8:
                    _marker(gb)
            block[0] = level
            i = 0
        else:
            i = -1
        if ac_pred:
            scan = ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL
        else:
            scan = ZIGZAG
        if coded:
            while True:
                last, run, level = self.tcoef(TAB_INTRA, MAX_INTRA)
                i += run + 1
                if i > 63:
                    raise Corrupt("run past the block's end")
                block[scan[i]] = level
                if last:
                    break
        # mpeg4_get_level_dc: the quantized DC and the stored level * scale
        level = block[0] + (pred + (scale >> 1)) // scale
        if level < 0 and use_dc_vlc:
            raise Corrupt("negative intra DC")  # mpeg4_decode_block's error
        stored = level * scale
        if stored & ~2047:
            stored = 0 if stored < 0 else 2047
        self.st.dc[p][idx] = stored
        block[0] = level
        self.pred_ac(block, n, p, idx, direction, ac_pred, mbx, mby)
        return self.dequant_intra(block, n)

    def pred_ac(self, block: list, n: int, p: int, idx: int, direction: int, ac_pred: int,
                mbx: int, mby: int) -> None:
        """`ff_mpeg4_pred_ac`, then the block's first column and row kept."""
        st = self.st
        if ac_pred:
            if direction == 0:
                src = st.ac[p][idx - 1]
                if mbx == 0 or n in (1, 3) or self.qscale == st.qscale[mby, mbx - 1]:
                    for k in range(1, 8):
                        block[k << 3] += src[k]
                else:
                    q = int(st.qscale[mby, mbx - 1])
                    for k in range(1, 8):
                        block[k << 3] += _rounded_div(src[k] * q, self.qscale)
            else:
                wrap = st.s8 if n < 4 else st.sm
                src = st.ac[p][idx - wrap]
                if mby == 0 or n in (2, 3) or self.qscale == st.qscale[mby - 1, mbx]:
                    for k in range(1, 8):
                        block[k] += src[k + 8]
                else:
                    q = int(st.qscale[mby - 1, mbx])
                    for k in range(1, 8):
                        block[k] += _rounded_div(src[k + 8] * q, self.qscale)
            for k in range(1, 64):
                block[k] = _i16(block[k])
        st.ac[p][idx] = [0] + [block[k << 3] for k in range(1, 8)] + [0] + block[1:8]

    def dequant_intra(self, block: list, n: int) -> np.ndarray:
        q = self.qscale
        b = np.array(block, np.int32)
        b[0] = b[0] * (self.y_dc if n < 4 else self.c_dc)
        ac = b[1:]
        if self.vol.mpeg_quant:  # dct_unquantize_mpeg2_intra at 2q
            m = np.array(self.vol.intra_matrix[1:], np.int32)
            mag = (np.abs(ac) * q * m) >> 3
        else:
            mag = np.where(ac != 0, np.abs(ac) * 2 * q + ((q - 1) | 1), 0)
        b[1:] = np.sign(ac) * mag
        return b.astype(np.int16)

    def inter_block(self) -> np.ndarray:
        block = np.zeros(64, np.int32)
        q, i = self.qscale, -1
        mpeg = self.vol.mpeg_quant
        while True:
            last, run, level = self.tcoef(TAB_INTER, MAX_INTER)
            i += run + 1
            if i > 63:
                raise Corrupt("run past the block's end")
            if mpeg:
                block[ZIGZAG[i]] = level
            else:
                mag = abs(level) * 2 * q + ((q - 1) | 1)
                if mag > 2047 + (level < 0):  # only the third escape reaches this
                    mag = 2047 + (level < 0)
                block[ZIGZAG[i]] = -mag if level < 0 else mag
            if last:
                break
        if mpeg:  # dct_unquantize_mpeg2_inter at 2q: mismatch control on an even sum
            m = np.array(self.vol.inter_matrix, np.int64)
            mag = ((2 * np.abs(block) + 1) * q * m) >> 4
            levels = np.where(block != 0, np.sign(block) * mag, 0)
            block = _wrap16(levels)
            block[63] ^= (int(levels.sum()) & 1) ^ 1
        return block.astype(np.int16)


def _i16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _wrap16(a: np.ndarray) -> np.ndarray:
    return ((a.astype(np.int64) + 0x8000) & 0xFFFF) - 0x8000


def _rounded_div(a: int, b: int) -> int:
    """`ROUNDED_DIV`: C's truncating division of `a +- b / 2`."""
    n = a + (b >> 1) if a > 0 else a - (b >> 1)
    q = abs(n) // b
    return q if n >= 0 else -q


# --- reconstruction -------------------------------------------------------------


def _fetch(ref: np.ndarray, y0: np.ndarray, x0: np.ndarray, size: int, hedge: int,
           vedge: int) -> np.ndarray:
    """`(n, size + 1, size + 1)` windows at `(y0, x0)` with coordinates
    clamped to the edge positions (`emulated_edge_mc`)."""
    k = np.arange(size + 1)
    ys = np.clip(y0[:, None] + k[None, :], 0, vedge - 1)
    xs = np.clip(x0[:, None] + k[None, :], 0, hedge - 1)
    return ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)


def _halfpel(win: np.ndarray, fx: np.ndarray, fy: np.ndarray, size: int, rounding: int,
             approx: np.ndarray) -> np.ndarray:
    """`put_pixels` / `put_no_rnd_pixels` of each window by its half-pel
    flags. With rounding off, the 8-wide horizontal and vertical averages
    that `approx` marks are x86's non-bit-exact ones (FFmpeg's
    `ff_put_no_rnd_pixels8_x2/y2_mmxext`, used without `BITEXACT`):
    `pavgb` after a saturating decrement of the left sample, and of the
    odd-indexed row of each pair (found by sweeps against cv2); the
    16-wide ones (a 16x16 vector's luma) are exact."""
    a = win[:, :size, :size]
    b = win[:, :size, 1:]
    c = win[:, 1:, :size]
    d = win[:, 1:, 1:]
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    x2 = (a + b + 1 - rounding) >> 1
    y2 = (a + c + 1 - rounding) >> 1
    if rounding:
        dec = lambda v: np.maximum(v - 1, 0)  # noqa: E731
        odd = (np.arange(size) % 2 == 1)[None, :, None]
        sel = approx[:, None, None]
        x2 = np.where(sel, (dec(a) + b + 1) >> 1, x2)
        y2 = np.where(sel, np.where(odd, (dec(a) + c + 1) >> 1, (a + dec(c) + 1) >> 1), y2)
    xy = (a + b + c + d + 2 - rounding) >> 2
    return np.where(fx & fy, xy, np.where(fx, x2, np.where(fy, y2, a)))


def predict(fr: Frame, ref: tuple, rounding: int, width: int, height: int,
            hedge: int, vedge: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Motion-compensated prediction of every non-intra MB: luma per 8x8
    block (a 16x16 vector's four blocks read what its 16x16 read reads),
    chroma per MB; intra MBs' entries are not used."""
    mbh, mbw = fr.kind.shape
    ry, ru, rv = ref
    by, bx = np.meshgrid(np.arange(2 * mbh), np.arange(2 * mbw), indexing="ij")
    mv = fr.mv.reshape(mbh, mbw, 2, 2, 2).transpose(0, 2, 1, 3, 4).reshape(2 * mbh, 2 * mbw, 2)
    mx, my = mv[..., 0].ravel(), mv[..., 1].ravel()
    four = np.repeat(np.repeat(fr.kind == MB_INTER4V, 2, 0), 2, 1).ravel()
    fx, fy = mx & 1, my & 1
    sx = bx.ravel() * 8 + (mx >> 1)
    sy = by.ravel() * 8 + (my >> 1)
    # apply_8x8: a 4MV block's position clipped to [-16, width], the half
    # sample dropped at the clip's top
    cx, cy = np.clip(sx, -16, width), np.clip(sy, -16, height)
    fx = np.where(four & (cx == width), 0, fx)
    fy = np.where(four & (cy == height), 0, fy)
    sx, sy = np.where(four, cx, sx), np.where(four, cy, sy)
    luma = _halfpel(_fetch(ry, sy, sx, 8, hedge, vedge), fx, fy, 8, rounding, four)
    luma = luma.reshape(2 * mbh, 2 * mbw, 8, 8)
    # chroma: H.263 rounding of the 16x16 vector, h263_round_chroma of the
    # 4MV sum
    m16 = fr.mv[:, :, 0]
    sums = fr.mv.sum(axis=2)
    is4 = fr.kind == MB_INTER4V
    chroma_round = np.array(CHROMA_ROUND)
    c4 = chroma_round[sums & 15] + ((sums >> 3) & ~1)
    c16 = ((m16 >> 2) << 1) | ((m16 & 3) != 0)
    cmv = np.where(is4[..., None], c4, c16)
    ux, uy = cmv[..., 0].ravel(), cmv[..., 1].ravel()
    my_, mx_ = np.meshgrid(np.arange(mbh), np.arange(mbw), indexing="ij")
    ufx, ufy = ux & 1, uy & 1
    usx = mx_.ravel() * 8 + (ux >> 1)
    usy = my_.ravel() * 8 + (uy >> 1)
    four_mb = is4.ravel()
    ccx, ccy = np.clip(usx, -8, width >> 1), np.clip(usy, -8, height >> 1)
    ufx = np.where(four_mb & (ccx == (width >> 1)), 0, ufx)
    ufy = np.where(four_mb & (ccy == (height >> 1)), 0, ufy)
    usx, usy = np.where(four_mb, ccx, usx), np.where(four_mb, ccy, usy)
    every = np.ones_like(four_mb)  # chroma: 8-wide averages
    cu = _halfpel(_fetch(ru, usy, usx, 8, hedge >> 1, vedge >> 1), ufx, ufy, 8, rounding, every)
    cv = _halfpel(_fetch(rv, usy, usx, 8, hedge >> 1, vedge >> 1), ufx, ufy, 8, rounding, every)
    return luma, cu.reshape(mbh, mbw, 8, 8), cv.reshape(mbh, mbw, 8, 8)


def reconstruct(fr: Frame, ref: tuple | None, rounding: int, width: int, height: int,
                hedge: int, vedge: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The coded-size `yuv420p` planes of a parsed VOP."""
    mbh, mbw = fr.kind.shape
    blocks = fr.blocks.reshape(mbh, mbw, 6, 8, 8)
    intra = fr.kind == MB_INTRA
    yb = blocks[:, :, :4].reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    yb = yb.reshape(2 * mbh, 2 * mbw, 8, 8)
    ub, vb = blocks[:, :, 4], blocks[:, :, 5]
    if ref is None:
        planes = idct_ff.idct_put(yb), idct_ff.idct_put(ub), idct_ff.idct_put(vb)
    else:
        py, pu, pv = predict(fr, ref, rounding, width, height, hedge, vedge)
        intra4 = np.repeat(np.repeat(intra, 2, 0), 2, 1)[..., None, None]
        planes = (np.where(intra4, idct_ff.idct_put(yb), idct_ff.idct_add(yb, py)),
                  np.where(intra[..., None, None], idct_ff.idct_put(ub), idct_ff.idct_add(ub, pu)),
                  np.where(intra[..., None, None], idct_ff.idct_put(vb), idct_ff.idct_add(vb, pv)))
    return tuple(idct_ff.blocks_to_plane(p) for p in planes)


# --- the decoder --------------------------------------------------------------


class Decoder:
    """Frames of an MPEG-4 Part 2 stream, packet by packet: `decode(packet)`
    returns the `(Y, U, V)` planes (frame size) of the VOPs it completes.
    `extradata` holds the VOL where the container carries it apart from the
    frames (MP4's `esds`); `codec_tag` is the container's fourcc, which
    FFmpeg reads as XviD or DivX for streams with no user data."""

    def __init__(self, extradata: bytes = b"", codec_tag: bytes = b"", compiled: bool = False):
        self.vol: Vol | None = None
        self.encoder: str | None = None
        self.codec_tag = codec_tag
        self.compiled = compiled
        self.ref: tuple | None = None
        if extradata:
            self.headers(extradata, 0, len(extradata))

    def headers(self, data: bytes, start: int, end: int) -> int | None:
        """Parse the headers in `data[start:end]`; the offset of a VOP's
        first byte after its start code, or None."""
        for code, pos in start_codes(data[start:end]):
            pos += start
            if 0x20 <= code <= 0x2F:
                self.vol = parse_vol(data[pos:end])
            elif code == USER_DATA:
                tag = encoder_tag(data[pos:end])
                if tag:
                    self.encoder = tag
            elif code == VOP:
                return pos
        return None

    def check_encoder(self) -> None:
        enc = self.encoder
        tag = self.codec_tag.upper()
        if enc is None and tag in (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP"):
            enc = "xvid"
        if enc is None and tag == b"DIVX":
            enc = "divx"
        if enc == "xvid":
            _refuse("XviD-tagged stream (FFmpeg decodes it with the XviD IDCT)")
        if enc == "divx":
            _refuse("DivX-tagged stream (FFmpeg applies DivX workarounds)")

    def decode(self, packet: bytes) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        out = []
        pos = self.headers(packet, 0, len(packet))
        if pos is None:
            return out
        if self.vol is None:
            return out  # FFmpeg drops VOPs until it has a VOL
        self.check_encoder()
        vol = self.vol
        hdr = parse_vop(packet, pos, vol)
        if not hdr.coded:
            return out
        if hdr.kind == P_VOP and self.ref is None:
            raise Corrupt("a P-VOP before the first I-VOP")
        planes = self.decode_vop(packet, hdr)
        self.ref = planes
        w, h = vol.width, vol.height
        out.append((planes[0][:h, :w], planes[1][:(h + 1) // 2, :(w + 1) // 2],
                    planes[2][:(h + 1) // 2, :(w + 1) // 2]))
        return out

    def edges(self) -> tuple[int, int]:
        """`(h_edge_pos, v_edge_pos)`: the coded (macroblock-aligned) size."""
        return (self.vol.width + 15) & ~15, (self.vol.height + 15) & ~15

    def decode_vop(self, packet: bytes, hdr: VopHeader) -> tuple:
        vol = self.vol
        hedge, vedge = self.edges()
        if self.compiled:
            return decode_vop_compiled(packet, hdr, vol, self.ref, hedge, vedge)
        fr = _Vop(packet, hdr, vol).run()
        ref = self.ref if hdr.kind == P_VOP else None
        return reconstruct(fr, ref, hdr.rounding, vol.width, vol.height, hedge, vedge)


def decode_vop_compiled(packet: bytes, hdr: VopHeader, vol: Vol, ref: tuple | None,
                        hedge: int, vedge: int) -> tuple:
    """`yp_mpeg4_decode_vop`: a VOP's macroblocks parsed, predicted and
    reconstructed in compiled host code."""
    from yolopoint_tpu_torch.ops import _build

    mbw, mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
    y = np.empty((mbh * 16, mbw * 16), np.uint8)
    u = np.empty((mbh * 8, mbw * 8), np.uint8)
    v = np.empty((mbh * 8, mbw * 8), np.uint8)
    data = np.frombuffer(bytes(packet) + bytes(8), np.uint8)
    params = np.array([vol.width, vol.height, hdr.kind, hdr.rounding, hdr.dc_threshold,
                       hdr.qscale, hdr.f_code, int(vol.mpeg_quant), int(vol.resync_marker),
                       vol.quant_precision, vol.time_increment_bits, hedge, vedge,
                       hdr.data_pos], np.int32)
    matrices = np.array(vol.intra_matrix + vol.inter_matrix, np.int32)
    if ref is None:
        ref = (y, u, v)  # not read by an I-VOP
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    status = _build.library().yp_mpeg4_decode_vop(
        p(data), len(packet), p(params), p(matrices), p(ref[0]), p(ref[1]), p(ref[2]),
        p(y), p(u), p(v))
    if status == 1:
        raise RuntimeError("yp_mpeg4_decode_vop: bad parameters")
    if status == 9:
        raise idct_ff.IdctOverflow("an MPEG-4 block whose IDCT row pass leaves 16 bits")
    if status:
        raise Corrupt(f"MPEG-4 stream error (status {status}): FFmpeg would conceal it")
    return y, u, v
