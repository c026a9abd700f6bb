"""Arithmetic-coded JPEG scans (SOF9, SOF10) in Python: libjpeg-turbo's
`jdarith.c`, which `cv2.imread` runs, as its spec.

* `ARITAB` is `jaricom.c`'s `jpeg_aritab`: the 113 states of the QM
  coder's probability estimate (Table D.2 of the standard) and the fixed
  0.5 state 113, each packed as `Qe << 16 | Next_MPS << 8 | Switch << 7 |
  Next_LPS`; `_QM.decode` is `arith_decode` (renormalisation and byte input
  per D.2.6, a marker read as zero bytes from then on).
* `decode_scan` is the entropy decode of one scan into the coefficient
  buffer that `jpeg.decode_scan_numpy` fills for a Huffman scan: the
  sequential `decode_mcu` and the progressive `decode_mcu_DC_first`,
  `_DC_refine`, `_AC_first` and `_AC_refine`. DC statistics are picked by
  the previous difference's class against the table's conditioning L and U
  (`DAC`; 0 and 1 by default), AC statistics split at its Kx (5 by
  default); statistics belong to a table number, not to a component. At
  each restart (`process_restart`) the scan's statistics, DC predictors and
  contexts and the decoder are reset. A magnitude or spectral overflow
  (`ct = -1`) leaves the MCU as decoded so far and the rest of the restart
  interval untouched, but for DC refinement, which does not check it.

Twin: the arithmetic branch of `yp_jpeg_decode` in `ops/csrc/host_image.cpp`.
"""

from __future__ import annotations

from yolopoint_tpu_torch.data.jpeg import (NATURAL, NUM_ARITH_TBLS, Header, Scan, mcu_blocks,
                                           segments)

_D2 = (  # (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) of states 0..112, then 113
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
ARITAB = tuple(qe << 16 | nm << 8 | sw << 7 | nl for qe, nl, nm, sw in _D2)
FIXED = 113  # the state of the fixed 0.5 estimate (signs, DC refinement)
DC_STAT_BINS, AC_STAT_BINS = 64, 256


def _i16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class _QM:
    """`arith_decode` over one restart interval's unstuffed bytes, read on
    as zero bytes past their end (a marker stuffs zeros)."""

    def __init__(self, seg: bytes):
        self.data, self.pos = seg, 0
        self.c, self.a, self.ct = 0, 0, -16  # ct -16: two bytes to fetch first

    def decode(self, st: list, i: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                byte = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                self.c = (self.c << 8) | byte
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:  # conditional exchange: the MPS after all
                self.a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7


def _continue(qm: _QM, st: list, at: int, m: int) -> tuple[int, int] | None:
    """Figure F.23's continuation: `m` doubled while bin `at`, `at + 1`, ...
    decode 1; `(m, bin after the last)`, or None on a magnitude overflow."""
    while qm.decode(st, at):
        m <<= 1
        if m == 0x8000:
            return None
        at += 1
    return m, at


def _pattern(qm: _QM, st: list, at: int, m: int) -> int:
    """Figure F.24: the value below the category's top bit `m`, its bits
    from bin `at` down; `v - 1` of the coefficient's magnitude."""
    v = m
    m >>= 1
    while m:
        if qm.decode(st, at):
            v |= m
        m >>= 1
    return v


def decode_scan(hdr: Header, scan: Scan, coef: list[list[int]]) -> int:
    """One arithmetic-coded scan's entropy decode into `coef` (per component
    a flat list over `jpeg.geometry`'s grid, natural order). Returns -1 (the
    data never runs out: a marker reads as zero bytes)."""
    seq = not hdr.progressive
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    p1, m1 = 1 << al, -(1 << al)
    dc_stats = [[0] * DC_STAT_BINS for _ in range(NUM_ARITH_TBLS)]
    ac_stats = [[0] * AC_STAT_BINS for _ in range(NUM_ARITH_TBLS)]
    fixed = [FIXED]
    ns = len(scan.comps)
    uses_dc = seq or (ss == 0 and ah == 0)
    uses_ac = seq or ss > 0
    segs = segments(scan.data)
    total, blocks_of = mcu_blocks(hdr, scan)
    interval = scan.restart or total
    for first in range(0, total, interval):
        # start_pass / process_restart: statistics, DC predictions and the
        # decoder reset; a missing segment reads as zero bytes
        qm = _QM(segs[first // interval] if first // interval < len(segs) else b"")
        for slot in range(ns):
            dc_t, ac_t = scan.tables[slot]
            if uses_dc:
                dc_stats[dc_t][:] = [0] * DC_STAT_BINS
            if uses_ac:
                ac_stats[ac_t][:] = [0] * AC_STAT_BINS
        last_dc, context = [0] * ns, [0] * ns
        failed = False
        for m in range(first, min(first + interval, total)):
            if failed and not (hdr.progressive and ss == 0 and ah):
                continue
            for slot, ci, b in blocks_of(m):
                out = coef[ci]
                dc_t, ac_t = scan.tables[slot]
                dc_l, dc_u, ac_k = scan.conditioning[slot]
                if not seq and ss == 0 and ah:  # DC refine: the next bit of the DC
                    if qm.decode(fixed, 0):
                        out[b] = _i16(out[b] | p1)
                    continue
                if uses_dc:  # F.19: the DC difference
                    st = dc_stats[dc_t]
                    s0 = context[slot]
                    if qm.decode(st, s0) == 0:
                        context[slot] = 0
                    else:
                        sign = qm.decode(st, s0 + 1)
                        at = s0 + 2 + sign
                        m_cat = qm.decode(st, at)
                        if m_cat:
                            found = _continue(qm, st, 20, 1)  # X1 = 20
                            if found is None:
                                failed = True
                                break
                            m_cat, at = found
                        if m_cat < (1 << dc_l) >> 1:
                            context[slot] = 0
                        elif m_cat > (1 << dc_u) >> 1:
                            context[slot] = 12 + 4 * sign
                        else:
                            context[slot] = 4 + 4 * sign
                        v = _pattern(qm, st, at + 14, m_cat)
                        v += 1
                        last_dc[slot] = (last_dc[slot] + (-v if sign else v)) & 0xFFFF
                    out[b] = _i16(last_dc[slot] << (0 if seq else al))
                    if not seq:
                        continue
                if not uses_ac:
                    continue
                st = ac_stats[ac_t]
                lo, hi = (1, 63) if seq else (ss, se)
                if ah and not seq:  # AC refine
                    kex = hi
                    while kex > 0 and not out[b + NATURAL[kex]]:
                        kex -= 1
                    k = lo
                    while k <= hi:
                        at = 3 * (k - 1)
                        if k > kex and qm.decode(st, at):
                            break  # EOB
                        while True:
                            pos = b + NATURAL[k]
                            if out[pos]:  # a correction bit
                                if qm.decode(st, at + 2):
                                    out[pos] = _i16(out[pos] + (m1 if out[pos] < 0 else p1))
                                break
                            if qm.decode(st, at + 1):  # newly nonzero
                                out[pos] = _i16(m1 if qm.decode(fixed, 0) else p1)
                                break
                            at += 3
                            k += 1
                            if k > hi:
                                failed = True
                                break
                        if failed:
                            break
                        k += 1
                    if failed:
                        break
                    continue
                k = lo
                while k <= hi:  # F.20: sequential AC, or AC first
                    at = 3 * (k - 1)
                    if qm.decode(st, at):
                        break  # EOB
                    while qm.decode(st, at + 1) == 0:
                        at += 3
                        k += 1
                        if k > hi:
                            failed = True
                            break
                    if failed:
                        break
                    sign = qm.decode(fixed, 0)
                    at += 2
                    m_cat = qm.decode(st, at)
                    if m_cat and qm.decode(st, at):
                        found = _continue(qm, st, 189 if k <= ac_k else 217, 2)
                        if found is None:
                            failed = True
                            break
                        m_cat, at = found
                    v = _pattern(qm, st, at + 14, m_cat)
                    v += 1
                    out[b + NATURAL[k]] = _i16((-v if sign else v) << (0 if seq else al))
                    k += 1
                if failed:
                    break
    return -1
