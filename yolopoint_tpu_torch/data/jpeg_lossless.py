"""Lossless JPEG (SOF3) samples in Python: libjpeg-turbo's `jdlhuff.c` (the
differences), `jddiffct.c` (MCU rows, restarts) and `jdlossls.c`
(prediction, point transform), which `cv2.imread` runs. libjpeg-turbo
converts no colour in lossless mode, so `cv2.imread` reads a one-component
file in grey only, a three-component RGB file in colour only and a CMYK
file in both (`jpeg.lossless_refused`); the planes go through the DCT
path's upsampling, by replication (no fancy upsampling without DCT
blocks), and colour conversion (`jpeg.compose`).

* Each difference is a Huffman-coded category `s` (on the scan component's
  DC table) and `s` extra bits, category 16 being 32768 with none. An
  interleaved scan codes each component's `v x h` samples an MCU in turn, a
  non-interleaved one a sample an MCU; an iMCU row is `v` rows of each
  component (`vmax` image rows).
* Each row of a component is undifferenced modulo 2**16 against the
  predictor of the scan's Ss: 1 left (Ra), 2 above (Rb), 3 above-left (Rc),
  4 `Ra + Rb - Rc`, 5 `Ra + ((Rb - Rc) >> 1)`, 6 `Rb + ((Ra - Rc) >> 1)`, 7
  `(Ra + Rb) >> 1`; the first column from the sample above. A component's
  first row after the scan's start, a restart or a row out of data is
  predicted from the left, its first sample from `2 ** (P - Pt - 1)`
  (`start_pass`: every component's undifferencer is reset, and the reset
  takes effect at the first row undifferenced after it, which is the
  first row of an iMCU row).
* The output sample is the undifferenced one shifted left by the point
  transform Pt (the scan's Al), kept to 8 bits.
* Restarts come every `DRI / MCUs a row` MCU rows (whole rows only). Where
  the data runs out, the rest of that MCU row decodes from zero bits (each
  sample the one difference its table gives zero bits, filled in without
  reading past the segment's padding) and every later MCU row of the
  interval has zero differences.

Twin: the lossless branch of `yp_jpeg_decode` in `ops/csrc/host_image.cpp`.
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.data.jpeg import Header, _Bits, _extend, _lut, geometry, segments


def _undifference(d: list[int], prev: list[int] | None, predictor: int,
                  initial: int) -> list[int]:
    """One row's samples (mod 2**16) of its differences `d`: a first row
    where `prev` is None, else against the row above."""
    out = [0] * len(d)
    ra = (d[0] + (initial if prev is None else prev[0])) & 0xFFFF
    out[0] = ra
    for c in range(1, len(d)):
        if prev is None or predictor == 1:
            p = ra
        else:
            rb, rc = prev[c], prev[c - 1]
            p = (rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                 (ra + rb) >> 1)[predictor - 2]
        ra = (d[c] + p) & 0xFFFF
        out[c] = ra
    return out


def decode_planes(hdr: Header) -> list[np.ndarray]:
    """Each component's uint8 samples `(dh, dw)` (its downsampled size) of a
    parsed lossless file, after every scan."""
    mx, my, _, sizes = geometry(hdr, 1)
    planes = [np.zeros(size, np.uint8) for size in sizes]
    initial = {}
    for scan in hdr.scans:
        single = len(scan.comps) == 1
        ux = sizes[scan.comps[0]][1] if single else mx
        shape = {c: (1, 1) if single else hdr.sampling[c] for c in scan.comps}
        luts = [_lut(*pair[0]) for pair in scan.huffman]
        zero = []  # the difference each scan component's table decodes zero bits to
        for lut in luts:
            b = _Bits(b"")
            s = b.decode(lut)
            zero.append(32768 if s == 16 else _extend(b.get(s), s) if s else 0)
        segs = segments(scan.data)
        rows_a_restart = scan.restart // ux if scan.restart else 0
        bits, index, short, left = _Bits(segs[0]), 0, False, rows_a_restart
        reset = {c: True for c in range(len(hdr.sampling))}  # start_pass
        prev = {}
        for c in scan.comps:
            initial[c] = 1 << (hdr.precision - scan.al - 1)
        for imcu in range(my):
            # the rows of each component this iMCU row holds (fewer at the end)
            real = {c: min(hdr.sampling[c][1], sizes[c][0] - imcu * hdr.sampling[c][1])
                    for c in scan.comps}
            diff = {c: [] for c in scan.comps}
            for _ in range(real[scan.comps[0]] if single else 1):  # MCU rows
                if rows_a_restart and left == 0:  # process_restart
                    index += 1
                    if index < len(segs):
                        bits, short = _Bits(segs[index]), False
                    else:
                        bits = _Bits(b"")
                    reset = dict.fromkeys(reset, True)
                    left = rows_a_restart
                rows = {c: [[0] * (ux * shape[c][0]) for _ in range(shape[c][1])]
                        for c in scan.comps}
                if short:  # out of data: zero differences, the undifferencers reset
                    reset = dict.fromkeys(reset, True)
                else:
                    for m in range(ux):
                        if bits.pos >= bits.nbits:  # zero bits only: the rest decode alike
                            for slot, c in enumerate(scan.comps):
                                at = m * shape[c][0]
                                for row in rows[c]:
                                    row[at:] = [zero[slot]] * (len(row) - at)
                            short = True
                            break
                        for slot, c in enumerate(scan.comps):
                            h, v = shape[c]
                            for dv in range(v):
                                for dh in range(h):
                                    s = bits.decode(luts[slot])
                                    rows[c][dv][m * h + dh] = (
                                        32768 if s == 16 else _extend(bits.get(s), s) if s else 0)
                    else:
                        short = bits.pos > bits.nbits
                for c in scan.comps:
                    diff[c] += rows[c]
                left -= 1
            for c in scan.comps:
                v, dw = hdr.sampling[c][1], sizes[c][1]
                for r in range(real[c]):
                    first = reset[c]
                    reset[c] = False
                    prev[c] = _undifference(diff[c][r][:dw], None if first else prev[c],
                                            scan.ss, initial[c])
                    planes[c][imcu * v + r] = (np.asarray(prev[c], np.int64) << scan.al) & 0xFF
    return planes
