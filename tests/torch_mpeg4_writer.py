"""Random MPEG-4 Part 2 Simple-profile streams for the decoder tests: every
syntax element FFmpeg's decoder reads, drawn at random from a seed
(I- and P-VOPs; intra, intra+Q, inter, inter+Q, 4MV and 4MV+Q macroblocks,
not-coded macroblocks and MCBPC stuffing; AC prediction, DQUANT, every
`intra_dc_vlc_thr`; the TCOEF tables and their three escapes; motion vector
differentials at `f_code` 1-3; H.263 or MPEG quantization with custom
matrices; video packets with and without header extension; both rounding
types). The coefficients and vectors are noise, so the frames are too, but
the streams are valid: cv2 (FFmpeg) decodes them without concealment, and
its frames are the oracle for the port's decoder. The streams' VOL carries
lavc's user data, so FFmpeg applies no workaround to them.
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.data import mpeg4video as m4

LAVC_USER_DATA = b"Lavc62.28.101"


class BitWriter:
    def __init__(self):
        self.bits: list[str] = []

    def put(self, value: int, n: int) -> None:
        if n:
            self.bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def code(self, vlc: tuple[int, int]) -> None:
        self.put(*vlc)

    def length(self) -> int:
        return sum(len(b) for b in self.bits)

    def stuff(self) -> None:
        """A 0 then 1s to the next byte boundary (a whole byte if aligned)."""
        n = 8 - self.length() % 8
        self.put((1 << (n - 1)) - 1, n)

    def bytes(self) -> bytes:
        s = "".join(self.bits)
        assert len(s) % 8 == 0
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


def vol_bytes(width: int, height: int, mpeg_quant: bool, resync: bool,
              rng: np.random.Generator) -> tuple[bytes, m4.Vol]:
    """VOS, VO, VOL (verid 1, Simple, 4:2:0, rectangular) and lavc's user
    data; the Vol the decoder will parse."""
    w = BitWriter()
    w.put(0, 1)  # random_accessible_vol
    w.put(1, 8)  # video_object_type_indication: Simple
    w.put(0, 1)  # is_object_layer_identifier
    w.put(1, 4)  # aspect_ratio_info: square
    w.put(0, 1)  # vol_control_parameters
    w.put(0, 2)  # shape: rectangular
    w.put(1, 1)
    w.put(25, 16)  # vop_time_increment_resolution
    w.put(1, 1)
    w.put(0, 1)  # fixed_vop_rate
    w.put(1, 1)
    w.put(width, 13)
    w.put(1, 1)
    w.put(height, 13)
    w.put(1, 1)
    w.put(0, 1)  # interlaced
    w.put(1, 1)  # obmc_disable
    w.put(0, 1)  # sprite_enable (verid 1)
    w.put(0, 1)  # not_8_bit
    w.put(int(mpeg_quant), 1)
    vol = m4.Vol(width=width, height=height, vo_type=1, time_increment_bits=5,
                 mpeg_quant=mpeg_quant, resync_marker=resync)
    if mpeg_quant:
        for attr in ("intra_matrix", "inter_matrix"):
            w.put(1, 1)  # load the matrix
            n = int(rng.integers(20, 65))  # shorter ones end with 0: the last value repeats
            vals = [int(v) for v in rng.integers(8, 41, n)]
            for v in vals:
                w.put(v, 8)
            if n < 64:
                w.put(0, 8)
            mat = [0] * 64
            for k in range(64):
                mat[m4.ZIGZAG[k]] = vals[min(k, n - 1)]
            setattr(vol, attr, tuple(mat))
    w.put(1, 1)  # complexity_estimation_disable
    w.put(0 if resync else 1, 1)  # resync_marker_disable
    w.put(0, 1)  # data_partitioned
    w.put(0, 1)  # scalability
    w.stuff()
    head = b"\x00\x00\x01\xb0\x01\x00\x00\x01\xb5\x09\x00\x00\x01\x00\x00\x00\x01\x20"
    return head + w.bytes() + b"\x00\x00\x01\xb2" + LAVC_USER_DATA, vol


class _Tables:
    def __init__(self):
        self.intra = self._events(m4.INTRA_VLC, m4.INTRA_RUN, m4.INTRA_LEVEL, m4.INTRA_LAST)
        self.inter = self._events(m4.INTER_VLC, m4.INTER_RUN, m4.INTER_LEVEL, m4.INTER_LAST)

    @staticmethod
    def _events(vlc, runs, levels, last):
        return [(i >= last, r, lv, vlc[i]) for i, (r, lv) in enumerate(zip(runs, levels))]


TABLES = _Tables()


class VopWriter:
    """One random VOP; `self.qscale` follows the decoder's (DQUANT clipped
    to 1-31) so that the intra DC's coding can follow the threshold."""

    def __init__(self, rng: np.random.Generator, vol: m4.Vol, kind: int, index: int):
        self.rng, self.vol, self.kind, self.index = rng, vol, kind, index
        self.w = BitWriter()
        self.mbw, self.mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
        # quantizers and levels stay moderate: an encoder's blocks keep the
        # IDCT's row pass in 16 bits (past that the port raises)
        self.qscale = int(rng.integers(1, 7 if vol.mpeg_quant else 13))
        self.f_code = int(rng.integers(1, 4)) if kind == m4.P_VOP else 1
        self.thr = int(rng.integers(0, 8))

    def header(self) -> None:
        w = self.w
        w.put(self.kind, 2)
        w.put(0, 1)  # modulo_time_base
        w.put(1, 1)
        w.put(self.index, 5)  # vop_time_increment (resolution 25: under 25 VOPs)
        w.put(1, 1)
        w.put(1, 1)  # vop_coded
        if self.kind == m4.P_VOP:
            w.put(int(self.rng.integers(0, 2)), 1)  # vop_rounding_type
        w.put(self.thr, 3)
        w.put(self.qscale, 5)
        if self.kind == m4.P_VOP:
            w.put(self.f_code, 3)

    def coin(self, p: float) -> bool:
        return bool(self.rng.random() < p)

    def dquant(self) -> None:
        d = int(self.rng.integers(0, 4))
        self.w.put(d, 2)
        self.qscale = min(max(self.qscale + m4.QUANT_TAB[d], 1), 31)

    def tcoefs(self, intra: bool, start: int) -> None:
        """Events from scan position `start` (the first event's position is
        `start + run`), the last one flagged, positions <= 62 before it. An
        intra block without a DC VLC (`start` 0) gets no DC event: its DC
        stays the prediction, which keeps it in range (FFmpeg refuses a
        negative intra DC)."""
        w, rng = self.w, self.rng
        table = TABLES.intra if intra else TABLES.inter
        max_level, max_run = m4.MAX_INTRA if intra else m4.MAX_INTER
        esc = (m4.INTRA_VLC if intra else m4.INTER_VLC)[102]
        pos = start - 1 if start else 0
        count = int(rng.integers(1, 6))
        for k in range(count):
            final = k == count - 1 or pos >= 55
            room = (63 if final else 62) - pos - 1  # largest run that fits
            kind = rng.choice(4, p=[0.7, 0.1, 0.1, 0.1])
            choices = [e for e in table if e[0] == final and e[1] <= room]
            if kind == 2:  # second escape: run + max_run + 1 must fit
                choices = [e for e in choices if e[1] + max_run[int(final)][e[2]] + 1 <= room]
            if kind == 3 or not choices:
                run = int(rng.integers(0, min(room, 8) + 1))
                level = int(rng.integers(13, 41)) * (1 if self.coin(0.5) else -1)
                w.code(esc)
                w.put(3, 2)
                w.put(int(final), 1)
                w.put(run, 6)
                w.put(1, 1)
                w.put(level, 12)
                w.put(1, 1)
                pos += run + 1
            else:
                last, run, level, code = choices[int(rng.integers(0, len(choices)))]
                if kind == 1:
                    w.code(esc)
                    w.put(0, 1)
                elif kind == 2:
                    w.code(esc)
                    w.put(2, 2)
                    run += max_run[int(final)][level] + 1
                w.code(code)
                w.put(int(self.coin(0.5)), 1)
                pos += run + 1
            if final:
                return

    def intra_mb(self, cbpc: int, dquant: bool) -> None:
        w = self.w
        w.put(int(self.coin(0.5)), 1)  # ac_pred_flag
        cbpy = int(self.rng.integers(0, 16))
        w.code(m4.CBPY[cbpy])
        use_dc_vlc = self.qscale < m4.DC_THRESHOLD[self.thr]
        if dquant:
            self.dquant()
        cbp = cbpc | (cbpy << 2)
        for n in range(6):
            coded = cbp & (32 >> n)
            if use_dc_vlc:
                # differentials of +-1 keep the DC level in range (a negative
                # one is an error to FFmpeg) and the IDCT's row pass in 16 bits
                size = int(self.rng.integers(0, 2))
                w.code((m4.DC_LUM if n < 4 else m4.DC_CHROM)[size])
                if size:
                    w.put(int(self.rng.integers(0, 2)), 1)
                if coded:
                    self.tcoefs(True, 1)
            elif coded:
                self.tcoefs(True, 0)

    def motion(self) -> None:
        w = self.w
        code = int(min(abs(self.rng.normal(0, 6)), 32))
        w.code(m4.MVTAB[code])
        if code:
            w.put(int(self.coin(0.5)), 1)
            if self.f_code > 1:
                w.put(int(self.rng.integers(0, 1 << (self.f_code - 1))), self.f_code - 1)

    def macroblock(self) -> None:
        w = self.w
        if self.kind == m4.I_VOP:
            if self.coin(0.05):
                w.code(m4.INTRA_MCBPC[8])  # stuffing
            dquant = self.coin(0.3)
            cbpc = int(self.rng.integers(0, 4))
            w.code(m4.INTRA_MCBPC[4 * dquant + cbpc])
            self.intra_mb(cbpc, dquant)
            return
        if self.coin(0.05):
            w.put(0, 1)
            w.code(m4.INTER_MCBPC[20])  # stuffing
        if self.coin(0.15):
            w.put(1, 1)  # not coded
            return
        w.put(0, 1)
        # the inter MCBPC table's types: 0 inter, 1 intra, 2 inter+Q, 3 intra+Q,
        # 4 4MV, 6 4MV+Q (5 is stuffing)
        mb_type = int(self.rng.choice([0, 1, 2, 3, 4, 6], p=[0.35, 0.1, 0.15, 0.1, 0.2, 0.1]))
        cbpc = int(self.rng.integers(0, 4))
        w.code(m4.INTER_MCBPC[4 * mb_type + cbpc])
        if mb_type in (1, 3):
            self.intra_mb(cbpc, mb_type == 3)
            return
        cbpy_code = int(self.rng.integers(0, 16))
        w.code(m4.CBPY[cbpy_code])
        if mb_type in (2, 6):
            self.dquant()
        for _ in range(4 if mb_type in (4, 6) else 1):
            self.motion()
            self.motion()
        cbp = cbpc | ((cbpy_code ^ 0xF) << 2)
        for n in range(6):
            if cbp & (32 >> n):
                self.tcoefs(False, 0)

    def packet_header(self, mb_num: int) -> None:
        """Stuffing, a resync marker and a video packet header at `mb_num`."""
        w = self.w
        w.stuff()
        w.put(1, (16 if self.kind == m4.I_VOP else self.f_code + 15) + 1)
        n_mbs = self.mbw * self.mbh
        w.put(mb_num, (n_mbs - 1).bit_length())
        self.qscale = int(self.rng.integers(1, 7 if self.vol.mpeg_quant else 13))
        w.put(self.qscale, 5)
        hec = self.coin(0.5)
        w.put(int(hec), 1)
        if hec:
            w.put(0, 1)  # modulo_time_base
            w.put(1, 1)
            w.put(self.index, 5)
            w.put(1, 1)
            w.put(self.kind, 2)
            w.put(self.thr, 3)
            if self.kind != m4.I_VOP:
                w.put(self.f_code, 3)

    def vop(self) -> bytes:
        self.header()
        n = self.mbw * self.mbh
        for mb in range(n):
            if mb and self.vol.resync_marker and self.coin(0.15):
                self.packet_header(mb)
            self.macroblock()
        self.w.stuff()
        return b"\x00\x00\x01\xb6" + self.w.bytes()


def random_stream(seed: int, width: int, height: int, vops: int, mpeg_quant: bool,
                  resync: bool) -> list[bytes]:
    """Packets of one random stream: the VOL with the first VOP (an I-VOP),
    then random I- and P-VOPs (mostly P)."""
    rng = np.random.default_rng(seed)
    head, vol = vol_bytes(width, height, mpeg_quant, resync, rng)
    packets = []
    for k in range(vops):
        kind = m4.I_VOP if k == 0 or rng.random() < 0.2 else m4.P_VOP
        packets.append((head if k == 0 else b"") + VopWriter(rng, vol, kind, k).vop())
    return packets


def avi_of(packets: list[bytes], width: int, height: int) -> bytes:
    from tests.torch_video_files import avi_bytes

    return avi_bytes(packets, width, height, fourcc=b"FMP4")

