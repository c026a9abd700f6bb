"""Zstandard decompression (RFC 8878) without a zstd package.

The JAX package's checkpoints are orbax directories whose every manifest,
B-tree node and array chunk is a zstd frame (`training/orbax_read.py`). The
machine that runs the port has no zstd module, so the format is decoded
here: `decompress(data)` returns the content of every frame in `data`, laid
end to end, skippable frames skipped. It reads what RFC 8878 allows without
a dictionary:

  * frame headers with or without the single-segment flag, a window
    descriptor, a frame content size of 1, 2, 4 or 8 bytes (or none) and a
    dictionary ID of 0 (any other raises);
  * raw, RLE and compressed blocks;
  * literals raw, RLE, or Huffman-coded (a tree with direct or FSE-compressed
    weights, or the previous block's tree) in one or four streams;
  * sequences whose three codes are predefined, RLE, FSE-compressed or
    repeated from the previous block, with the three repeat offsets;
  * the XXH64 content checksum where the frame has one.

A malformed or truncated frame, a checksum or content size that does not
match, or a dictionary raises `ZstdError`; no partial output is returned.

This is the plain version, for a run on the CPU and for the tests. A run on
the GPU decodes with the same algorithm in compiled host code
(`yp_zstd_decompress` in `ops/csrc/host_zstd.cpp`, `decompress_compiled`).
The Huffman streams, which hold nearly all of a checkpoint's bytes, are
decoded with numpy: every bit position's code is looked up at once, and
the chain of positions a stream visits is followed by pointer jumping.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50  # the low 4 bits are free
BLOCK_MAX = 1 << 17
HUFFMAN_MAX_BITS = 11
MASK64 = (1 << 64) - 1

# (baseline, extra bits) of the literal-length codes 0-35 and the
# match-length codes 0-52 (RFC 8878 3.1.1.3.2.1.1)
LL_CODES = tuple((i, 0) for i in range(16)) + (
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4),
    (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13),
    (16384, 14), (32768, 15), (65536, 16))
ML_CODES = tuple((i + 3, 0) for i in range(32)) + (
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16))
MAX_OFFSET_CODE = 31
# the predefined distributions and their accuracy logs (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = ((4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
               2, 1, 1, 1, 1, 1, -1, -1, -1, -1), 6)
ML_DEFAULT = ((1, 4, 3) + (2,) * 6 + (1,) * 37 + (-1,) * 7, 6)
OF_DEFAULT = ((1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
               -1, -1, -1, -1), 5)
# (largest symbol, largest accuracy log) of the literal-length, offset and
# match-length tables
SEQ_LIMITS = ((35, 9), (MAX_OFFSET_CODE, 8), (52, 9))


class ZstdError(ValueError):
    """A zstd frame that is malformed, truncated or fails its checksum."""


# ---------------------------------------------------------------- bit readers

class _BackwardBits:
    """The backward bitstream of Huffman weights and sequences: read from the
    highest bit under the end marker (the last byte's highest set bit)
    down; bits below the start read as zeros and leave `pos` negative."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, what: str):
        if not data or data[-1] == 0:
            raise ZstdError(f"{what}: bitstream has no end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        hi = self.pos
        lo = hi - n
        self.pos = lo
        if hi <= 0:
            return 0
        if lo >= 0:
            v = int.from_bytes(self.data[lo >> 3:(hi + 7) >> 3], "little") >> (lo & 7)
        else:
            v = int.from_bytes(self.data[:(hi + 7) >> 3], "little") << -lo
        return v & ((1 << n) - 1)


def _read_fse_description(data: bytes, max_symbol: int, max_log: int,
                          what: str) -> tuple[list[int], int, int]:
    """`(normalized counts, accuracy log, bytes read)` of an FSE table
    description (RFC 8878 4.1.1), read forward from the start of `data`."""
    value = int.from_bytes(data, "little")
    nbits_total = 8 * len(data)
    pos = 4
    log = (value & 0xF) + 5
    if log > max_log:
        raise ZstdError(f"{what}: FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError(f"{what}: FSE description past symbol {max_symbol}")
        bits = value >> pos
        limit = (2 * threshold - 1) - remaining
        low = bits & (threshold - 1)
        if low < limit:
            count = low
            pos += nbits - 1
        else:
            count = bits & (2 * threshold - 1)
            if count >= threshold:
                count -= limit
            pos += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:  # 2-bit repeat flags of further zero counts
                repeat = (value >> pos) & 3
                pos += 2
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
        while remaining < threshold and threshold > 1:
            nbits -= 1
            threshold >>= 1
        if pos > nbits_total:
            raise ZstdError(f"{what}: FSE description truncated")
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError(f"{what}: FSE description is inconsistent")
    return counts, log, (pos + 7) >> 3


def _fse_table(counts, log: int, what: str) -> tuple[list[int], list[int], list[int]]:
    """The decoding table `(symbol, bits, base)` of each state for the
    normalized `counts` at accuracy `log` (RFC 8878 4.1.1)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nexts = []
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nexts.append(1)
        else:
            nexts.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError(f"{what}: FSE counts do not fill the table")
    bits = [0] * size
    base = [0] * size
    for state in range(size):
        s = symbols[state]
        nxt = nexts[s]
        nexts[s] += 1
        nb = log - (nxt.bit_length() - 1)
        bits[state] = nb
        base[state] = (nxt << nb) - size
    return symbols, bits, base


def _rle_table(symbol: int) -> tuple[list[int], list[int], list[int]]:
    return [symbol], [0], [0]


_PREDEFINED = tuple(_fse_table(c, log, "predefined") for c, log in
                    (LL_DEFAULT, OF_DEFAULT, ML_DEFAULT))


# -------------------------------------------------------------------- Huffman

def _huffman_weights(data: bytes, pos: int, what: str) -> tuple[list[int], int]:
    """`(weights of every symbol, position after the tree description)`."""
    if pos >= len(data):
        raise ZstdError(f"{what}: Huffman tree description truncated")
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        end = pos + (n + 1) // 2
        if end > len(data):
            raise ZstdError(f"{what}: Huffman weights truncated")
        packed = data[pos:end]
        weights = [(packed[i >> 1] >> 4) if i % 2 == 0 else (packed[i >> 1] & 15)
                   for i in range(n)]
        pos = end
    else:
        end = pos + header
        if header == 0 or end > len(data):
            raise ZstdError(f"{what}: Huffman weights truncated")
        body = data[pos:end]
        counts, log, used = _read_fse_description(body, 255, 6, what)
        if used >= len(body):
            raise ZstdError(f"{what}: Huffman weight stream missing")
        symbols, bits, base = _fse_table(counts, log, what)
        stream = _BackwardBits(body[used:], what)
        s1 = stream.read(log)
        s2 = stream.read(log)
        weights = []
        states = [s1, s2]
        i = 0
        while True:  # two interleaved states until the stream runs out
            if len(weights) > 254:
                raise ZstdError(f"{what}: too many Huffman weights")
            st = states[i]
            weights.append(symbols[st])
            states[i] = base[st] + stream.read(bits[st])
            if stream.pos < 0:  # read past the start: the other state's symbol ends it
                weights.append(symbols[states[1 - i]])
                break
            i = 1 - i
        pos = end
    if any(w > HUFFMAN_MAX_BITS + 1 for w in weights):
        raise ZstdError(f"{what}: Huffman weight out of range")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError(f"{what}: Huffman weights are all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if max_bits > HUFFMAN_MAX_BITS or left & (left - 1):
        raise ZstdError(f"{what}: Huffman weights do not make a prefix code")
    weights.append(left.bit_length())
    if len(weights) > 256:
        raise ZstdError(f"{what}: too many Huffman weights")
    return weights, pos


class _HuffmanTable:
    """The lookup table of a Huffman tree: the symbol and code length of
    every `max_bits`-bit prefix."""

    def __init__(self, weights: list[int]):
        self.max_bits = max_bits = sum(1 << (w - 1) for w in weights if w).bit_length() - 1
        size = 1 << max_bits
        self.symbol = np.zeros(size, np.uint8)
        self.length = np.zeros(size, np.int32)
        pos = 0
        for w in range(1, max_bits + 1):
            for s, ws in enumerate(weights):
                if ws == w:
                    n = 1 << (w - 1)
                    self.symbol[pos:pos + n] = s
                    self.length[pos:pos + n] = max_bits + 1 - w
                    pos += n

    def decode(self, stream: bytes, n: int, what: str) -> np.ndarray:
        """The `n` symbols of one Huffman stream; the stream must end exactly
        with the last one."""
        if not stream or stream[-1] == 0:
            raise ZstdError(f"{what}: Huffman stream has no end marker")
        nbits = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
        if n == 0:
            if nbits:
                raise ZstdError(f"{what}: Huffman stream not fully read")
            return np.zeros(0, np.uint8)
        m = self.max_bits
        # the bits in reading order (the bytes backwards, each from its high
        # bit, the end marker and the zeros above it skipped), zeros past
        # the start
        bits = np.zeros(nbits + m, np.uint16)
        skip = 8 * len(stream) - nbits
        bits[:nbits] = np.unpackbits(np.frombuffer(stream, np.uint8)[::-1])[skip:]
        peek = np.zeros(nbits, np.uint16)
        for j in range(m):
            peek <<= 1
            peek |= bits[j:j + nbits]
        # position -> position after its code; every position at or past the
        # end maps to itself
        nxt = np.arange(nbits + m, dtype=np.int32)
        nxt[:nbits] += np.take(self.length, peek)
        # jumps of `step` codes, then the n positions row by row from the
        # starts of `rows` runs of `step` (16 balances the jumps' gathers
        # over every bit against the Python loop over the rows)
        log_step = min(4, n.bit_length() // 2)
        step = 1 << log_step
        jump = nxt
        for _ in range(log_step):
            jump = np.take(jump, jump)
        rows = -(-n // step)
        starts = np.zeros(rows, np.int32)
        c = 0
        for r in range(rows):
            starts[r] = c
            c = jump[c]
        chain = np.empty((step, rows), np.int32)
        chain[0] = starts
        for j in range(1, step):
            chain[j] = np.take(nxt, chain[j - 1])
        positions = chain.T.reshape(-1)[:n]
        last = int(positions[-1])
        if last >= nbits or int(nxt[last]) != nbits:
            raise ZstdError(f"{what}: Huffman stream does not end with its last symbol")
        return self.symbol[peek[positions]]


def _literals(block: bytes, state: "_FrameState", what: str) -> tuple[bytes, int]:
    """`(literals, bytes of the literals section)` of a compressed block."""
    if not block:
        raise ZstdError(f"{what}: empty compressed block")
    b0 = block[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        head = (1, 2, 1, 3)[size_format]
        if head > len(block):
            raise ZstdError(f"{what}: literals header truncated")
        regen = b0 >> 3 if head == 1 else int.from_bytes(block[:head], "little") >> 4
        if regen > BLOCK_MAX:
            raise ZstdError(f"{what}: literals too large")
        if kind == 0:
            if head + regen > len(block):
                raise ZstdError(f"{what}: raw literals truncated")
            return bytes(block[head:head + regen]), head + regen
        if head >= len(block):
            raise ZstdError(f"{what}: RLE literal missing")
        return bytes([block[head]]) * regen, head + 1
    # Huffman-coded: compressed (with its tree) or treeless (the previous tree)
    head = (3, 3, 4, 5)[size_format]
    if head > len(block):
        raise ZstdError(f"{what}: literals header truncated")
    v = int.from_bytes(block[:head], "little") >> 4
    bits = (10, 10, 14, 18)[size_format]
    regen, comp = v & ((1 << bits) - 1), v >> bits
    streams = 1 if size_format == 0 else 4
    end = head + comp
    if end > len(block) or regen > BLOCK_MAX:
        raise ZstdError(f"{what}: Huffman literals truncated or too large")
    pos = head
    if kind == 2:
        weights, pos = _huffman_weights(block[:end], pos, what)
        state.huffman = _HuffmanTable(weights)
    elif state.huffman is None:
        raise ZstdError(f"{what}: treeless literals without a previous Huffman tree")
    table = state.huffman
    if streams == 1:
        return table.decode(bytes(block[pos:end]), regen, what).tobytes(), end
    if pos + 6 > end:
        raise ZstdError(f"{what}: literals jump table truncated")
    sizes = [int.from_bytes(block[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    pos += 6
    sizes.append(end - pos - sum(sizes))
    seg = (regen + 3) // 4
    counts = [seg, seg, seg, regen - 3 * seg]
    if sizes[3] < 1 or counts[3] < 0:
        raise ZstdError(f"{what}: literal streams do not fit their section")
    out = []
    for size, count in zip(sizes, counts):
        out.append(table.decode(bytes(block[pos:pos + size]), count, what))
        pos += size
    return np.concatenate(out).tobytes(), end


# ------------------------------------------------------------------ sequences

class _FrameState:
    """What a frame's blocks carry over: the Huffman tree, the last
    sequence tables and the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[_HuffmanTable] = None
        self.tables: list = [None, None, None]  # literal length, offset, match length
        self.rep = [1, 4, 8]


def _sequence_tables(block: bytes, pos: int, modes: int, state: _FrameState,
                     what: str) -> int:
    for i, shift in enumerate((6, 4, 2)):
        mode = (modes >> shift) & 3
        max_symbol, max_log = SEQ_LIMITS[i]
        if mode == 0:
            state.tables[i] = _PREDEFINED[i]
        elif mode == 1:
            if pos >= len(block):
                raise ZstdError(f"{what}: RLE sequence symbol missing")
            if block[pos] > max_symbol:
                raise ZstdError(f"{what}: RLE sequence symbol out of range")
            state.tables[i] = _rle_table(block[pos])
            pos += 1
        elif mode == 2:
            counts, log, used = _read_fse_description(bytes(block[pos:]), max_symbol,
                                                      max_log, what)
            state.tables[i] = _fse_table(counts, log, what)
            pos += used
        elif state.tables[i] is None:
            raise ZstdError(f"{what}: repeated sequence table without a previous one")
    return pos


def _sequences(block: bytes, pos: int, state: _FrameState, what: str) -> list:
    """The `(literal length, match length, offset)` of every sequence."""
    if pos >= len(block):
        raise ZstdError(f"{what}: sequences section missing")
    b0 = block[pos]
    if b0 == 0:
        if pos + 1 != len(block):
            raise ZstdError(f"{what}: bytes after an empty sequences section")
        return []
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > len(block):
            raise ZstdError(f"{what}: sequence count truncated")
        count, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        if pos + 3 > len(block):
            raise ZstdError(f"{what}: sequence count truncated")
        count, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= len(block):
        raise ZstdError(f"{what}: sequence modes missing")
    modes = block[pos]
    if modes & 3:
        raise ZstdError(f"{what}: reserved bits of the sequence modes set")
    pos = _sequence_tables(block, pos + 1, modes, state, what)
    stream = _BackwardBits(bytes(block[pos:]), what)
    (ll_sym, ll_bits, ll_base), (of_sym, of_bits, of_base), (ml_sym, ml_bits, ml_base) = \
        state.tables
    ll_state = stream.read(len(ll_sym).bit_length() - 1)
    of_state = stream.read(len(of_sym).bit_length() - 1)
    ml_state = stream.read(len(ml_sym).bit_length() - 1)
    rep = state.rep
    out = []
    read = stream.read
    for i in range(count):
        of_code, ml_code, ll_code = of_sym[of_state], ml_sym[ml_state], ll_sym[ll_state]
        if of_code > MAX_OFFSET_CODE:
            raise ZstdError(f"{what}: offset code {of_code} out of range")
        offset_value = (1 << of_code) + read(of_code)
        ml_base_v, ml_extra = ML_CODES[ml_code]
        match = ml_base_v + read(ml_extra)
        ll_base_v, ll_extra = LL_CODES[ll_code]
        lit = ll_base_v + read(ll_extra)
        if offset_value > 3:
            offset = offset_value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = offset_value - 1 + (lit == 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 3:
                offset = rep[0] - 1
                if offset == 0:
                    raise ZstdError(f"{what}: repeat offset of 0")
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            else:
                offset = rep[idx]
                if idx == 2:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
        out.append((lit, match, offset))
        if i + 1 < count:
            ll_state = ll_base[ll_state] + read(ll_bits[ll_state])
            ml_state = ml_base[ml_state] + read(ml_bits[ml_state])
            of_state = of_base[of_state] + read(of_bits[of_state])
        if stream.pos < 0:
            raise ZstdError(f"{what}: sequence bitstream overrun")
    if stream.pos != 0:
        raise ZstdError(f"{what}: sequence bitstream not fully read")
    return out


def _compressed_block(block: bytes, out: bytearray, frame_start: int,
                      state: _FrameState, what: str) -> None:
    literals, pos = _literals(block, state, what)
    seqs = _sequences(block, pos, state, what)
    start = len(out)
    lit_pos = 0
    for lit, match, offset in seqs:
        if lit_pos + lit > len(literals):
            raise ZstdError(f"{what}: sequence takes more literals than the block has")
        out += literals[lit_pos:lit_pos + lit]
        lit_pos += lit
        src = len(out) - offset
        if src < frame_start:
            raise ZstdError(f"{what}: match offset {offset} before the frame's start")
        if offset >= match:
            out += out[src:src + match]
        else:  # overlapping copy: the last `offset` bytes repeated
            pattern = bytes(out[src:])
            out += (pattern * (match // offset + 1))[:match]
        if len(out) - start > BLOCK_MAX:
            raise ZstdError(f"{what}: block decodes to more than {BLOCK_MAX} bytes")
    out += literals[lit_pos:]
    if len(out) - start > BLOCK_MAX:
        raise ZstdError(f"{what}: block decodes to more than {BLOCK_MAX} bytes")


# ---------------------------------------------------------------------- XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & MASK64
    return (((acc << 31) | (acc >> 33)) & MASK64) * _P1 & MASK64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of `data` (the checksum zstd frames carry)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & MASK64, (seed + _P2) & MASK64, seed, (seed - _P1) & MASK64]
        lanes = np.frombuffer(data, "<u8", count=(n // 32) * 4).reshape(-1, 4).tolist()
        v1, v2, v3, v4 = v
        for a, b, c, d in lanes:
            v1 = _round(v1, a)
            v2 = _round(v2, b)
            v3 = _round(v3, c)
            v4 = _round(v4, d)
        pos = (n // 32) * 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57)) + ((v3 << 12) | (v3 >> 52))
             + ((v4 << 18) | (v4 >> 46))) & MASK64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & MASK64
    else:
        h = (seed + _P5) & MASK64
    h = (h + n) & MASK64
    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h = ((((h << 27) | (h >> 37)) & MASK64) * _P1 + _P4) & MASK64
        pos += 8
    if pos + 4 <= n:
        h ^= int.from_bytes(data[pos:pos + 4], "little") * _P1 & MASK64
        h = ((((h << 23) | (h >> 41)) & MASK64) * _P2 + _P3) & MASK64
        pos += 4
    while pos < n:
        h ^= data[pos] * _P5 & MASK64
        h = ((((h << 11) | (h >> 53)) & MASK64) * _P1) & MASK64
        pos += 1
    h ^= h >> 33
    h = h * _P2 & MASK64
    h ^= h >> 29
    h = h * _P3 & MASK64
    return h ^ (h >> 32)


# --------------------------------------------------------------------- frames

def _frame(data: bytes, pos: int, out: bytearray, what: str) -> int:
    """Decode the frame at `pos` (after its magic) onto `out`; returns the
    position after it."""
    if pos >= len(data):
        raise ZstdError(f"{what}: frame header truncated")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError(f"{what}: reserved bit of the frame header set")
    if not single:
        pos += 1  # the window descriptor: the whole output is kept, so no limit applies
    did_size = (0, 1, 2, 4)[did_flag]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + did_size + fcs_size > len(data):
        raise ZstdError(f"{what}: frame header truncated")
    if did_size and int.from_bytes(data[pos:pos + did_size], "little"):
        raise ZstdError(f"{what}: frame needs a dictionary")
    pos += did_size
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little")
        content_size += 256 if fcs_size == 2 else 0
        pos += fcs_size
    start = len(out)
    state = _FrameState()
    while True:
        if pos + 3 > len(data):
            raise ZstdError(f"{what}: block header truncated")
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if kind == 1:  # RLE: one byte, `size` times
            if pos + 1 > len(data) or size > BLOCK_MAX:
                raise ZstdError(f"{what}: RLE block truncated or too large")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if kind == 3:
                raise ZstdError(f"{what}: reserved block type")
            if pos + size > len(data) or size > BLOCK_MAX:
                raise ZstdError(f"{what}: block truncated or too large")
            if kind == 0:
                out += data[pos:pos + size]
            else:
                _compressed_block(memoryview(data)[pos:pos + size], out, start, state, what)
            pos += size
        if content_size is not None and len(out) - start > content_size:
            raise ZstdError(f"{what}: frame decodes past its content size")
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError(f"{what}: frame decodes to {len(out) - start} bytes, its header "
                        f"says {content_size}")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError(f"{what}: content checksum truncated")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError(f"{what}: content checksum does not match")
        pos += 4
    return pos


def decompress(data: bytes, what: str = "zstd") -> bytes:
    """The content of the zstd frames in `data`, in order (skippable frames
    skipped). `what` names the data in errors."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError(f"{what}: no zstd frame")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError(f"{what}: truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic == FRAME_MAGIC:
            pos = _frame(data, pos, out, what)
        elif magic & ~0xF == SKIPPABLE_MAGIC:
            if pos + 4 > len(data):
                raise ZstdError(f"{what}: skippable frame truncated")
            size = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4 + size
            if pos > len(data):
                raise ZstdError(f"{what}: skippable frame truncated")
        else:
            raise ZstdError(f"{what}: not a zstd frame (magic {magic:#010x})")
    return bytes(out)


def decompress_compiled(data: bytes, what: str = "zstd",
                        lib: Optional[ctypes.CDLL] = None) -> bytes:
    """`decompress(data)` by the compiled host code (`yp_zstd_decompress` of
    `lib`, by default the kernel library, which is built if it must be).
    The output buffer grows until the content fits. Raises `ZstdError` as
    `decompress` does, and where the library cannot be built."""
    if lib is None:
        from yolopoint_tpu_torch.ops import _build

        lib = _build.library()
    src = np.frombuffer(bytes(data), np.uint8)
    capacity = max(1 << 16, 4 * src.size)
    written = ctypes.c_int64(0)
    message = ctypes.create_string_buffer(160)
    while True:
        dst = np.empty(max(capacity, 1), np.uint8)
        code = lib.yp_zstd_decompress(ctypes.c_void_p(src.ctypes.data), src.size,
                                      ctypes.c_void_p(dst.ctypes.data), capacity,
                                      ctypes.byref(written), message, len(message))
        if code == 1:
            capacity *= 2
            continue
        if code != 0:
            raise ZstdError(f"{what}: {message.value.decode()}")
        return dst[:written.value].tobytes()
