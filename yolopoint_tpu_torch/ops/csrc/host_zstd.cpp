// Host code of the port's checkpoint reader, compiled with the CUDA kernels
// (the same build, the same shared library) and called through ctypes:
//
// * `yp_zstd_decompress`: Zstandard frames (RFC 8878) laid end to end,
//   skippable frames skipped; raw, RLE and compressed blocks; raw, RLE and
//   Huffman literals (direct or FSE weights, one or four streams, treeless);
//   predefined, RLE, FSE and repeated sequence tables with the three repeat
//   offsets; the XXH64 content checksum; no dictionary. A malformed frame
//   returns -1 with a message and no output is to be used.
// * `yp_crc32c`: CRC-32C (Castagnoli), which ends every OCDBT manifest and
//   B-tree node.
//
// The same algorithm as the plain Python versions, `utils/zstd.py` and
// `utils/crc32c.py` (the CPU's path), which the tests hold this file to.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct ZstdFail {
  char text[128];
};

[[noreturn]] void fail(const char* fmt, long long a = 0, long long b = 0) {
  ZstdFail f;
  std::snprintf(f.text, sizeof(f.text), fmt, a, b);
  throw f;
}

struct OutputFull {};

constexpr int64_t kBlockMax = 1 << 17;
constexpr int kHuffmanMaxBits = 11;
constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

// The backward bitstream of Huffman streams, weights and sequences: `pos`
// bits remain under the end marker; bits below the start read as zeros and
// leave `pos` negative. The stream is copied behind 8 zero bytes, so that a
// read of up to 57 bits is one unaligned 8-byte load and a shift.
struct BackBits {
  std::vector<uint8_t> buf;
  int64_t pos;
  BackBits(const uint8_t* d, int64_t n) {
    if (n <= 0 || d[n - 1] == 0) fail("bitstream has no end marker");
    pos = 8 * (n - 1) + highbit(d[n - 1]);
    buf.assign(8, 0);
    buf.insert(buf.end(), d, d + n);
  }
  uint64_t peek(int nb) const {
    if (nb == 0 || pos <= 0) return 0;
    // the 8 bytes that end with the byte holding bit pos - 1: bits
    // [8 * (e - 7), 8 * (e + 1)) of the stream, e + 1 in the padded copy
    int64_t e = (pos - 1) >> 3;
    uint64_t w;
    std::memcpy(&w, buf.data() + e + 1, 8);
    return (w >> (pos - nb - 8 * (e - 7))) & ((1ull << nb) - 1);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

struct FseTable {
  std::vector<uint8_t> symbol, bits;
  std::vector<uint16_t> base;
  int log = 0;
};

// An FSE table description read forward from `data` (RFC 8878 4.1.1): the
// normalized counts and the accuracy log; returns the bytes read.
int64_t read_fse_description(const uint8_t* data, int64_t n, int max_symbol, int max_log,
                             std::vector<int>& counts, int& log) {
  int64_t total_bits = 8 * n;
  auto bits_at = [&](int64_t pos, int nb) -> uint64_t {
    uint64_t v = 0;
    for (int i = 0; i < nb; ++i) {
      int64_t p = pos + i;
      if (p < total_bits && (data[p >> 3] >> (p & 7)) & 1) v |= 1ull << i;
    }
    return v;
  };
  int64_t pos = 4;
  log = static_cast<int>(bits_at(0, 4)) + 5;
  if (log > max_log) fail("FSE accuracy log %lld over %lld", log, max_log);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  counts.clear();
  while (remaining > 1) {
    if (static_cast<int>(counts.size()) > max_symbol)
      fail("FSE description past symbol %lld", max_symbol);
    uint64_t v = bits_at(pos, nbits);
    int limit = (2 * threshold - 1) - remaining;
    int low = static_cast<int>(v & (threshold - 1));
    int count;
    if (low < limit) {
      count = low;
      pos += nbits - 1;
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= limit;
      pos += nbits;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    if (count == 0) {
      for (;;) {
        int repeat = static_cast<int>(bits_at(pos, 2));
        pos += 2;
        for (int i = 0; i < repeat; ++i) counts.push_back(0);
        if (repeat != 3) break;
        if (static_cast<int>(counts.size()) > 1024) fail("FSE description: too many zeros");
      }
    }
    while (remaining < threshold && threshold > 1) {
      nbits -= 1;
      threshold >>= 1;
    }
    if (pos > total_bits) fail("FSE description truncated");
  }
  if (remaining != 1 || static_cast<int>(counts.size()) > max_symbol + 1)
    fail("FSE description is inconsistent");
  return (pos + 7) >> 3;
}

void build_fse(const std::vector<int>& counts, int log, FseTable& t) {
  int size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<int> next(counts.size());
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      t.symbol[high--] = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = counts[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, pos = 0;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      t.symbol[pos] = static_cast<uint8_t>(s);
      pos = (pos + step) & (size - 1);
      while (pos > high) pos = (pos + step) & (size - 1);
    }
  }
  if (pos != 0) fail("FSE counts do not fill the table");
  for (int state = 0; state < size; ++state) {
    int s = t.symbol[state];
    int nx = next[s]++;
    int nb = log - highbit(static_cast<uint32_t>(nx));
    t.bits[state] = static_cast<uint8_t>(nb);
    t.base[state] = static_cast<uint16_t>((nx << nb) - size);
  }
}

void rle_fse(int symbol, FseTable& t) {
  t.log = 0;
  t.symbol.assign(1, static_cast<uint8_t>(symbol));
  t.bits.assign(1, 0);
  t.base.assign(1, 0);
}

const int kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
int ml_default(int s) { return s == 0 ? 1 : s == 1 ? 4 : s == 2 ? 3 : s < 9 ? 2 : s < 46 ? 1 : -1; }

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28,  32,  40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLExtra[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                              1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLExtra[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                              2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Huffman {
  bool ready = false;
  int max_bits = 0;
  std::vector<uint8_t> symbol, length;
};

// The weights of a Huffman tree description at `pos`; returns the position
// after it.
int64_t huffman_weights(const uint8_t* data, int64_t n, int64_t pos, std::vector<int>& weights) {
  if (pos >= n) fail("Huffman tree description truncated");
  int header = data[pos++];
  weights.clear();
  if (header >= 128) {
    int count = header - 127;
    int64_t end = pos + (count + 1) / 2;
    if (end > n) fail("Huffman weights truncated");
    for (int i = 0; i < count; ++i)
      weights.push_back(i % 2 == 0 ? data[pos + i / 2] >> 4 : data[pos + i / 2] & 15);
    pos = end;
  } else {
    int64_t end = pos + header;
    if (header == 0 || end > n) fail("Huffman weights truncated");
    std::vector<int> counts;
    int log;
    int64_t used = read_fse_description(data + pos, header, 255, 6, counts, log);
    if (used >= header) fail("Huffman weight stream missing");
    FseTable t;
    build_fse(counts, log, t);
    BackBits stream(data + pos + used, header - used);
    int states[2];
    states[0] = static_cast<int>(stream.read(log));
    states[1] = static_cast<int>(stream.read(log));
    int i = 0;
    for (;;) {
      if (weights.size() > 254) fail("too many Huffman weights");
      int st = states[i];
      weights.push_back(t.symbol[st]);
      states[i] = t.base[st] + static_cast<int>(stream.read(t.bits[st]));
      if (stream.pos < 0) {
        weights.push_back(t.symbol[states[1 - i]]);
        break;
      }
      i = 1 - i;
    }
    pos = end;
  }
  int64_t total = 0;
  for (int w : weights) {
    if (w > kHuffmanMaxBits + 1) fail("Huffman weight out of range");
    if (w) total += int64_t{1} << (w - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highbit(static_cast<uint32_t>(total)) + 1;
  int64_t left = (int64_t{1} << max_bits) - total;
  if (max_bits > kHuffmanMaxBits || (left & (left - 1)))
    fail("Huffman weights do not make a prefix code");
  weights.push_back(highbit(static_cast<uint32_t>(left)) + 1);
  if (weights.size() > 256) fail("too many Huffman weights");
  return pos;
}

void build_huffman(const std::vector<int>& weights, Huffman& h) {
  int64_t total = 0;
  for (int w : weights)
    if (w) total += int64_t{1} << (w - 1);
  h.max_bits = highbit(static_cast<uint32_t>(total));
  int size = 1 << h.max_bits;
  h.symbol.assign(size, 0);
  h.length.assign(size, 0);
  int pos = 0;
  for (int w = 1; w <= h.max_bits; ++w) {
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] != w) continue;
      int n = 1 << (w - 1);
      for (int k = 0; k < n; ++k) {
        h.symbol[pos + k] = static_cast<uint8_t>(s);
        h.length[pos + k] = static_cast<uint8_t>(h.max_bits + 1 - w);
      }
      pos += n;
    }
  }
  h.ready = true;
}

// The `count[s]` symbols of each of `k` Huffman streams (1 or 4), stream s
// into `out[s]`, decoded in turns so that the streams' chains of dependent
// loads overlap; each stream must end exactly with its last symbol.
// BackBits::peek is inlined on locals: the stores to `out` may alias
// anything, so members would be reloaded every symbol.
void huffman_streams(const Huffman& h, int k, const uint8_t* const* data, const int64_t* n,
                     const int64_t* count, uint8_t* const* out) {
  std::vector<BackBits> bits;
  const uint8_t* buf[4];
  int64_t pos[4];
  int64_t common = count[0];
  for (int s = 0; s < k; ++s) {
    bits.emplace_back(data[s], n[s]);
    common = count[s] < common ? count[s] : common;
  }
  for (int s = 0; s < k; ++s) {
    buf[s] = bits[s].buf.data();
    pos[s] = bits[s].pos;
  }
  const uint8_t* symbol = h.symbol.data();
  const uint8_t* length = h.length.data();
  const int m = h.max_bits;
  const uint64_t mask = (1ull << m) - 1;
  auto one = [&](int s, int64_t i) {
    if (pos[s] <= 0) fail("Huffman stream does not end with its last symbol");
    int64_t e = (pos[s] - 1) >> 3;
    uint64_t w;
    std::memcpy(&w, buf[s] + e + 1, 8);
    uint64_t idx = (w >> (pos[s] - m - 8 * (e - 7))) & mask;
    out[s][i] = symbol[idx];
    pos[s] -= length[idx];
  };
  int64_t i = 0;
  if (k == 4) {
    for (; i < common; ++i) {
      one(0, i);
      one(1, i);
      one(2, i);
      one(3, i);
    }
  }
  for (int s = 0; s < k; ++s) {
    for (int64_t j = i; j < count[s]; ++j) one(s, j);
    if (pos[s] != 0) fail("Huffman stream does not end with its last symbol");
  }
}

struct FrameState {
  Huffman huffman;
  FseTable tables[3];  // literal length, offset, match length
  bool have[3] = {false, false, false};
  uint32_t rep[3] = {1, 4, 8};
};

// The literals of a compressed block; returns the bytes of its section.
int64_t literals(const uint8_t* block, int64_t n, FrameState& st, std::vector<uint8_t>& lit) {
  if (n < 1) fail("empty compressed block");
  int b0 = block[0], kind = b0 & 3, size_format = (b0 >> 2) & 3;
  if (kind <= 1) {
    static const int heads[4] = {1, 2, 1, 3};
    int head = heads[size_format];
    if (head > n) fail("literals header truncated");
    int64_t regen = head == 1 ? b0 >> 3 : static_cast<int64_t>(le(block, head) >> 4);
    if (regen > kBlockMax) fail("literals too large");
    if (kind == 0) {
      if (head + regen > n) fail("raw literals truncated");
      lit.assign(block + head, block + head + regen);
      return head + regen;
    }
    if (head >= n) fail("RLE literal missing");
    lit.assign(regen, block[head]);
    return head + 1;
  }
  static const int heads[4] = {3, 3, 4, 5};
  static const int widths[4] = {10, 10, 14, 18};
  int head = heads[size_format];
  if (head > n) fail("literals header truncated");
  uint64_t v = le(block, head) >> 4;
  int w = widths[size_format];
  int64_t regen = static_cast<int64_t>(v & ((1ull << w) - 1));
  int64_t comp = static_cast<int64_t>(v >> w);
  int streams = size_format == 0 ? 1 : 4;
  int64_t end = head + comp;
  if (end > n || regen > kBlockMax) fail("Huffman literals truncated or too large");
  int64_t pos = head;
  if (kind == 2) {
    std::vector<int> weights;
    pos = huffman_weights(block, end, pos, weights);
    build_huffman(weights, st.huffman);
  } else if (!st.huffman.ready) {
    fail("treeless literals without a previous Huffman tree");
  }
  lit.resize(regen);
  if (streams == 1) {
    const uint8_t* data[1] = {block + pos};
    int64_t size[1] = {end - pos}, count[1] = {regen};
    uint8_t* out[1] = {lit.data()};
    huffman_streams(st.huffman, 1, data, size, count, out);
    return end;
  }
  if (pos + 6 > end) fail("literals jump table truncated");
  int64_t sizes[4];
  for (int i = 0; i < 3; ++i) sizes[i] = static_cast<int64_t>(le(block + pos + 2 * i, 2));
  pos += 6;
  sizes[3] = end - pos - sizes[0] - sizes[1] - sizes[2];
  int64_t seg = (regen + 3) / 4;
  int64_t counts[4] = {seg, seg, seg, regen - 3 * seg};
  if (sizes[3] < 1 || counts[3] < 0) fail("literal streams do not fit their section");
  const uint8_t* data[4];
  uint8_t* out[4];
  int64_t written = 0;
  for (int i = 0; i < 4; ++i) {
    if (sizes[i] < 0 || pos + sizes[i] > end) fail("literal streams do not fit their section");
    data[i] = block + pos;
    out[i] = lit.data() + written;
    pos += sizes[i];
    written += counts[i];
  }
  huffman_streams(st.huffman, 4, data, sizes, counts, out);
  return end;
}

struct Output {
  uint8_t* dst;
  int64_t cap;
  int64_t n = 0;
  void reserve(int64_t k) {
    if (n + k > cap) throw OutputFull{};
  }
  void put(const uint8_t* p, int64_t k) {
    reserve(k);
    std::memcpy(dst + n, p, k);
    n += k;
  }
  void fill(uint8_t b, int64_t k) {
    reserve(k);
    std::memset(dst + n, b, k);
    n += k;
  }
};

void compressed_block(const uint8_t* block, int64_t n, Output& out, int64_t frame_start,
                      FrameState& st) {
  std::vector<uint8_t> lit;
  int64_t pos = literals(block, n, st, lit);
  if (pos >= n) fail("sequences section missing");
  int b0 = block[pos];
  int64_t count;
  if (b0 == 0) {
    if (pos + 1 != n) fail("bytes after an empty sequences section");
    count = 0;
    pos += 1;
  } else if (b0 < 128) {
    count = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > n) fail("sequence count truncated");
    count = ((b0 - 128) << 8) + block[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("sequence count truncated");
    count = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  int64_t start = out.n, lit_pos = 0;
  if (count) {
    if (pos >= n) fail("sequence modes missing");
    int modes = block[pos++];
    if (modes & 3) fail("reserved bits of the sequence modes set");
    static const int max_symbol[3] = {35, 31, 52}, max_log[3] = {9, 8, 9};
    for (int i = 0; i < 3; ++i) {
      int mode = (modes >> (6 - 2 * i)) & 3;
      if (mode == 0) {
        std::vector<int> counts;
        if (i == 0) counts.assign(kLLDefault, kLLDefault + 36);
        if (i == 1) counts.assign(kOFDefault, kOFDefault + 29);
        if (i == 2)
          for (int s = 0; s < 53; ++s) counts.push_back(ml_default(s));
        build_fse(counts, i == 1 ? 5 : 6, st.tables[i]);
      } else if (mode == 1) {
        if (pos >= n) fail("RLE sequence symbol missing");
        if (block[pos] > max_symbol[i]) fail("RLE sequence symbol out of range");
        rle_fse(block[pos++], st.tables[i]);
      } else if (mode == 2) {
        std::vector<int> counts;
        int log;
        pos += read_fse_description(block + pos, n - pos, max_symbol[i], max_log[i], counts, log);
        build_fse(counts, log, st.tables[i]);
      } else if (!st.have[i]) {
        fail("repeated sequence table without a previous one");
      }
      st.have[i] = true;
    }
    BackBits bits(block + pos, n - pos);
    const FseTable &ll = st.tables[0], &of = st.tables[1], &ml = st.tables[2];
    int ll_state = static_cast<int>(bits.read(ll.log));
    int of_state = static_cast<int>(bits.read(of.log));
    int ml_state = static_cast<int>(bits.read(ml.log));
    uint32_t* rep = st.rep;
    for (int64_t i = 0; i < count; ++i) {
      int of_code = of.symbol[of_state], ml_code = ml.symbol[ml_state];
      int ll_code = ll.symbol[ll_state];
      if (of_code > 31) fail("offset code %lld out of range", of_code);
      uint64_t offset_value = (1ull << of_code) + bits.read(of_code);
      int64_t match = kMLBase[ml_code] + static_cast<int64_t>(bits.read(kMLExtra[ml_code]));
      int64_t litlen = kLLBase[ll_code] + static_cast<int64_t>(bits.read(kLLExtra[ll_code]));
      uint64_t offset;
      if (offset_value > 3) {
        offset = offset_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = static_cast<uint32_t>(offset);
      } else {
        int idx = static_cast<int>(offset_value) - 1 + (litlen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else if (idx == 3) {
          offset = rep[0] - 1;
          if (offset == 0) fail("repeat offset of 0");
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        } else {
          offset = rep[idx];
          if (idx == 2) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        }
      }
      if (lit_pos + litlen > static_cast<int64_t>(lit.size()))
        fail("sequence takes more literals than the block has");
      out.put(lit.data() + lit_pos, litlen);
      lit_pos += litlen;
      if (static_cast<int64_t>(offset) > out.n - frame_start)
        fail("match offset %lld before the frame's start", static_cast<long long>(offset));
      out.reserve(match);
      uint8_t* d = out.dst + out.n;
      const uint8_t* s = d - offset;
      for (int64_t k = 0; k < match; ++k) d[k] = s[k];
      out.n += match;
      if (out.n - start > kBlockMax) fail("block decodes to more than %lld bytes", kBlockMax);
      if (i + 1 < count) {
        ll_state = ll.base[ll_state] + static_cast<int>(bits.read(ll.bits[ll_state]));
        ml_state = ml.base[ml_state] + static_cast<int>(bits.read(ml.bits[ml_state]));
        of_state = of.base[of_state] + static_cast<int>(bits.read(of.bits[of_state]));
      }
      if (bits.pos < 0) fail("sequence bitstream overrun");
    }
    if (bits.pos != 0) fail("sequence bitstream not fully read");
  }
  out.put(lit.data() + lit_pos, static_cast<int64_t>(lit.size()) - lit_pos);
  if (out.n - start > kBlockMax) fail("block decodes to more than %lld bytes", kBlockMax);
}

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t xxh_round(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, int64_t n) {
  int64_t pos = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; pos + 32 <= n; pos += 32) {
      v1 = xxh_round(v1, le(p + pos, 8));
      v2 = xxh_round(v2, le(p + pos + 8, 8));
      v3 = xxh_round(v3, le(p + pos + 16, 8));
      v4 = xxh_round(v4, le(p + pos + 24, 8));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xxh_round(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  for (; pos + 8 <= n; pos += 8) h = rotl(h ^ xxh_round(0, le(p + pos, 8)), 27) * P1 + P4;
  if (pos + 4 <= n) {
    h = rotl(h ^ (le(p + pos, 4) * P1), 23) * P2 + P3;
    pos += 4;
  }
  for (; pos < n; ++pos) h = rotl(h ^ (p[pos] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

int64_t frame(const uint8_t* data, int64_t n, int64_t pos, Output& out) {
  if (pos >= n) fail("frame header truncated");
  int fhd = data[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit of the frame header set");
  if (!single) pos += 1;  // window descriptor: the whole output is kept
  static const int did_sizes[4] = {0, 1, 2, 4};
  int did_size = did_sizes[did_flag];
  int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + did_size + fcs_size > n) fail("frame header truncated");
  if (did_size && le(data + pos, did_size)) fail("frame needs a dictionary");
  pos += did_size;
  bool has_size = fcs_size > 0;
  uint64_t content_size = 0;
  if (has_size) {
    content_size = le(data + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
    pos += fcs_size;
  }
  int64_t start = out.n;
  FrameState st;
  for (;;) {
    if (pos + 3 > n) fail("block header truncated");
    uint32_t header = static_cast<uint32_t>(le(data + pos, 3));
    pos += 3;
    int last = header & 1, kind = (header >> 1) & 3;
    int64_t size = header >> 3;
    if (kind == 1) {
      if (pos + 1 > n || size > kBlockMax) fail("RLE block truncated or too large");
      out.fill(data[pos], size);
      pos += 1;
    } else {
      if (kind == 3) fail("reserved block type");
      if (pos + size > n || size > kBlockMax) fail("block truncated or too large");
      if (kind == 0)
        out.put(data + pos, size);
      else
        compressed_block(data + pos, size, out, start, st);
      pos += size;
    }
    if (has_size && static_cast<uint64_t>(out.n - start) > content_size)
      fail("frame decodes past its content size");
    if (last) break;
  }
  if (has_size && static_cast<uint64_t>(out.n - start) != content_size)
    fail("frame decodes to %lld bytes, its header says %lld", out.n - start,
         static_cast<long long>(content_size));
  if (checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    uint32_t want = static_cast<uint32_t>(le(data + pos, 4));
    if (static_cast<uint32_t>(xxh64(out.dst + start, out.n - start)) != want)
      fail("content checksum does not match");
    pos += 4;
  }
  return pos;
}

struct CrcTable {
  uint32_t entry[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      entry[i] = c;
    }
  }
};

}  // namespace

extern "C" {

// The content of the zstd frames in `src`, written to `dst` (at most
// `capacity` bytes), its length to `*written`. Returns 0, 1 where the
// content does not fit in `capacity`, or -1 for a malformed frame, its
// reason in `message`.
int yp_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t capacity,
                       int64_t* written, char* message, int message_len) {
  Output out{dst, capacity};
  *written = 0;
  try {
    if (n <= 0) fail("no zstd frame");
    int64_t pos = 0;
    while (pos < n) {
      if (pos + 4 > n) fail("truncated frame magic");
      uint32_t magic = static_cast<uint32_t>(le(src + pos, 4));
      pos += 4;
      if (magic == kFrameMagic) {
        pos = frame(src, n, pos, out);
      } else if ((magic & ~0xFu) == kSkippableMagic) {
        if (pos + 4 > n) fail("skippable frame truncated");
        int64_t size = static_cast<int64_t>(le(src + pos, 4));
        pos += 4 + size;
        if (pos > n) fail("skippable frame truncated");
      } else {
        fail("not a zstd frame (magic %#010llx)", magic);
      }
    }
  } catch (const ZstdFail& f) {
    std::snprintf(message, message_len, "%s", f.text);
    return -1;
  } catch (const OutputFull&) {
    std::snprintf(message, message_len, "content over %lld bytes",
                  static_cast<long long>(capacity));
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(message, message_len, "out of memory");
    return -1;
  }
  *written = out.n;
  return 0;
}

// The CRC-32C of `data`, to `*out`. Returns 0.
int yp_crc32c(const uint8_t* data, int64_t n, uint32_t* out) {
  static const CrcTable table;  // built once, thread-safe
  uint32_t crc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) crc = table.entry[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  *out = crc ^ 0xFFFFFFFFu;
  return 0;
}

}  // extern "C"
