// Host code of the port's video reader, compiled with the CUDA kernels (the
// same build, the same shared library) and called through ctypes:
//
// * `yp_yuv_to_bgr`: libswscale's conversions of decoded frames to bgr24 as
//   cv2 runs them (the x86 SIMD unscaled routine for 4:2:0 / 4:2:2, the
//   full-chroma output of the scaled path for 4:4:4, grey copied).
// * `yp_mjpeg_idct`: FFmpeg's mjpeg dequantization (DC plus 1024) and
//   simple IDCT of a component's blocks.
// * `yp_mpeg4_decode_vop`: one MPEG-4 Part 2 VOP's macroblocks as FFmpeg
//   decodes them (VLC parse, DC/AC prediction, dequantization, motion
//   vectors, half-pel motion compensation, simple IDCT put / add).
//
// The same integers as the Python and numpy versions, `data/yuv.py`,
// `data/idct_ff.py`, `data/mjpeg.py` and `data/mpeg4video.py` (the CPU's
// path), which the tests hold this file to; their docstrings name the FFmpeg
// functions each step follows.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---- FFmpeg's simple IDCT (8-bit, int16 coefficients) --------------------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;

inline uint8_t clip_u8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// the eight outputs of one pass before its shift (a0 with its rounding), in
// int64: the row pass's results are checked against 16 bits, the column
// pass's wrapped to 32 bits as FFmpeg's int sums wrap
inline void butterfly(const int64_t* x, int64_t a0, int64_t* out) {
  int64_t a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * x[2] + W4 * x[4] + W6 * x[6];
  a1 += W6 * x[2] - W4 * x[4] - W2 * x[6];
  a2 += -W6 * x[2] - W4 * x[4] + W2 * x[6];
  a3 += -W2 * x[2] + W4 * x[4] - W6 * x[6];
  const int64_t b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7];
  const int64_t b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7];
  const int64_t b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7];
  const int64_t b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7];
  out[0] = a0 + b0, out[1] = a1 + b1, out[2] = a2 + b2, out[3] = a3 + b3;
  out[4] = a3 - b3, out[5] = a2 - b2, out[6] = a1 - b1, out[7] = a0 - b0;
}

// A block whose row pass leaves 16 bits: FFmpeg's x86 SIMD IDCT is not
// reproduced there (`data/idct_ff.py`).
struct IdctOverflow {};

inline int16_t row_value(int64_t v) {
  if (v < -32768 || v > 32767) throw IdctOverflow{};
  return static_cast<int16_t>(v);
}

// residual[64] of a block (both passes, before the columns' saturation)
void simple_idct(const int16_t* block, int* residual) {
  int16_t rows[64];
  int64_t xr[8], orow[8];
  for (int r = 0; r < 8; ++r) {
    const int16_t* row = block + 8 * r;
    bool dc_only = true;
    for (int k = 1; k < 8; ++k) dc_only = dc_only && row[k] == 0;
    if (dc_only) {
      const int16_t v = row_value(row[0] * 8);
      for (int k = 0; k < 8; ++k) rows[8 * r + k] = v;
      continue;
    }
    for (int k = 0; k < 8; ++k) xr[k] = row[k];
    butterfly(xr, W4 * xr[0] + (1 << 10), orow);
    for (int k = 0; k < 8; ++k) rows[8 * r + k] = row_value(orow[k] >> 11);
  }
  for (int c = 0; c < 8; ++c) {
    for (int k = 0; k < 8; ++k) xr[k] = rows[8 * k + c];
    butterfly(xr, W4 * (xr[0] + 32), orow);
    for (int k = 0; k < 8; ++k)
      residual[8 * k + c] = static_cast<int32_t>(static_cast<uint32_t>(orow[k])) >> 20;
  }
}

void idct_put(const int16_t* block, uint8_t* dst, int64_t pitch) {
  int r[64];
  simple_idct(block, r);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) dst[y * pitch + x] = clip_u8(r[8 * y + x]);
}

void idct_add(const int16_t* block, uint8_t* dst, int64_t pitch) {
  int r[64];
  simple_idct(block, r);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) dst[y * pitch + x] = clip_u8(dst[y * pitch + x] + r[8 * y + x]);
}

// ---- swscale -------------------------------------------------------------

inline int round16(int64_t c, int shift) { return static_cast<int>((c * (1LL << shift) + 32768) >> 16); }

// ---- MPEG-4 Part 2 --------------------------------------------------------

struct Vlc {
  int bits = 0;
  std::vector<int32_t> sym;  // symbol << 8 | length; length 0: no code
};

Vlc make_vlc(const uint16_t (*codes)[2], int n) {
  Vlc v;
  for (int i = 0; i < n; ++i) v.bits = std::max<int>(v.bits, codes[i][1]);
  v.sym.assign(static_cast<size_t>(1) << v.bits, 0);
  for (int i = 0; i < n; ++i) {
    const int len = codes[i][1];
    if (!len) continue;
    const int base = codes[i][0] << (v.bits - len);
    for (int k = 0; k < (1 << (v.bits - len)); ++k) v.sym[base + k] = (i << 8) | len;
  }
  return v;
}

// the tables of data/mpeg4video.py (FFmpeg's h263data.c / mpeg4data.h)
const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                   {1, 6}, {2, 6}, {3, 6}, {1, 9}};
const uint16_t kInterMcbpc[28][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7},
    {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8},
    {1, 9}, {0, 0}, {0, 0}, {0, 0}, {2, 11}, {12, 13}, {14, 13}, {15, 13}};
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                              {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint16_t kMv[33][2] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                            {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                            {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                            {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                            {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
const uint16_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},  {1, 4},  {1, 5},
                               {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5},  {1, 6},
                                 {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
const uint16_t kInterVlc[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},
    {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},
    {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12}, {0xe, 4},   {0x1d, 8},  {0xe, 10},
    {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12},
    {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},
    {0xa, 10},  {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},
    {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},  {0x22, 11}, {0x23, 11},
    {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
    {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},
    {0x1a, 8},  {0x19, 8},  {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},
    {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},  {0x24, 11},
    {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint16_t kIntraVlc[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},
    {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},
    {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10}, {0xf, 10},  {0xe, 10},  {0x7, 11},
    {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},
    {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11},
    {0x53, 12}, {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},
    {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},  {0x54, 12}, {0x14, 7},
    {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
    {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},
    {0x17, 9},  {0x6, 10},  {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},
    {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},  {0x1a, 8},
    {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11},
    {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}};
const uint8_t kInterRun[102] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
    2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
    2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const uint8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3,  4,  4,  4,  5,  5,  5,
    6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int kInterLast = 58, kIntraLast = 67;
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kQuantTab[4] = {-1, -2, 1, 2};
const uint8_t kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltH[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                           13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                           30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                           46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltV[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                           41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                           51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                           53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// a TCOEF table: VLC (symbol = entry index, 102 = escape), last, run, level,
// and ff_rl_init's max_level[last][run] / max_run[last][level]
struct Rl {
  Vlc vlc;
  int last[103], run[103], level[103];
  int max_level[2][64], max_run[2][65];
};

Rl make_rl(const uint16_t (*codes)[2], const uint8_t* runs, int last_start) {
  Rl rl;
  rl.vlc = make_vlc(codes, 103);
  std::memset(rl.max_level, 0, sizeof(rl.max_level));
  std::memset(rl.max_run, 0, sizeof(rl.max_run));
  int prev_last = -1, prev_run = -1, lv = 0;
  for (int i = 0; i < 102; ++i) {
    const int l = i >= last_start;
    lv = (l == prev_last && runs[i] == prev_run) ? lv + 1 : 1;
    prev_last = l, prev_run = runs[i];
    rl.last[i] = l, rl.run[i] = runs[i], rl.level[i] = lv;
    rl.max_level[l][runs[i]] = std::max(rl.max_level[l][runs[i]], lv);
    rl.max_run[l][lv] = std::max(rl.max_run[l][lv], static_cast<int>(runs[i]));
  }
  return rl;
}

struct Tables {
  Vlc intra_mcbpc = make_vlc(kIntraMcbpc, 9), inter_mcbpc = make_vlc(kInterMcbpc, 28),
      cbpy = make_vlc(kCbpy, 16), mv = make_vlc(kMv, 33), dc_lum = make_vlc(kDcLum, 13),
      dc_chrom = make_vlc(kDcChrom, 13);
  Rl intra = make_rl(kIntraVlc, kIntraRun, kIntraLast),
     inter = make_rl(kInterVlc, kInterRun, kInterLast);
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Error {
  int status;
};

// MSB-first reader; the buffer carries 8 zero bytes past `size` bits
struct Bits {
  const uint8_t* buf;
  int64_t pos, size;
  uint32_t peek(int n) const {
    const int64_t i = pos >> 3;
    uint64_t v = 0;
    for (int k = 0; k < 5; ++k) v = (v << 8) | buf[i + k];
    return static_cast<uint32_t>((v >> (40 - (pos & 7) - n)) & ((1ULL << n) - 1));
  }
  uint32_t read(int n) {
    if (!n) return 0;
    const uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int bit() { return static_cast<int>(read(1)); }
  int vlc(const Vlc& t) {
    if (pos > size + 32) throw Error{2};
    const int32_t e = t.sym[peek(t.bits)];
    if (!(e & 0xFF)) throw Error{2};
    pos += e & 0xFF;
    return e >> 8;
  }
  int xbits(int n) {
    const int v = static_cast<int>(read(n));
    return v >> (n - 1) ? v : v - (1 << n) + 1;
  }
  void align() { pos = (pos + 7) & ~static_cast<int64_t>(7); }
};

inline int16_t i16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int mid3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }
inline int log2i(int v) {
  int r = 0;
  while (v > 1) v >>= 1, ++r;
  return r;
}
inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

enum { kI = 0, kP = 1 };
enum { kSkip = 0, kInter = 1, kInter4v = 2, kIntra = 3 };

// One VOP's parse and reconstruction. Twin: `data/mpeg4video.py` (`_Vop`,
// `_State`, `predict`, `reconstruct`).
struct Vop {
  const Tables& T = tables();
  Bits gb;
  int width, height, kind, rounding, dc_threshold, f_code, mpeg_quant, resync_marker,
      quant_precision, time_bits, hedge, vedge;
  const int32_t* intra_matrix;
  const int32_t* inter_matrix;
  int mbw, mbh, mb_num, s8, sm, qscale = 1, y_dc = 8, c_dc = 8;
  int resync_x = 0, resync_y = 0;
  bool first_line = true;
  std::vector<int> dc[3];
  std::vector<std::array<int, 16>> ac[3];
  std::vector<std::array<int, 2>> mvs;
  std::vector<int> qtab, kinds;
  std::vector<int> mb_mv;        // mbh x mbw x 4 x 2
  std::vector<int16_t> blocks;   // mbh x mbw x 6 x 64

  int luma(int by, int bx) const { return (by + 1) * s8 + bx + 1; }
  int chroma(int y, int x) const { return (y + 1) * sm + x + 1; }
  void index(int n, int mby, int mbx, int* p, int* i, int* wrap) const {
    if (n < 4) {
      *p = 0, *i = luma(2 * mby + (n >> 1), 2 * mbx + (n & 1)), *wrap = s8;
    } else {
      *p = n - 3, *i = chroma(mby, mbx), *wrap = sm;
    }
  }
  void set_qscale(int q) {
    qscale = std::min(std::max(q, 1), 31);
    y_dc = kYDcScale[qscale], c_dc = kCDcScale[qscale];
  }
  int prefix_length() const { return kind == kI ? 16 : f_code + 15; }

  void init() {
    mbw = (width + 15) / 16, mbh = (height + 15) / 16, mb_num = mbw * mbh;
    s8 = 2 * mbw + 1, sm = mbw + 1;
    const size_t n8 = static_cast<size_t>(s8) * (2 * mbh + 4),
                 nm = static_cast<size_t>(sm) * (mbh + 4);
    dc[0].assign(n8, 1024), dc[1].assign(nm, 1024), dc[2].assign(nm, 1024);
    std::array<int, 16> zero{};
    ac[0].assign(n8, zero), ac[1].assign(nm, zero), ac[2].assign(nm, zero);
    mvs.assign(n8, {0, 0});
    qtab.assign(static_cast<size_t>(mb_num), 0);
    kinds.assign(static_cast<size_t>(mb_num), kIntra);
    mb_mv.assign(static_cast<size_t>(mb_num) * 8, 0);
    blocks.assign(static_cast<size_t>(mb_num) * 6 * 64, 0);
  }

  void clean_ac(int mby, int mbx) {
    std::array<int, 16> zero{};
    int start = luma(2 * mby - 1, 2 * mbx - 1);
    for (int i = start; i < start + 2 * s8 + 1; ++i) ac[0][i] = zero;
    start = chroma(mby - 1, mbx - 1);
    for (int p = 1; p < 3; ++p)
      for (int i = start; i < start + sm + 1; ++i) ac[p][i] = zero;
  }
  void clean_intra(int mby, int mbx) {
    std::array<int, 16> zero{};
    for (int n = 0; n < 6; ++n) {
      int p, i, w;
      index(n, mby, mbx, &p, &i, &w);
      dc[p][i] = 1024;
      ac[p][i] = zero;
    }
  }
  void store_mv(int mbx, int mby, const int (*mv)[2]) {
    for (int n = 0; n < 4; ++n) mvs[luma(2 * mby + (n >> 1), 2 * mbx + (n & 1))] = {mv[n][0], mv[n][1]};
  }

  void run() {
    int mbx = 0, mby = 0;
    while (true) {
      slice(&mbx, &mby);
      if (mby >= mbh) return;
      resync(&mbx, &mby);
      clean_ac(mby, mbx);
    }
  }

  void slice(int* px, int* py) {
    int mbx = *px, mby = *py;
    resync_x = mbx, resync_y = mby, first_line = true;
    while (mby < mbh) {
      while (mbx < mbw) {
        if (mbx == resync_x && mby == resync_y + 1) first_line = false;
        macroblock(mbx, mby);
        const int next = resync_marker ? is_resync() : 0;
        if (next && mby * mbw + mbx + 1 >= next) {
          if (++mbx >= mbw) mbx = 0, ++mby;
          *px = mbx, *py = mby;
          return;
        }
        ++mbx;
      }
      mbx = 0, ++mby;
    }
    *px = mbx, *py = mby;
  }

  int is_resync() {
    const int64_t pos = gb.pos;
    uint32_t v = gb.peek(16);
    const int type = kind + 1;
    while (v <= 0xFF) {
      if ((v >> (8 - type)) != 1) break;
      gb.pos += 8 + type;
      v = gb.peek(16);
    }
    const int64_t bits = gb.pos;
    if (bits + 8 >= gb.size) {
      gb.pos = pos;
      v = (v >> 8) | (0x7F >> (7 - (bits & 7)));
      return v == 0x7F ? mb_num : 0;
    }
    static const uint32_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                       0x7000, 0x6000, 0x4000, 0x0000};
    int result = 0;
    if (v == prefix[bits & 7]) {
      gb.pos += 1;
      gb.align();
      int n = 0;
      while (n < 32 && !gb.bit()) ++n;
      int num = static_cast<int>(gb.read(log2i(mb_num - 1) + 1));
      if (!num || num > mb_num || gb.pos + 6 > gb.size) num = -1;
      if (n >= prefix_length()) result = num;
    }
    gb.pos = pos;
    return result;
  }

  void resync(int* px, int* py) {
    gb.bit();
    gb.align();
    int n = 0;
    while (n < 32 && !gb.bit()) ++n;
    if (n != prefix_length()) throw Error{3};
    const int num = static_cast<int>(gb.read(log2i(mb_num - 1) + 1));
    if (num >= mb_num || num == 0) throw Error{3};
    const int q = static_cast<int>(gb.read(quant_precision));
    if (q) set_qscale(q);
    if (gb.bit()) {
      while (gb.bit()) {
      }
      gb.bit();
      gb.read(time_bits);
      gb.bit();
      gb.read(2);
      gb.read(3);
      if (kind != kI) gb.read(3);
    }
    *px = num % mbw, *py = num / mbw;
  }

  void macroblock(int mbx, int mby) {
    const int mb = mby * mbw + mbx;
    int cbpc, dquant, intra;
    const int zero_mv[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    if (kind == kP) {
      while (true) {
        if (gb.bit()) {
          kinds[mb] = kSkip;
          store_mv(mbx, mby, zero_mv);
          clean_intra(mby, mbx);
          qtab[mb] = qscale;
          return;
        }
        cbpc = gb.vlc(T.inter_mcbpc);
        if (cbpc != 20) break;
      }
      dquant = cbpc & 8, intra = cbpc & 4;
    } else {
      do cbpc = gb.vlc(T.intra_mcbpc);
      while (cbpc == 8);
      dquant = cbpc & 4, intra = 4;
    }
    int16_t* blk = blocks.data() + static_cast<size_t>(mb) * 6 * 64;
    if (intra) {
      const int ac_pred = gb.bit();
      const int cbp = (cbpc & 3) | (gb.vlc(T.cbpy) << 2);
      const bool use_dc_vlc = qscale < dc_threshold;
      if (dquant) set_qscale(qscale + kQuantTab[gb.read(2)]);
      qtab[mb] = qscale;
      kinds[mb] = kIntra;
      for (int n = 0; n < 6; ++n)
        intra_block(n, mbx, mby, cbp & (32 >> n), ac_pred, use_dc_vlc, blk + 64 * n);
      if (kind == kP) store_mv(mbx, mby, zero_mv);
      return;
    }
    const int cbp = (cbpc & 3) | ((gb.vlc(T.cbpy) ^ 0xF) << 2);
    if (dquant) set_qscale(qscale + kQuantTab[gb.read(2)]);
    qtab[mb] = qscale;
    int mv[4][2];
    if (cbpc & 16) {
      kinds[mb] = kInter4v;
      for (int n = 0; n < 4; ++n) {
        int px, py;
        pred_motion(mbx, mby, n, &px, &py);
        mv[n][0] = motion(px);
        mv[n][1] = motion(py);
        mvs[luma(2 * mby + (n >> 1), 2 * mbx + (n & 1))] = {mv[n][0], mv[n][1]};
      }
    } else {
      kinds[mb] = kInter;
      int px, py;
      pred_motion(mbx, mby, 0, &px, &py);
      mv[0][0] = motion(px);
      mv[0][1] = motion(py);
      for (int n = 1; n < 4; ++n) mv[n][0] = mv[0][0], mv[n][1] = mv[0][1];
    }
    store_mv(mbx, mby, mv);
    for (int n = 0; n < 4; ++n) mb_mv[mb * 8 + 2 * n] = mv[n][0], mb_mv[mb * 8 + 2 * n + 1] = mv[n][1];
    for (int n = 0; n < 6; ++n)
      if (cbp & (32 >> n)) inter_block(blk + 64 * n);
    clean_intra(mby, mbx);
  }

  void pred_motion(int mbx, int mby, int block, int* px, int* py) {
    const int wrap = s8;
    const int xy = luma(2 * mby + (block >> 1), 2 * mbx + (block & 1));
    static const int off[4] = {2, 1, 1, -1};
    auto& a = mvs[xy - 1];
    if (first_line && block < 3) {
      if (block == 0) {
        if (mbx == resync_x) {
          *px = *py = 0;
        } else if (mbx + 1 == resync_x) {
          const auto& c = mvs[xy + off[block] - wrap];
          if (mbx == 0) {
            *px = c[0], *py = c[1];
          } else {
            *px = mid3(a[0], 0, c[0]), *py = mid3(a[1], 0, c[1]);
          }
        } else {
          *px = a[0], *py = a[1];
        }
      } else if (block == 1) {
        if (mbx + 1 == resync_x) {
          const auto& c = mvs[xy + off[block] - wrap];
          *px = mid3(a[0], 0, c[0]), *py = mid3(a[1], 0, c[1]);
        } else {
          *px = a[0], *py = a[1];
        }
      } else {
        const auto& b = mvs[xy - wrap];
        const auto& c = mvs[xy + off[block] - wrap];
        if (mbx == resync_x) a[0] = a[1] = 0;
        *px = mid3(a[0], b[0], c[0]), *py = mid3(a[1], b[1], c[1]);
      }
      return;
    }
    const auto& b = mvs[xy - wrap];
    const auto& c = mvs[xy + off[block] - wrap];
    *px = mid3(a[0], b[0], c[0]), *py = mid3(a[1], b[1], c[1]);
  }

  int motion(int pred) {
    const int code = gb.vlc(T.mv);
    if (code == 0) return pred;
    const int sign = gb.bit();
    const int shift = f_code - 1;
    int val = code;
    if (shift) {
      val = ((val - 1) << shift) | static_cast<int>(gb.read(shift));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + f_code;
    val &= (1 << bits) - 1;
    return val >> (bits - 1) ? val - (1 << bits) : val;
  }

  void tcoef(const Rl& rl, int* last, int* run, int* level) {
    int s = gb.vlc(rl.vlc);
    if (s != 102) {
      *last = rl.last[s], *run = rl.run[s], *level = gb.bit() ? -rl.level[s] : rl.level[s];
      return;
    }
    if (gb.bit()) {
      if (gb.bit()) {  // third escape
        *last = gb.bit();
        *run = static_cast<int>(gb.read(6));
        if (!gb.bit()) throw Error{4};
        int lv = static_cast<int>(gb.read(12));
        if (lv >= 2048) lv -= 4096;
        if (!gb.bit()) throw Error{4};
        if (lv == 0) throw Error{4};
        *level = lv;
        return;
      }
      s = gb.vlc(rl.vlc);  // second escape
      if (s == 102) throw Error{4};
      *last = rl.last[s];
      *run = rl.run[s] + rl.max_run[*last][rl.level[s]] + 1;
      *level = gb.bit() ? -rl.level[s] : rl.level[s];
      return;
    }
    s = gb.vlc(rl.vlc);  // first escape
    if (s == 102) throw Error{4};
    *last = rl.last[s], *run = rl.run[s];
    const int lv = rl.level[s] + rl.max_level[*last][*run];
    *level = gb.bit() ? -lv : lv;
  }

  void intra_block(int n, int mbx, int mby, int coded, int ac_pred, bool use_dc_vlc,
                   int16_t* out) {
    const int scale = n < 4 ? y_dc : c_dc;
    int block[64] = {0};
    int p, idx, wrap;
    index(n, mby, mbx, &p, &idx, &wrap);
    const std::vector<int>& d = dc[p];
    int a = d[idx - 1], b = d[idx - 1 - wrap], c = d[idx - wrap];
    if (first_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mbx == resync_x) b = a = 1024;
    }
    if (mbx == resync_x && mby == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred, dir;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c, dir = 1;
    } else {
      pred = a, dir = 0;
    }
    int i;
    if (use_dc_vlc) {
      const int size = gb.vlc(n < 4 ? T.dc_lum : T.dc_chrom);
      if (size > 9) throw Error{5};
      int level = 0;
      if (size) {
        level = gb.xbits(size);
        if (size > 8) gb.bit();
      }
      block[0] = level;
      i = 0;
    } else {
      i = -1;
    }
    const uint8_t* scan = ac_pred ? (dir == 0 ? kAltV : kAltH) : kZigzag;
    if (coded) {
      while (true) {
        int last, run, level;
        tcoef(T.intra, &last, &run, &level);
        i += run + 1;
        if (i > 63) throw Error{6};
        block[scan[i]] = level;
        if (last) break;
      }
    }
    const int level = block[0] + (pred + (scale >> 1)) / scale;
    if (level < 0 && use_dc_vlc) throw Error{5};  // mpeg4_decode_block's error
    int stored = level * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    dc[p][idx] = stored;
    block[0] = level;
    // ff_mpeg4_pred_ac
    if (ac_pred) {
      if (dir == 0) {
        const auto& src = ac[p][idx - 1];
        const int q2 = mbx > 0 ? qtab[mby * mbw + mbx - 1] : qscale;
        if (mbx == 0 || n == 1 || n == 3 || qscale == q2) {
          for (int k = 1; k < 8; ++k) block[k << 3] += src[k];
        } else {
          for (int k = 1; k < 8; ++k) block[k << 3] += rounded_div(src[k] * q2, qscale);
        }
      } else {
        const auto& src = ac[p][idx - wrap];
        const int q2 = mby > 0 ? qtab[(mby - 1) * mbw + mbx] : qscale;
        if (mby == 0 || n == 2 || n == 3 || qscale == q2) {
          for (int k = 1; k < 8; ++k) block[k] += src[k + 8];
        } else {
          for (int k = 1; k < 8; ++k) block[k] += rounded_div(src[k + 8] * q2, qscale);
        }
      }
      for (int k = 1; k < 64; ++k) block[k] = i16(block[k]);
    }
    auto& keep = ac[p][idx];
    keep[0] = keep[8] = 0;
    for (int k = 1; k < 8; ++k) keep[k] = block[k << 3], keep[k + 8] = block[k];
    // dequantization (dct_unquantize_h263_intra / _mpeg2_intra)
    const int q = qscale;
    out[0] = i16(block[0] * scale);
    for (int k = 1; k < 64; ++k) {
      const int v = block[k];
      int m = 0;
      if (v) m = mpeg_quant ? (std::abs(v) * q * intra_matrix[k]) >> 3 : std::abs(v) * 2 * q + ((q - 1) | 1);
      out[k] = i16(v < 0 ? -m : m);
    }
  }

  void inter_block(int16_t* out) {
    int block[64] = {0};
    int i = -1;
    const int q = qscale;
    while (true) {
      int last, run, level;
      tcoef(T.inter, &last, &run, &level);
      i += run + 1;
      if (i > 63) throw Error{6};
      if (mpeg_quant) {
        block[kZigzag[i]] = level;
      } else {
        int mag = std::abs(level) * 2 * q + ((q - 1) | 1);
        const int top = 2047 + (level < 0);
        if (mag > top) mag = top;
        block[kZigzag[i]] = level < 0 ? -mag : mag;
      }
      if (last) break;
    }
    if (mpeg_quant) {  // dct_unquantize_mpeg2_inter at 2q: mismatch control on an even sum
      int sum = -1;
      for (int k = 0; k < 64; ++k) {
        const int v = block[k];
        if (!v) continue;
        const int m = ((2 * std::abs(v) + 1) * q * inter_matrix[k]) >> 4;
        sum += v < 0 ? -m : m;
        block[k] = i16(v < 0 ? -m : m);
      }
      block[63] = i16(block[63]) ^ (sum & 1);
    }
    for (int k = 0; k < 64; ++k) out[k] = i16(block[k]);
  }

  // ---- reconstruction
  // put_pixels / put_no_rnd_pixels of an 8x8 block; `approx`: x86's
  // non-bit-exact 8-wide no-rounding x2 / y2 averages (`_halfpel`)
  static void halfpel(const uint8_t* ref, int64_t pitch, int x0, int y0, int fx, int fy, int rnd,
                      int hedge, int vedge, bool approx, uint8_t* dst, int64_t dpitch) {
    int win[9][9];
    for (int y = 0; y < 9; ++y) {
      const int yy = std::min(std::max(y0 + y, 0), vedge - 1);
      for (int x = 0; x < 9; ++x) win[y][x] = ref[yy * pitch + std::min(std::max(x0 + x, 0), hedge - 1)];
    }
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        int v;
        if (fx && fy)
          v = (win[y][x] + win[y][x + 1] + win[y + 1][x] + win[y + 1][x + 1] + 2 - rnd) >> 2;
        else if (fx && rnd && approx)
          v = (std::max(win[y][x] - 1, 0) + win[y][x + 1] + 1) >> 1;
        else if (fx)
          v = (win[y][x] + win[y][x + 1] + 1 - rnd) >> 1;
        else if (fy && rnd && approx)
          v = y & 1 ? (std::max(win[y][x] - 1, 0) + win[y + 1][x] + 1) >> 1
                    : (win[y][x] + std::max(win[y + 1][x] - 1, 0) + 1) >> 1;
        else if (fy)
          v = (win[y][x] + win[y + 1][x] + 1 - rnd) >> 1;
        else
          v = win[y][x];
        dst[y * dpitch + x] = static_cast<uint8_t>(v);
      }
  }

  void reconstruct(const uint8_t* ry, const uint8_t* ru, const uint8_t* rv, uint8_t* oy,
                   uint8_t* ou, uint8_t* ov) {
    const int64_t yp = mbw * 16, cp = mbw * 8;
    for (int mby = 0; mby < mbh; ++mby)
      for (int mbx = 0; mbx < mbw; ++mbx) {
        const int mb = mby * mbw + mbx;
        const int16_t* blk = blocks.data() + static_cast<size_t>(mb) * 6 * 64;
        uint8_t* dy = oy + mby * 16 * yp + mbx * 16;
        uint8_t* du = ou + mby * 8 * cp + mbx * 8;
        uint8_t* dv = ov + mby * 8 * cp + mbx * 8;
        if (kind == kI || kinds[mb] == kIntra) {
          for (int n = 0; n < 4; ++n) idct_put(blk + 64 * n, dy + (n >> 1) * 8 * yp + (n & 1) * 8, yp);
          idct_put(blk + 256, du, cp);
          idct_put(blk + 320, dv, cp);
          continue;
        }
        const int* mv = mb_mv.data() + mb * 8;
        const bool four = kinds[mb] == kInter4v;
        for (int n = 0; n < 4; ++n) {
          const int mx = mv[2 * n], my = mv[2 * n + 1];
          int fx = mx & 1, fy = my & 1;
          int sx = mbx * 16 + (n & 1) * 8 + (mx >> 1), sy = mby * 16 + (n >> 1) * 8 + (my >> 1);
          if (four) {
            sx = std::min(std::max(sx, -16), width);
            if (sx == width) fx = 0;
            sy = std::min(std::max(sy, -16), height);
            if (sy == height) fy = 0;
          }
          uint8_t* d = dy + (n >> 1) * 8 * yp + (n & 1) * 8;
          halfpel(ry, yp, sx, sy, fx, fy, rounding, hedge, vedge, four, d, yp);
          idct_add(blk + 64 * n, d, yp);
        }
        int cx, cy;
        if (four) {
          const int sxm = mv[0] + mv[2] + mv[4] + mv[6], sym = mv[1] + mv[3] + mv[5] + mv[7];
          cx = kChromaRound[sxm & 15] + ((sxm >> 3) & ~1);
          cy = kChromaRound[sym & 15] + ((sym >> 3) & ~1);
        } else {
          cx = ((mv[0] >> 2) << 1) | ((mv[0] & 3) != 0);
          cy = ((mv[1] >> 2) << 1) | ((mv[1] & 3) != 0);
        }
        int fx = cx & 1, fy = cy & 1;
        int sx = mbx * 8 + (cx >> 1), sy = mby * 8 + (cy >> 1);
        if (four) {
          sx = std::min(std::max(sx, -8), width >> 1);
          if (sx == (width >> 1)) fx = 0;
          sy = std::min(std::max(sy, -8), height >> 1);
          if (sy == (height >> 1)) fy = 0;
        }
        halfpel(ru, cp, sx, sy, fx, fy, rounding, hedge >> 1, vedge >> 1, true, du, cp);
        halfpel(rv, cp, sx, sy, fx, fy, rounding, hedge >> 1, vedge >> 1, true, dv, cp);
        idct_add(blk + 256, du, cp);
        idct_add(blk + 320, dv, cp);
      }
  }
};

}  // namespace

extern "C" {

// Frame planes to bgr24 (H x W x 3) as cv2's swscale call gives them: `kind`
// 0 4:2:0, 1 4:2:2, 2 4:4:4 (u, v at chroma stride `cstride` of their own
// rows), 3 grey (u, v unread); `full` the JPEG (full) range. Returns 0, or 1
// on bad parameters (an odd height of 4:2:0 or 4:2:2 takes another swscale
// path). Twin: `data/yuv.py:to_bgr_numpy`.
int yp_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int H, int W, int cstride,
                  int kind, int full, uint8_t* out) {
  if (H <= 0 || W <= 0 || kind < 0 || kind > 3 || ((kind == 0 || kind == 1) && (H & 1)))
    return 1;
  const int64_t n = static_cast<int64_t>(H) * W;
  if (kind == 3) {
    for (int64_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return 0;
  }
  int64_t cy = 1 << 16, crv = 104597, cbu = 132201, cgu = 25675, cgv = 53279, oy = 0;
  if (full) {
    crv = crv * 224 / 255, cbu = cbu * 224 / 255, cgu = cgu * 224 / 255, cgv = cgv * 224 / 255;
  } else {
    cy = cy * 255 / 219, oy = 16 << 16;
  }
  const int yc = round16(cy, 13), vr = round16(crv, 13), ub = round16(cbu, 13),
            ug = -round16(cgu, 13), vg = -round16(cgv, 13);
  const int hs = kind == 2 ? 0 : 1, vs = kind == 0 ? 1 : 0;
  if (kind == 2) {  // yuv2rgb_full_1_c / yuv2rgb_write_full
    const int64_t off = round16(oy, 9);
    for (int r = 0; r < H; ++r)
      for (int c = 0; c < W; ++c) {
        const int64_t i = static_cast<int64_t>(r) * W + c;
        const int64_t Y = (512LL * y[i] - off) * yc + (1 << 21);
        const int64_t U = 512LL * (u[r * static_cast<int64_t>(cstride) + c] - 128);
        const int64_t V = 512LL * (v[r * static_cast<int64_t>(cstride) + c] - 128);
        const int64_t lim = (1LL << 30) - 1, zero = 0;
        const int64_t B = std::min(std::max(Y + U * ub, zero), lim),
                      G = std::min(std::max(Y + V * vg + U * ug, zero), lim),
                      R = std::min(std::max(Y + V * vr, zero), lim);
        out[3 * i] = static_cast<uint8_t>(B >> 22);
        out[3 * i + 1] = static_cast<uint8_t>(G >> 22);
        out[3 * i + 2] = static_cast<uint8_t>(R >> 22);
      }
    return 0;
  }
  const int off = round16(oy, 3);  // the x86 SIMD routine (pmulhw lanes)
  for (int r = 0; r < H; ++r) {
    const uint8_t* ur = u + static_cast<int64_t>(r >> vs) * cstride;
    const uint8_t* vr_ = v + static_cast<int64_t>(r >> vs) * cstride;
    for (int c = 0; c < W; ++c) {
      const int64_t i = static_cast<int64_t>(r) * W + c;
      const int yy = ((8 * y[i] - off) * yc) >> 16;
      const int uu = 8 * ur[c >> hs] - 1024, vv = 8 * vr_[c >> hs] - 1024;
      out[3 * i] = clip_u8(yy + ((uu * ub) >> 16));
      out[3 * i + 1] = clip_u8(yy + ((uu * ug) >> 16) + ((vv * vg) >> 16));
      out[3 * i + 2] = clip_u8(yy + ((vv * vr) >> 16));
    }
  }
  return 0;
}

// FFmpeg's mjpeg dequantization and simple IDCT of `n` blocks of quantized
// coefficients (natural order, int16): each coefficient times `quant`
// (64, natural order) as int16, DC plus 1024, then the put form into `out`
// (n x 64 samples, each block row-major). Returns 0, 1 on bad parameters,
// 2 where a block's row pass leaves 16 bits. Twin: `data/mjpeg.py`
// (`dequantize`, `idct_ff.idct_put`).
int yp_mjpeg_idct(const int16_t* coef, int64_t n, const int32_t* quant, uint8_t* out) {
  if (n < 0) return 1;
  int16_t block[64];
  try {
    for (int64_t b = 0; b < n; ++b) {
      const int16_t* c = coef + 64 * b;
      for (int k = 0; k < 64; ++k) block[k] = i16(c[k] * quant[k]);
      block[0] = i16(block[0] + 1024);
      idct_put(block, out + 64 * b, 8);
    }
  } catch (const IdctOverflow&) {
    return 2;
  }
  return 0;
}

// One MPEG-4 Part 2 VOP: `data` (len bytes, then 8 zero bytes) holds the
// packet, `params` width, height, VOP kind (0 I, 1 P), rounding type,
// intra DC VLC threshold, quantizer, f_code, MPEG quantization, resync
// markers, quantizer precision, time increment bits, h_edge_pos, v_edge_pos
// and the bit offset of the first macroblock; `matrices` the intra then
// inter matrix (natural order); `ref_*` the reference planes of a P-VOP
// (coded size, 16 mbw x 16 mbh and 8 mbw x 8 mbh). Writes the coded-size
// planes. Returns 0, 1 on bad parameters, 2-6 on a stream error (FFmpeg
// would conceal it), 9 where a block's IDCT row pass leaves 16 bits. Twin: `data/mpeg4video.py` (`_Vop.run`,
// `reconstruct`).
int yp_mpeg4_decode_vop(const uint8_t* data, int64_t len, const int32_t* params,
                        const int32_t* matrices, const uint8_t* ref_y, const uint8_t* ref_u,
                        const uint8_t* ref_v, uint8_t* out_y, uint8_t* out_u, uint8_t* out_v) {
  Vop vop;
  vop.width = params[0], vop.height = params[1], vop.kind = params[2], vop.rounding = params[3];
  vop.dc_threshold = params[4];
  vop.f_code = params[6], vop.mpeg_quant = params[7], vop.resync_marker = params[8];
  vop.quant_precision = params[9], vop.time_bits = params[10];
  vop.hedge = params[11], vop.vedge = params[12];
  if (vop.width <= 0 || vop.height <= 0 || (vop.kind != kI && vop.kind != kP) || len < 0 ||
      params[13] < 0 || vop.f_code < 1 || vop.f_code > 7 || vop.hedge <= 0 || vop.vedge <= 0)
    return 1;
  vop.gb = Bits{data, params[13], len * 8};
  vop.intra_matrix = matrices;
  vop.inter_matrix = matrices + 64;
  vop.set_qscale(params[5]);
  try {
    vop.init();
    vop.run();
  } catch (const Error& e) {
    return e.status;
  }
  try {
    vop.reconstruct(ref_y, ref_u, ref_v, out_y, out_u, out_v);
  } catch (const IdctOverflow&) {
    return 9;
  }
  return 0;
}

}  // extern "C"
