// Host code of the port's datasets, compiled with the CUDA kernels (the same
// build, the same shared library) and called through ctypes:
//
// * PNG scanline reconstruction (the five filter types of the PNG
//   specification, section 9). Average and Paeth run sequentially along a
//   row and need the row above, so they are slow in numpy. Numpy twin:
//   `data/png.py:unfilter_numpy`.
// * The datasets' resize, the loops of the JAX package's
//   `native/preprocess.cc` (`yp_resize_bilinear_u8`, `yp_resize_area_u8`)
//   with each `a * b + c` that its `-O3 -march=native` build fuses written as
//   an explicit `std::fma`; this file is compiled with `-ffp-contract=off`,
//   so no other operation is fused. Numpy twin: `data/native.py`.
// * The host-warp training path's perspective warp and warp coverage, the
//   loops of `native/preprocess.cc` (`yp_warp_perspective_f32`,
//   `yp_warp_coverage_f32`) with the steps that build fuses written as
//   `std::fma` in the same way, and the binary erosion that `cv2.erode`
//   computes for 0/1 masks. Numpy twins: `data/native.py`.
// * The JPEG decode (`yp_jpeg_decode`: sequential and progressive scans,
//   block smoothing, colour or grey output) and encode (`yp_jpeg_encode`,
//   the scan data libjpeg-turbo writes at OpenCV's defaults). Numpy twins:
//   `data/jpeg.py`.
// * The grey conversions of `cv2.imread(..., IMREAD_GRAYSCALE)`'s decoders
//   (`yp_grey_u8`), run-length BMP (`yp_bmp_rle`) and the covariance
//   packing of the ROS layer's object messages (`yp_cov_pack_upper`,
//   `yp_cov_unpack_upper`). Numpy twins: `data/native.py`, `data/bmp.py`.
// * The sequential decoders of the TIFF, GIF and Radiance readers: TIFF's
//   LZW (`yp_tiff_lzw`) and PackBits (`yp_packbits`) as libtiff decodes a
//   strip, GIF's LZW as OpenCV's GIF decoder reads a frame (`yp_gif_lzw`),
//   and Radiance's run-length scanlines as `rgbe.c` reads them
//   (`yp_hdr_rgbe`). Numpy twins: `data/tiff.py`, `data/gif.py`,
//   `data/radiance.py`.
// * OpenCV 5's 8-bit `warpPerspective` (bilinear, constant border) and
//   `warpAffine` (inverse map, nearest, reflected border), which the
//   synthetic-data tools run (`yp_cv_warp_perspective_u8`,
//   `yp_cv_warp_affine_u8`). Numpy twins: `data/cv_warp.py`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// An integer-valued float (a floor) as an index: out-of-range values and NaN
// become -2, which every bounds test rejects (a plain cast would be
// undefined there).
inline int to_index(float f) {
  return (f >= -2.0f && f <= 1073741824.0f) ? static_cast<int>(f) : -2;
}

// The source coordinate of output column `xn` before the scale by the
// half-size: `(h0 xn + b) / d + 1`, with each step fused as the JAX
// package's library build fuses it and `1 / d` taken first.
inline float source_unit(float hx, float xn, float b, float inv) {
  return std::fma(std::fma(hx, xn, b), inv, 1.0f);
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---- JPEG ----------------------------------------------------------------

// jpeg_natural_order, with 16 entries that absorb a corrupt run past 63
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};
constexpr int kLookahead = 9;
constexpr int kScanFields = 12 + 4 * 5;  // `data/jpeg.py:SCAN_FIELDS`
constexpr int kPad = 4096;  // zero bytes after a segment: more than one MCU can read

// A Huffman table: codes up to kLookahead bits from a table, longer ones by
// the canonical maxcode test (jdhuff.c); a prefix of no code reads as 17
// bits and symbol 0.
struct Huffman {
  uint16_t look[1 << kLookahead];  // (length << 8) | symbol, 0 for a longer code
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];

  // counts: codes of each length 1..16; symbols up to max_symbol (15 for a
  // DCT file's DC table, 16 for a lossless file's); false on a bad table
  bool build(const uint8_t* counts, const uint8_t* symbols, int max_symbol) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += counts[l];
    if (total > 256) return false;
    std::memcpy(vals, symbols, 256);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      const int n = counts[l - 1];
      valoffset[l] = k - code;
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (code + 1 >= (1 << l)) return false;  // no code may be all ones
        if (vals[k] > max_symbol) return false;
        if (l <= kLookahead) {
          const int span = 1 << (kLookahead - l);
          for (int j = 0; j < span; ++j)
            look[(code << (kLookahead - l)) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = n ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    return true;
  }
};

// Bits of one segment (unstuffed, followed by kPad zero bytes).
struct BitReader {
  const uint8_t* p;
  int64_t pos = 0;

  uint32_t peek(int n) const {  // n <= 32
    uint64_t w;
    std::memcpy(&w, p + (pos >> 3), 8);
    w = __builtin_bswap64(w) << (pos & 7);
    return static_cast<uint32_t>(w >> (64 - n));
  }
  int bits(int n) {
    const int v = static_cast<int>(peek(n));
    pos += n;
    return v;
  }
  int decode(const Huffman& h) {
    const uint16_t e = h.look[peek(kLookahead)];
    if (e) {
      pos += e >> 8;
      return e & 255;
    }
    int l = kLookahead + 1;
    int32_t code = static_cast<int32_t>(peek(l));
    while (code > h.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(peek(l < 17 ? l : 17));
    }
    pos += l;
    return l > 16 ? 0 : h.vals[(code + h.valoffset[l]) & 255];
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// `v` as a 16-bit lane holds it (paddw / psubw / pmullw / psllw wrap).
inline int64_t wrap16(int64_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

// One pass of jpeg_idct_islow on 8 values x[0], x[stride], ..., before its
// descale (outputs scaled by 2**13), as libjpeg-turbo's SIMD version computes
// it: the sums it forms in 16-bit lanes wrap (x0 + x4, x0 - x4, z3 = x7 + x3,
// z4 = x5 + x1); the products and the other sums are 32-bit, which 16-bit
// inputs never pass.
inline void idct_1d(const int64_t* x, int stride, int64_t* out) {
  const int64_t x0 = x[0], x1 = x[stride], x2 = x[2 * stride], x3 = x[3 * stride];
  const int64_t x4 = x[4 * stride], x5 = x[5 * stride], x6 = x[6 * stride];
  const int64_t x7 = x[7 * stride];
  int64_t z1 = (x2 + x6) * 4433;
  const int64_t tmp2 = z1 - x6 * 15137;
  const int64_t tmp3 = z1 + x2 * 6270;
  const int64_t tmp0 = wrap16(x0 + x4) * 8192;
  const int64_t tmp1 = wrap16(x0 - x4) * 8192;
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  int64_t t0 = x7, t1 = x5, t2 = x3, t3 = x1;
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = wrap16(t0 + t2), z4 = wrap16(t1 + t3);
  const int64_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  out[0] = t10 + t3;
  out[1] = t11 + t2;
  out[2] = t12 + t1;
  out[3] = t13 + t0;
  out[4] = t13 - t0;
  out[5] = t12 - t1;
  out[6] = t11 - t2;
  out[7] = t10 - t3;
}

// jpeg_idct_islow of one block into an 8x8 window of `dst` (row pitch
// `pitch`), as libjpeg-turbo's SIMD version computes it: the dequantized
// coefficients 16-bit, the 16-bit sums of each pass wrapped (`idct_1d`), the
// first pass's outputs saturated to 16 bits, the samples to 0-255; a block
// whose rows 1-7 are all zero skips the first pass, its first row shifted
// left by PASS1_BITS in 16 bits (twin: `data/jpeg.py:idct_islow`).
void idct_block(const int16_t* coef, const int32_t* quant, uint8_t* dst, int64_t pitch) {
  int64_t in[64], ws[64], t[8];
  bool dc_only = true;
  for (int i = 0; i < 64; ++i) {
    in[i] = wrap16(coef[i] * static_cast<int16_t>(quant[i]));
    dc_only = dc_only && (i < 8 || coef[i] == 0);
  }
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    idct_1d(in + c, 8, t);
    for (int r = 0; r < 8; ++r)
      ws[r * 8 + c] = dc_only ? wrap16(in[c] * 4)
                              : std::clamp<int64_t>((t[r] + 1024) >> 11, -32768, 32767);
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    idct_1d(ws + r * 8, 1, t);
    uint8_t* row = dst + r * pitch;
    for (int c = 0; c < 8; ++c)
      row[c] = static_cast<uint8_t>(std::clamp<int64_t>(((t[c] + (1 << 17)) >> 18) + 128, 0, 255));
  }
}

// Full-size rows [0, rows) x [0, cols) of a downsampled plane p (dh x dw real
// samples, row pitch `pitch`) upsampled by (hr, vr) as jdsample.c chooses;
// by replication only without `fancy` (a lossless file).
void upsample_plane(const uint8_t* p, int64_t pitch, int dh, int dw, int hr, int vr,
                    uint8_t* out, int rows, int cols, bool fancy) {
  std::vector<int> sums(dw);
  const bool fancy_h = fancy && dw > 2;
  for (int y = 0; y < rows; ++y) {
    uint8_t* o = out + static_cast<int64_t>(y) * cols;
    const int j = y / vr;
    const uint8_t* r0 = p + j * pitch;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, r0, cols);
    } else if (hr == 1 && vr == 2 && fancy) {  // h1v2: the nearer row 3/4, the farther 1/4
      const bool below = y & 1;
      const uint8_t* r1 = p + std::clamp(below ? j + 1 : j - 1, 0, dh - 1) * pitch;
      const int bias = below ? 2 : 1;
      for (int x = 0; x < cols; ++x) o[x] = static_cast<uint8_t>((3 * r0[x] + r1[x] + bias) >> 2);
    } else if (hr == 2 && vr <= 2 && fancy_h) {
      // h2v1 (one row, the weights 4 in place of 16) or h2v2 (column sums of
      // the nearer row x 3 and the farther); each input column i gives the
      // output pair (2i, 2i + 1), the edges replicated
      int shift = 2, lo = 1, hi = 2;
      if (vr == 2) {
        const uint8_t* r1 = p + std::clamp((y & 1) ? j + 1 : j - 1, 0, dh - 1) * pitch;
        for (int i = 0; i < dw; ++i) sums[i] = 3 * r0[i] + r1[i];
        shift = 4, lo = 8, hi = 7;
      } else {
        for (int i = 0; i < dw; ++i) sums[i] = r0[i];
      }
      const int* sm = sums.data();
      const int pairs = cols / 2;  // full pairs; an odd last column below
      auto even = [&](int i) { return (3 * sm[i] + sm[std::max(i - 1, 0)] + lo) >> shift; };
      auto odd = [&](int i) { return (3 * sm[i] + sm[std::min(i + 1, dw - 1)] + hi) >> shift; };
      if (pairs > 0) {
        o[0] = static_cast<uint8_t>(even(0));
        o[1] = static_cast<uint8_t>(odd(0));
      }
      const int inner = std::min(pairs, dw - 1);
      for (int i = 1; i < inner; ++i) {
        o[2 * i] = static_cast<uint8_t>((3 * sm[i] + sm[i - 1] + lo) >> shift);
        o[2 * i + 1] = static_cast<uint8_t>((3 * sm[i] + sm[i + 1] + hi) >> shift);
      }
      for (int i = std::max(inner, 1); i < pairs; ++i) {
        o[2 * i] = static_cast<uint8_t>(even(i));
        o[2 * i + 1] = static_cast<uint8_t>(odd(i));
      }
      if (cols & 1) o[cols - 1] = static_cast<uint8_t>(even(pairs));
    } else {  // replication
      for (int x = 0; x < cols; ++x) o[x] = r0[x / hr];
    }
  }
}

}  // namespace

namespace {

}  // namespace

extern "C" {

// raw: height rows of (1 filter byte + stride bytes); out: height x stride.
// bpp: the filter's byte distance (bytes a pixel, at least 1). Returns 0, or
// 1 + the index of the first row with an unknown filter type.
int yp_png_unfilter(const uint8_t* raw, uint8_t* out, int height, int stride, int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + static_cast<int64_t>(y) * (stride + 1);
    const uint8_t filter = line[0];
    ++line;
    uint8_t* cur = out + static_cast<int64_t>(y) * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    switch (filter) {
      case 0:
        for (int x = 0; x < stride; ++x) cur[x] = line[x];
        break;
      case 1:
        for (int x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// Bilinear resize, uint8 HWC -> uint8 HWC: half-pixel centres, clamped
// edges, f32 weights, rounded half away from zero. Returns 0.
int yp_host_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                                uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    const float fy = std::fma(y + 0.5f, sy, -0.5f);
    int y0 = static_cast<int>(std::floor(fy));
    const float wy = fy - y0;
    const int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      const float fx = std::fma(x + 0.5f, sx, -0.5f);
      int x0 = static_cast<int>(std::floor(fx));
      const float wx = fx - x0;
      const int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      const uint8_t* p00 = src + (static_cast<int64_t>(y0) * sw + x0) * c;
      const uint8_t* p01 = src + (static_cast<int64_t>(y0) * sw + x1) * c;
      const uint8_t* p10 = src + (static_cast<int64_t>(y1) * sw + x0) * c;
      const uint8_t* p11 = src + (static_cast<int64_t>(y1) * sw + x1) * c;
      uint8_t* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        const float top = std::fma(static_cast<float>(p00[k]), 1 - wx, p01[k] * wx);
        const float bot = std::fma(static_cast<float>(p10[k]), 1 - wx, p11[k] * wx);
        const float v = std::fma(top, 1 - wy, bot * wy);
        out[k] = static_cast<uint8_t>(std::lround(std::clamp(v, 0.f, 255.f)));
      }
    }
  }
  return 0;
}

// Area (box-filter) resize: f64 overlap weights over each output pixel's
// source window, rounded half away from zero. Returns 0.
int yp_host_resize_area_u8(const uint8_t* src, int sh, int sw, int c,
                            uint8_t* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    const double fy0 = y * sy, fy1 = (y + 1) * sy;
    const int iy0 = static_cast<int>(fy0);
    const int iy1 = std::min(static_cast<int>(std::ceil(fy1)), sh);
    for (int x = 0; x < dw; ++x) {
      const double fx0 = x * sx, fx1 = (x + 1) * sx;
      const int ix0 = static_cast<int>(fx0);
      const int ix1 = std::min(static_cast<int>(std::ceil(fx1)), sw);
      for (int k = 0; k < c; ++k) {
        double acc = 0.0, area = 0.0;
        for (int yy = iy0; yy < iy1; ++yy) {
          const double hy = std::min<double>(yy + 1, fy1) - std::max<double>(yy, fy0);
          for (int xx = ix0; xx < ix1; ++xx) {
            const double wx = std::min<double>(xx + 1, fx1) - std::max<double>(xx, fx0);
            acc = std::fma(src[(static_cast<int64_t>(yy) * sw + xx) * c + k] * hy, wx, acc);
            area = std::fma(hy, wx, area);
          }
        }
        dst[(static_cast<int64_t>(y) * dw + x) * c + k] =
            static_cast<uint8_t>(std::lround(acc / std::max(area, 1e-9)));
      }
    }
  }
  return 0;
}

// Inverse perspective warp of an f32 HWC image by a homography in normalized
// coordinates (align-corners grid, zero padding): mode 0 bilinear, 1 nearest
// (`floor(s + 0.5)`). Bilinear pixels whose four taps are in the image sum
// them as `fma(w11, p11, fma(w10, p10, fma(w00, p00, w01 * p01)))`; the
// others add each in-bounds tap, `acc = fma(w, p, acc)`. Returns 0.
int yp_host_warp_perspective_f32(const float* src, int h, int w, int c, const float* hinv,
                                 float* dst, int mode) {
  const float nx = w > 1 ? 2.0f / (w - 1) : 0.0f;
  const float ny = h > 1 ? 2.0f / (h - 1) : 0.0f;
  const float hx = 0.5f * (w - 1);
  const float hy = 0.5f * (h - 1);
  for (int y = 0; y < h; ++y) {
    const float yn = std::fma(ny, static_cast<float>(y), -1.0f);
    const float bx = std::fma(hinv[1], yn, hinv[2]);
    const float by = std::fma(hinv[4], yn, hinv[5]);
    const float bd = std::fma(hinv[7], yn, hinv[8]);
    float* out_row = dst + static_cast<int64_t>(y) * w * c;
    for (int x = 0; x < w; ++x) {
      const float xn = std::fma(nx, static_cast<float>(x), -1.0f);
      const float inv = 1.0f / std::fma(hinv[6], xn, bd);
      const float sx = source_unit(hinv[0], xn, bx, inv) * hx;
      const float sy = source_unit(hinv[3], xn, by, inv) * hy;
      float* out = out_row + static_cast<int64_t>(x) * c;
      if (mode == 1) {
        const int xi = to_index(std::floor(sx + 0.5f));
        const int yi = to_index(std::floor(sy + 0.5f));
        if (xi < 0 || xi > w - 1 || yi < 0 || yi > h - 1) {
          for (int k = 0; k < c; ++k) out[k] = 0.0f;
        } else {
          const float* p = src + (static_cast<int64_t>(yi) * w + xi) * c;
          for (int k = 0; k < c; ++k) out[k] = p[k];
        }
        continue;
      }
      const float fx = std::floor(sx);
      const float fy = std::floor(sy);
      const float wx = sx - fx;
      const float wy = sy - fy;
      const int x0 = to_index(fx);
      const int y0 = to_index(fy);
      if (x0 >= 0 && x0 < w - 1 && y0 >= 0 && y0 < h - 1) {
        const float w00 = (1.0f - wy) * (1.0f - wx);
        const float w01 = (1.0f - wy) * wx;
        const float w10 = wy * (1.0f - wx);
        const float w11 = wy * wx;
        const float* p0 = src + (static_cast<int64_t>(y0) * w + x0) * c;
        const float* p1 = p0 + static_cast<int64_t>(w) * c;
        for (int k = 0; k < c; ++k) {
          const float v = std::fma(p0[k], w00, p0[c + k] * w01);
          out[k] = std::fma(p1[c + k], w11, std::fma(p1[k], w10, v));
        }
        continue;
      }
      for (int k = 0; k < c; ++k) out[k] = 0.0f;
      for (int dy = 0; dy < 2; ++dy) {
        const int yi = y0 + dy;
        if (yi < 0 || yi > h - 1) continue;
        const float wyv = dy ? wy : 1.0f - wy;
        for (int dx = 0; dx < 2; ++dx) {
          const int xi = x0 + dx;
          if (xi < 0 || xi > w - 1) continue;
          const float wv = wyv * (dx ? wx : 1.0f - wx);
          const float* p = src + (static_cast<int64_t>(yi) * w + xi) * c;
          for (int k = 0; k < c; ++k) out[k] = std::fma(wv, p[k], out[k]);
        }
      }
    }
  }
  return 0;
}

// Coverage of an inverse warp of an (h, w) frame: 1 where the nearest source
// tap is in the frame, else 0 (the nearest warp of ones, with no reads).
// Here the library build fuses the scale by the half-size with the `+ 0.5`
// of the rounding. Returns 0.
int yp_host_warp_coverage_f32(int h, int w, const float* hinv, float* dst) {
  const float nx = w > 1 ? 2.0f / (w - 1) : 0.0f;
  const float ny = h > 1 ? 2.0f / (h - 1) : 0.0f;
  const float hx = 0.5f * (w - 1);
  const float hy = 0.5f * (h - 1);
  const float wmax = static_cast<float>(w - 1);
  const float hmax = static_cast<float>(h - 1);
  for (int y = 0; y < h; ++y) {
    const float yn = std::fma(ny, static_cast<float>(y), -1.0f);
    const float bx = std::fma(hinv[1], yn, hinv[2]);
    const float by = std::fma(hinv[4], yn, hinv[5]);
    const float bd = std::fma(hinv[7], yn, hinv[8]);
    float* out = dst + static_cast<int64_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      const float xn = std::fma(nx, static_cast<float>(x), -1.0f);
      const float inv = 1.0f / std::fma(hinv[6], xn, bd);
      const float xi = std::floor(std::fma(source_unit(hinv[0], xn, bx, inv), hx, 0.5f));
      const float yi = std::floor(std::fma(source_unit(hinv[3], xn, by, inv), hy, 0.5f));
      out[x] = (xi >= 0.0f && xi <= wmax && yi >= 0.0f && yi <= hmax) ? 1.0f : 0.0f;
    }
  }
  return 0;
}

// Binary erosion of an (h, w) f32 0/1 mask by a (kh, kw) 0/1 structuring
// element anchored at (kh / 2, kw / 2), the frame outside the mask counting
// as ones: `cv2.erode` with its default border. Each source row is copied
// into a ones-padded buffer, so that every tap of the element is one
// contiguous, branch-free pass over the output row. Returns 0.
int yp_host_erode_f32(const float* src, int h, int w, const uint8_t* kernel, int kh, int kw,
                      float* dst) {
  const int ay = kh / 2, ax = kw / 2;
  std::vector<float> padded(static_cast<size_t>(w) + kw, 1.0f);
  for (int y = 0; y < h; ++y) {
    float* out = dst + static_cast<int64_t>(y) * w;
    std::fill(out, out + w, 1.0f);
    for (int dy = 0; dy < kh; ++dy) {
      const int yy = y + dy - ay;
      if (yy < 0 || yy > h - 1) continue;
      std::copy(src + static_cast<int64_t>(yy) * w, src + static_cast<int64_t>(yy + 1) * w,
                padded.begin() + ax);
      for (int dx = 0; dx < kw; ++dx) {
        if (!kernel[dy * kw + dx]) continue;
        const float* p = padded.data() + dx;  // p[x] = src[yy][x + dx - ax]
        for (int x = 0; x < w; ++x) out[x] = std::min(out[x], p[x]);
      }
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// The entropy-coded bytes of one scan (closed by a marker), unstuffed and
// split at the restart markers in sequence into `segs` (begin, end) of
// `bytes`; each segment is followed by kPad + 8 zero bytes, which read on as
// zero bits (jdhuff.c's fill at a marker).
void split_segments(const uint8_t* data, int64_t len, std::vector<uint8_t>& bytes,
                    std::vector<std::pair<size_t, size_t>>& segs) {
  bytes.clear();
  segs.clear();
  bytes.reserve(len + kPad + 8);
  size_t start = 0;
  int expect = 0xD0;
  int64_t i = 0;
  for (;;) {
    if (i >= len) {
      segs.push_back({start, bytes.size()});
      break;
    }
    if (data[i] != 0xFF) {
      bytes.push_back(data[i++]);
      continue;
    }
    int64_t k = i + 1;
    while (k < len && data[k] == 0xFF) ++k;
    if (k >= len) {
      segs.push_back({start, bytes.size()});
      break;
    }
    if (data[k] == 0) {
      bytes.push_back(0xFF);
      i = k + 1;
      continue;
    }
    segs.push_back({start, bytes.size()});
    if (data[k] != expect) break;
    bytes.insert(bytes.end(), kPad + 8, 0);
    start = bytes.size();
    expect = 0xD0 + ((expect - 0xD0 + 1) & 7);
    i = k + 1;
  }
  bytes.insert(bytes.end(), kPad + 8, 0);
}

inline int16_t i16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

// A JPEG frame: components, sampling, coefficient grids (the MCU grid's),
// downsampled sizes; a lossless file's sample planes (dh x dw) in place of
// coefficients, its MCU grid of single samples.
struct Frame {
  int W, H, nc, color, progressive, lossless, precision, hmax = 1, vmax = 1, mx, my;
  int hs[4], vs[4], dh[4], dw[4], brow[4], bcol[4];
  std::vector<int16_t> coef[4];
  std::vector<uint8_t> samples[4];
};

// The colours of `data/jpeg.py` (`YCC, RGB, GREY, CMYK, YCCK, RAW`; RAW:
// the components as they are, `nc` channels a pixel, as libtiff reads a JPEG
// strip that is not YCbCr)
enum JpegColor { kJpegYcc, kJpegRgb, kJpegGrey, kJpegCmyk, kJpegYcck, kJpegRaw };

enum Mode { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

// A scan's MCU grid (ux x uy) and the blocks of an MCU in coding order:
// an interleaved scan's v x h blocks of each component in turn, a
// non-interleaved one's single block of its component's own grid. Twin:
// `data/jpeg.py:mcu_blocks`.
struct Slot { int s, c, dv, dh; };
struct ScanLayout {
  bool single;
  int64_t ux, uy;
  std::vector<Slot> slots;

  ScanLayout(const Frame& f, const int32_t* sc) : single(sc[2] == 1), ux(f.mx), uy(f.my) {
    const int* comps = sc + 3;
    if (single) {
      ux = (f.dw[comps[0]] + 7) / 8;
      uy = (f.dh[comps[0]] + 7) / 8;
    }
    for (int s = 0; s < sc[2]; ++s) {
      const int c = comps[s];
      for (int v = 0; v < (single ? 1 : f.vs[c]); ++v)
        for (int h = 0; h < (single ? 1 : f.hs[c]); ++h) slots.push_back({s, c, v, h});
    }
  }
  // the coefficients of slot `sl`'s block in MCU m
  int16_t* block(Frame& f, const Slot& sl, int64_t m) const {
    const int64_t row = m / ux, col = m % ux;
    const int hsc = single ? 1 : f.hs[sl.c], vsc = single ? 1 : f.vs[sl.c];
    return f.coef[sl.c].data() + ((row * vsc + sl.dv) * f.bcol[sl.c] + col * hsc + sl.dh) * 64;
  }
};

// One scan's entropy decode into the frame's coefficient buffers: a
// sequential scan as jdhuff.c, a progressive one as jdphuff.c. `sc`: the
// scan's row of the scan table; `tables`: a DC and an AC table a scan
// component. Twin: `data/jpeg.py:decode_scan_numpy`.
int64_t decode_scan(Frame& f, const uint8_t* data, const int32_t* sc, const Huffman* tables) {
  const int ss = sc[7], se = sc[8], ah = sc[9], restart = sc[11];
  const int al = f.progressive ? sc[10] : 0;  // a sequential scan's Al is not read
  const ScanLayout layout(f, sc);
  const Mode mode = !f.progressive ? kSequential
                    : ss == 0      ? (ah ? kDcRefine : kDcFirst)
                                   : (ah ? kAcRefine : kAcFirst);
  const int p1 = 1 << al, m1 = -(1 << al);
  std::vector<uint8_t> bytes;
  std::vector<std::pair<size_t, size_t>> segs;
  split_segments(data + sc[0], sc[1], bytes, segs);
  const std::vector<uint8_t> empty(kPad + 8, 0);
  const int64_t total = layout.ux * layout.uy;
  const int64_t interval = restart ? restart : total;
  bool short_data = false;
  int64_t ran_out = -1;
  for (int64_t first = 0; first < total; first += interval) {
    // a restart: DC predictors and the EOB run zeroed; a missing segment
    // reads as zero bits and keeps the out-of-data state
    const size_t index = static_cast<size_t>(first / interval);
    BitReader br;
    int64_t nbits = 0;
    if (index < segs.size()) {
      br.p = bytes.data() + segs[index].first;
      nbits = 8 * static_cast<int64_t>(segs[index].second - segs[index].first);
      short_data = false;
    } else {
      br.p = empty.data();
    }
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    const int64_t last = std::min(first + interval, total);
    for (int64_t m = first; m < last && !short_data; ++m) {
      for (const Slot& sl : layout.slots) {
        const Huffman& dc = tables[2 * sl.s];
        const Huffman& ac = tables[2 * sl.s + 1];
        int16_t* blk = layout.block(f, sl, m);
        if (mode == kSequential || mode == kDcFirst) {
          const int s = br.decode(dc);
          pred[sl.s] += s ? extend(br.bits(s), s) : 0;
          blk[0] = i16(static_cast<int>(static_cast<unsigned>(pred[sl.s]) << al));
        } else if (mode == kDcRefine) {
          if (br.bits(1)) blk[0] = i16(blk[0] | p1);
        }
        if (mode == kSequential) {
          for (int k = 1; k < 64; ++k) {
            const int rs = br.decode(ac);
            const int s = rs & 15;
            if (s) {
              k += rs >> 4;
              blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
            } else if ((rs >> 4) == 15) {
              k += 15;
            } else {
              break;
            }
          }
        } else if (mode == kAcFirst) {
          if (eobrun) {
            --eobrun;
            continue;
          }
          for (int k = ss; k <= se; ++k) {
            const int rs = br.decode(ac);
            const int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] =
                  i16(static_cast<int>(static_cast<unsigned>(extend(br.bits(s), s)) << al));
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = (1 << r) + (r ? br.bits(r) : 0) - 1;
              break;
            }
          }
        } else if (mode == kAcRefine) {
          int k = ss;
          auto refine = [&](int16_t& c) {  // a correction bit of a nonzero coefficient
            if (br.bits(1) && !(c & p1)) c = i16(c + (c >= 0 ? p1 : m1));
          };
          if (!eobrun) {
            for (; k <= se; ++k) {
              const int rs = br.decode(ac);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                s = br.bits(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = (1 << r) + (r ? br.bits(r) : 0);
                break;
              }
              do {  // the coefficients the run passes over
                int16_t& c = blk[kNatural[k]];
                if (c) {
                  refine(c);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun) {
            for (; k <= se; ++k) {
              int16_t& c = blk[kNatural[k]];
              if (c) refine(c);
            }
            --eobrun;
          }
        }
      }
      if (br.pos > nbits) {  // the MCUs after this one are left as they are
        short_data = true;
        if (ran_out < 0) ran_out = m;
      }
    }
  }
  return ran_out;
}

// jaricom.c's jpeg_aritab: the QM coder's states (Table D.2) and the fixed
// 0.5 state 113, each Qe << 16 | Next_MPS << 8 | Switch_MPS << 7 |
// Next_LPS. Twin: `data/jpeg_arith.py:ARITAB`.
#define YP_ARI(qe, nl, nm, sw) ((uint32_t(qe) << 16) | (nm << 8) | (sw << 7) | nl)
constexpr uint32_t kAritab[114] = {
    YP_ARI(0x5a1d, 1, 1, 1),    YP_ARI(0x2586, 14, 2, 0),   YP_ARI(0x1114, 16, 3, 0),
    YP_ARI(0x080b, 18, 4, 0),   YP_ARI(0x03d8, 20, 5, 0),   YP_ARI(0x01da, 23, 6, 0),
    YP_ARI(0x00e5, 25, 7, 0),   YP_ARI(0x006f, 28, 8, 0),   YP_ARI(0x0036, 30, 9, 0),
    YP_ARI(0x001a, 33, 10, 0),  YP_ARI(0x000d, 35, 11, 0),  YP_ARI(0x0006, 9, 12, 0),
    YP_ARI(0x0003, 10, 13, 0),  YP_ARI(0x0001, 12, 13, 0),  YP_ARI(0x5a7f, 15, 15, 1),
    YP_ARI(0x3f25, 36, 16, 0),  YP_ARI(0x2cf2, 38, 17, 0),  YP_ARI(0x207c, 39, 18, 0),
    YP_ARI(0x17b9, 40, 19, 0),  YP_ARI(0x1182, 42, 20, 0),  YP_ARI(0x0cef, 43, 21, 0),
    YP_ARI(0x09a1, 45, 22, 0),  YP_ARI(0x072f, 46, 23, 0),  YP_ARI(0x055c, 48, 24, 0),
    YP_ARI(0x0406, 49, 25, 0),  YP_ARI(0x0303, 51, 26, 0),  YP_ARI(0x0240, 52, 27, 0),
    YP_ARI(0x01b1, 54, 28, 0),  YP_ARI(0x0144, 56, 29, 0),  YP_ARI(0x00f5, 57, 30, 0),
    YP_ARI(0x00b7, 59, 31, 0),  YP_ARI(0x008a, 60, 32, 0),  YP_ARI(0x0068, 62, 33, 0),
    YP_ARI(0x004e, 63, 34, 0),  YP_ARI(0x003b, 32, 35, 0),  YP_ARI(0x002c, 33, 9, 0),
    YP_ARI(0x5ae1, 37, 37, 1),  YP_ARI(0x484c, 64, 38, 0),  YP_ARI(0x3a0d, 65, 39, 0),
    YP_ARI(0x2ef1, 67, 40, 0),  YP_ARI(0x261f, 68, 41, 0),  YP_ARI(0x1f33, 69, 42, 0),
    YP_ARI(0x19a8, 70, 43, 0),  YP_ARI(0x1518, 72, 44, 0),  YP_ARI(0x1177, 73, 45, 0),
    YP_ARI(0x0e74, 74, 46, 0),  YP_ARI(0x0bfb, 75, 47, 0),  YP_ARI(0x09f8, 77, 48, 0),
    YP_ARI(0x0861, 78, 49, 0),  YP_ARI(0x0706, 79, 50, 0),  YP_ARI(0x05cd, 48, 51, 0),
    YP_ARI(0x04de, 50, 52, 0),  YP_ARI(0x040f, 50, 53, 0),  YP_ARI(0x0363, 51, 54, 0),
    YP_ARI(0x02d4, 52, 55, 0),  YP_ARI(0x025c, 53, 56, 0),  YP_ARI(0x01f8, 54, 57, 0),
    YP_ARI(0x01a4, 55, 58, 0),  YP_ARI(0x0160, 56, 59, 0),  YP_ARI(0x0125, 57, 60, 0),
    YP_ARI(0x00f6, 58, 61, 0),  YP_ARI(0x00cb, 59, 62, 0),  YP_ARI(0x00ab, 61, 63, 0),
    YP_ARI(0x008f, 61, 32, 0),  YP_ARI(0x5b12, 65, 65, 1),  YP_ARI(0x4d04, 80, 66, 0),
    YP_ARI(0x412c, 81, 67, 0),  YP_ARI(0x37d8, 82, 68, 0),  YP_ARI(0x2fe8, 83, 69, 0),
    YP_ARI(0x293c, 84, 70, 0),  YP_ARI(0x2379, 86, 71, 0),  YP_ARI(0x1edf, 87, 72, 0),
    YP_ARI(0x1aa9, 87, 73, 0),  YP_ARI(0x174e, 72, 74, 0),  YP_ARI(0x1424, 72, 75, 0),
    YP_ARI(0x119c, 74, 76, 0),  YP_ARI(0x0f6b, 74, 77, 0),  YP_ARI(0x0d51, 75, 78, 0),
    YP_ARI(0x0bb6, 77, 79, 0),  YP_ARI(0x0a40, 77, 48, 0),  YP_ARI(0x5832, 80, 81, 1),
    YP_ARI(0x4d1c, 88, 82, 0),  YP_ARI(0x438e, 89, 83, 0),  YP_ARI(0x3bdd, 90, 84, 0),
    YP_ARI(0x34ee, 91, 85, 0),  YP_ARI(0x2eae, 92, 86, 0),  YP_ARI(0x299a, 93, 87, 0),
    YP_ARI(0x2516, 86, 71, 0),  YP_ARI(0x5570, 88, 89, 1),  YP_ARI(0x4ca9, 95, 90, 0),
    YP_ARI(0x44d9, 96, 91, 0),  YP_ARI(0x3e22, 97, 92, 0),  YP_ARI(0x3824, 99, 93, 0),
    YP_ARI(0x32b4, 99, 94, 0),  YP_ARI(0x2e17, 93, 86, 0),  YP_ARI(0x56a8, 95, 96, 1),
    YP_ARI(0x4f46, 101, 97, 0), YP_ARI(0x47e5, 102, 98, 0), YP_ARI(0x41cf, 103, 99, 0),
    YP_ARI(0x3c3d, 104, 100, 0), YP_ARI(0x375e, 99, 93, 0), YP_ARI(0x5231, 105, 102, 0),
    YP_ARI(0x4c0f, 106, 103, 0), YP_ARI(0x4639, 107, 104, 0), YP_ARI(0x415e, 103, 99, 0),
    YP_ARI(0x5627, 105, 106, 1), YP_ARI(0x50e7, 108, 107, 0), YP_ARI(0x4b85, 109, 103, 0),
    YP_ARI(0x5597, 110, 109, 0), YP_ARI(0x504f, 111, 107, 0), YP_ARI(0x5a10, 110, 111, 1),
    YP_ARI(0x5522, 112, 109, 0), YP_ARI(0x59eb, 112, 111, 1), YP_ARI(0x5a1d, 113, 113, 0)};
#undef YP_ARI

// jdarith.c's arith_decode over one restart interval's unstuffed bytes,
// read on as zero bytes past their end (a marker stuffs zeros).
struct ArithDecoder {
  const uint8_t* p;
  int64_t n, pos = 0, c = 0, a = 0;
  int ct = -16;  // two bytes to fetch first

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | (pos < n ? p[pos] : 0);
        ++pos;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Figure F.23's continuation from bin `at`: m doubled while a bin
  // decodes 1; false on a magnitude overflow
  bool grow(uint8_t* stats, int& at, int& m) {
    while (decode(stats + at)) {
      if ((m <<= 1) == 0x8000) return false;
      ++at;
    }
    return true;
  }
  // Figure F.24: the bits below the category's top bit m, from bin `at`
  int pattern(uint8_t* stats, int at, int m) {
    int v = m;
    while (m >>= 1)
      if (decode(stats + at)) v |= m;
    return v;
  }
};

// One arithmetic-coded scan's entropy decode (jdarith.c: the sequential
// decode_mcu and the progressive DC first / refine and AC first / refine),
// into the same buffers as `decode_scan`. `sc` holds after its 12 fields
// each scan component's DC and AC table numbers and conditioning L, U, Kx.
// Statistics belong to a table number; at each restart the scan's
// statistics, DC predictions and contexts and the decoder are reset; a
// magnitude or spectral overflow skips the rest of the restart interval (DC
// refinement does not check it). Twin: `data/jpeg_arith.py:decode_scan`.
void decode_scan_arith(Frame& f, const uint8_t* data, const int32_t* sc) {
  const int ns = sc[2], ss = sc[7], se = sc[8], ah = sc[9], al = sc[10], restart = sc[11];
  const int32_t* cond = sc + 12;
  const bool seq = !f.progressive, dc_refine = !seq && ss == 0 && ah;
  const bool uses_dc = seq || (ss == 0 && ah == 0), uses_ac = seq || ss > 0;
  const int p1 = 1 << al, m1 = -(1 << al), lo = seq ? 1 : ss, hi = seq ? 63 : se;
  const int shift = seq ? 0 : al;
  const ScanLayout layout(f, sc);
  std::vector<uint8_t> bytes;
  std::vector<std::pair<size_t, size_t>> segs;
  split_segments(data + sc[0], sc[1], bytes, segs);
  static thread_local uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;
  const int64_t total = layout.ux * layout.uy;
  const int64_t interval = restart ? restart : total;
  for (int64_t first = 0; first < total; first += interval) {
    const size_t index = static_cast<size_t>(first / interval);
    ArithDecoder qm;
    qm.p = index < segs.size() ? bytes.data() + segs[index].first : bytes.data();
    qm.n = index < segs.size() ? static_cast<int64_t>(segs[index].second - segs[index].first) : 0;
    for (int s = 0; s < ns; ++s) {
      if (uses_dc) std::memset(dc_stats[cond[5 * s]], 0, 64);
      if (uses_ac) std::memset(ac_stats[cond[5 * s + 1]], 0, 256);
    }
    int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
    bool failed = false;
    const int64_t last = std::min(first + interval, total);
    for (int64_t m = first; m < last && (!failed || dc_refine); ++m) {
      for (const Slot& sl : layout.slots) {
        int16_t* blk = layout.block(f, sl, m);
        const int32_t* cd = cond + 5 * sl.s;
        if (dc_refine) {  // the next bit of the DC
          if (qm.decode(&fixed)) blk[0] = i16(blk[0] | p1);
          continue;
        }
        if (uses_dc) {  // F.19: the DC difference
          uint8_t* st = dc_stats[cd[0]];
          const int s0 = context[sl.s];
          if (qm.decode(st + s0) == 0) {
            context[sl.s] = 0;
          } else {
            const int sign = qm.decode(st + s0 + 1);
            int at = s0 + 2 + sign;
            int mc = qm.decode(st + at);
            if (mc) {
              at = 20;  // X1
              if (!qm.grow(st, at, mc)) {
                failed = true;
                break;
              }
            }
            if (mc < (1 << cd[2]) >> 1)
              context[sl.s] = 0;
            else if (mc > (1 << cd[3]) >> 1)
              context[sl.s] = 12 + 4 * sign;
            else
              context[sl.s] = 4 + 4 * sign;
            const int v = qm.pattern(st, at + 14, mc) + 1;
            last_dc[sl.s] = (last_dc[sl.s] + (sign ? -v : v)) & 0xFFFF;
          }
          blk[0] = i16(static_cast<int>(static_cast<unsigned>(last_dc[sl.s]) << shift));
          if (!seq) continue;
        }
        if (!uses_ac) continue;
        uint8_t* st = ac_stats[cd[1]];
        if (!seq && ah) {  // AC refine
          int kex = hi;
          while (kex > 0 && !blk[kNatural[kex]]) --kex;
          for (int k = lo; k <= hi && !failed; ++k) {
            int at = 3 * (k - 1);
            if (k > kex && qm.decode(st + at)) break;  // EOB
            for (;;) {
              int16_t& c = blk[kNatural[k]];
              if (c) {  // a correction bit
                if (qm.decode(st + at + 2)) c = i16(c + (c < 0 ? m1 : p1));
                break;
              }
              if (qm.decode(st + at + 1)) {  // newly nonzero
                c = i16(qm.decode(&fixed) ? m1 : p1);
                break;
              }
              at += 3;
              if (++k > hi) {
                failed = true;
                break;
              }
            }
          }
          if (failed) break;
          continue;
        }
        for (int k = lo; k <= hi; ++k) {  // F.20: sequential AC, or AC first
          int at = 3 * (k - 1);
          if (qm.decode(st + at)) break;  // EOB
          while (qm.decode(st + at + 1) == 0) {
            at += 3;
            if (++k > hi) {
              failed = true;
              break;
            }
          }
          if (failed) break;
          const int sign = qm.decode(&fixed);
          at += 2;
          int mc = qm.decode(st + at);
          if (mc && qm.decode(st + at)) {
            mc = 2;
            at = k <= cd[4] ? 189 : 217;
            if (!qm.grow(st, at, mc)) {
              failed = true;
              break;
            }
          }
          const int v = qm.pattern(st, at + 14, mc) + 1;
          blk[kNatural[k]] = i16(static_cast<int>(static_cast<unsigned>(sign ? -v : v) << shift));
        }
        if (failed) break;
      }
    }
  }
}

// One lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c) into the frame's
// sample planes: Huffman-coded differences on each scan component's DC
// table (category 16 is 32768), an interleaved scan's MCU holding each
// component's v x h samples in turn, a non-interleaved one's one sample; an
// iMCU row is v rows of each component. Each real row is undifferenced
// modulo 2^16 against the predictor Ss (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc,
// 5 Ra + ((Rb - Rc) >> 1), 6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1; the
// first column from above); after the scan's start, a restart or a row out
// of data every component's next row is predicted from the left, its first
// sample from 2^(precision - Al - 1); samples shifted left by Al, kept to 8
// bits. Restarts every DRI / (MCUs a row) MCU rows; past the end of the
// data the rest of that MCU row reads zero bits (each sample the difference
// its table decodes zero bits to, filled in) and later rows of the interval
// zero differences. Twin: `data/jpeg_lossless.py:decode_planes`.
void decode_scan_lossless(Frame& f, const uint8_t* data, const int32_t* sc,
                          const Huffman* tables) {
  const int ns = sc[2], predictor = sc[7], al = sc[10], restart = sc[11];
  const int* comps = sc + 3;
  const bool single = ns == 1;
  const int64_t ux = single ? f.dw[comps[0]] : f.mx;
  const int initial = 1 << (f.precision - al - 1);
  std::vector<uint8_t> bytes;
  std::vector<std::pair<size_t, size_t>> segs;
  split_segments(data + sc[0], sc[1], bytes, segs);
  const std::vector<uint8_t> empty(kPad + 8, 0);
  int sh[4], sv[4];  // samples an MCU of each scan component
  int zero[4];       // the difference its table decodes zero bits to
  std::vector<std::vector<int>> diff(ns), prev(ns), cur(ns);
  for (int s = 0; s < ns; ++s) {
    const int c = comps[s];
    BitReader z;
    z.p = empty.data();
    const int k = z.decode(tables[2 * s]);
    zero[s] = k == 16 ? 32768 : k ? extend(z.bits(k), k) : 0;
    sh[s] = single ? 1 : f.hs[c];
    sv[s] = single ? 1 : f.vs[c];
    diff[s].assign(static_cast<size_t>(f.vs[c]) * ux * sh[s], 0);
    prev[s].assign(f.dw[c], 0);
    cur[s].assign(f.dw[c], 0);
  }
  const int rows_a_restart = restart ? static_cast<int>(restart / ux) : 0;
  int left = rows_a_restart;
  size_t index = 0;
  BitReader br;
  br.p = bytes.data() + segs[0].first;
  int64_t nbits = 8 * static_cast<int64_t>(segs[0].second - segs[0].first);
  bool reset[4] = {true, true, true, true}, short_data = false;
  for (int imcu = 0; imcu < f.my; ++imcu) {
    int real[4];
    for (int s = 0; s < ns; ++s)
      real[s] = std::min(f.vs[comps[s]], f.dh[comps[s]] - imcu * f.vs[comps[s]]);
    const int mcu_rows = single ? real[0] : 1;
    for (int y = 0; y < mcu_rows; ++y) {
      if (rows_a_restart && left == 0) {  // process_restart
        ++index;
        br = BitReader();
        if (index < segs.size()) {
          br.p = bytes.data() + segs[index].first;
          nbits = 8 * static_cast<int64_t>(segs[index].second - segs[index].first);
          short_data = false;
        } else {
          br.p = empty.data();
          nbits = 0;
        }
        std::fill(reset, reset + 4, true);
        left = rows_a_restart;
      }
      if (short_data) {  // out of data: zero differences, the undifferencers reset
        for (int s = 0; s < ns; ++s) {
          int* row = diff[s].data() + static_cast<size_t>(y) * ux * sh[s];
          std::fill(row, row + static_cast<size_t>(sv[s]) * ux * sh[s], 0);
        }
        std::fill(reset, reset + 4, true);
      } else {
        // an MCU reads at most 10 x 33 bits: checked before each one, the
        // reader stays inside the segment's kPad zero bytes
        int64_t m = 0;
        for (; m < ux && br.pos < nbits; ++m)
          for (int s = 0; s < ns; ++s)
            for (int dv = 0; dv < sv[s]; ++dv)
              for (int dh = 0; dh < sh[s]; ++dh) {
                const int k = br.decode(tables[2 * s]);
                diff[s][(static_cast<size_t>(y) + dv) * ux * sh[s] + m * sh[s] + dh] =
                    k == 16 ? 32768 : k ? extend(br.bits(k), k) : 0;
              }
        short_data = m < ux || br.pos > nbits;
        for (int s = 0; s < ns && m < ux; ++s)  // zero bits only: the rest decode alike
          for (int dv = 0; dv < sv[s]; ++dv) {
            int* row = diff[s].data() + (static_cast<size_t>(y) + dv) * ux * sh[s];
            std::fill(row + m * sh[s], row + ux * sh[s], zero[s]);
          }
      }
      --left;
    }
    for (int s = 0; s < ns; ++s) {
      const int c = comps[s], dw = f.dw[c];
      for (int r = 0; r < real[s]; ++r) {
        const int* d = diff[s].data() + static_cast<size_t>(r) * ux * sh[s];
        const bool first = reset[c];
        reset[c] = false;
        const std::vector<int>& up = prev[s];
        std::vector<int>& o = cur[s];
        int ra = (d[0] + (first ? initial : up[0])) & 0xFFFF;
        o[0] = ra;
        for (int x = 1; x < dw; ++x) {
          int pr = ra;
          if (!first) {
            const int rb = up[x], rc = up[x - 1];
            switch (predictor) {
              case 2: pr = rb; break;
              case 3: pr = rc; break;
              case 4: pr = ra + rb - rc; break;
              case 5: pr = ra + ((rb - rc) >> 1); break;
              case 6: pr = rb + ((ra - rc) >> 1); break;
              case 7: pr = (ra + rb) >> 1; break;
              default: break;
            }
          }
          ra = (d[x] + pr) & 0xFFFF;
          o[x] = ra;
        }
        uint8_t* out = f.samples[c].data() + (static_cast<int64_t>(imcu) * f.vs[c] + r) * dw;
        for (int x = 0; x < dw; ++x) out[x] = static_cast<uint8_t>(o[x] << al);
        std::swap(prev[s], cur[s]);
      }
    }
  }
}

// libjpeg-turbo's block smoothing (jdcoefct.c `decompress_smooth_data`):
// for each estimated coefficient its zigzag index, natural position, the
// weights of the DC values of the 5x5 blocks around a block where some AC
// coefficient is known (none for zigzag 6-9), and where only DC is.
struct SmoothTerm {
  int k, pos;
  bool has_known;
  int known[25], dc_only[25];
};
const SmoothTerm kSmooth[9] = {
    {1, 1, true,
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3,
      -1, -1, 0, 1, 1}},
    {2, 8, true,
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
     {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1,
      1, 3, 3, 3, 1}},
    {3, 16, true,
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
     {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0}},
    {4, 9, true,
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
     {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1}},
    {5, 2, true,
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0}},
    {6, 3, false, {0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {7, 10, false, {0},
     {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0}},
    {8, 17, false, {0},
     {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}},
    {9, 24, false, {0},
     {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}},
};
// the DC's own estimate where only DC is known (the weights sum to 256)
const int kSmoothDc[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
                           -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};
const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int64_t mag = ((q << 7) + (num < 0 ? -num : num)) / (q << 8);
  if (al > 0 && mag >= (int64_t(1) << al)) mag = (int64_t(1) << al) - 1;
  return i16(static_cast<int>(num >= 0 ? mag : -mag));
}

// The block smoothing of component c's real blocks: `cur` and `prev` the
// latched bits (10 a component) of the last scan and before it, `good` the
// last iMCU row its data reached. Twin: `data/jpeg.py:smooth_blocks`.
void smooth_component(Frame& f, int c, const int* cur, const int* prev, int64_t good,
                      const int32_t* quant) {
  const int v = f.vs[c], R = (f.dh[c] + 7) / 8, C = (f.dw[c] + 7) / 8, last = f.my - 1;
  const int64_t pitch = f.bcol[c];
  const std::vector<int16_t> src = f.coef[c];  // the DC values before smoothing
  const int64_t q00 = quant[0];
  for (int r = 0; r < R; ++r) {
    const int im = r / v, br = r % v;
    const int here = im < last ? v : (R % v ? R % v : v);
    const int at = im * here + br, count = here * f.my;
    const int up1 = at > 0 ? r - 1 : r, up2 = at > 1 ? r - 2 : up1;
    const int dn1 = at < count - 1 ? r + 1 : r, dn2 = at < count - 2 ? r + 2 : dn1;
    const int rows[5] = {up2, up1, r, dn1, dn2};
    const int* cb = im > good ? prev : cur;
    bool dc_only = true;
    for (int k = 1; k < 10; ++k) dc_only = dc_only && cb[k] == -1;
    for (int col = 0; col < C; ++col) {
      int64_t D[25];
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j)
          D[5 * i + j] = src[(rows[i] * pitch + std::clamp(col + j - 2, 0, C - 1)) * 64];
      const int16_t* orig = src.data() + (r * pitch + col) * 64;
      int16_t* blk = f.coef[c].data() + (r * pitch + col) * 64;
      for (const SmoothTerm& t : kSmooth) {
        const int al = cb[t.k];
        if (al == 0 || orig[t.pos] != 0 || (!t.has_known && !dc_only)) continue;
        const int* w = dc_only ? t.dc_only : t.known;
        int64_t sum = 0;
        for (int n = 0; n < 25; ++n) sum += w[n] * D[n];
        blk[t.pos] = smooth_pred(q00 * sum, quant[t.pos], al);
      }
      if (dc_only) {
        int64_t sum = 0;
        for (int n = 0; n < 25; ++n) sum += kSmoothDc[n] * D[n];
        blk[0] = smooth_pred(q00 * sum, q00, 0);
      }
    }
  }
}

}  // namespace

extern "C" {

// JPEG decode of a parsed file into `out`: height x width x 3 BGR, or with
// `grey` height x width as libjpeg's JCS_GRAYSCALE output (the Y component
// alone of a YCbCr or grey file, rgb_gray_convert of an RGB one, OpenCV's
// grey of a CMYK or YCCK one). `data`: the scans' entropy-coded bytes end to
// end, each closed by a marker; `frame`: width, height, ncomp (1, 3 or 4),
// colour (`data/jpeg.py`'s), progressive, arithmetic, lossless, precision,
// then (h, v) of each component; `scans`: nscans rows of kScanFields ints
// (data offset, length, component count, four frame indices, Ss, Se, Ah,
// Al, restart interval, then for each of four scan components its DC and
// AC table numbers and arithmetic conditioning L, U, Kx); `quant`: ncomp x
// 64 latched tables in natural order; `huff`: per scan and scan component
// (4 slots) a DC then an AC table, each 16 code counts and 256 symbols
// (unread in an arithmetic-coded file). Returns 0, 1 on bad parameters, 2
// on a bad Huffman table, 3 on a fractional sampling ratio. Twin:
// `data/jpeg.py:decode_numpy`.
}  // extern "C"

namespace {

// The frame setup and every scan's entropy decode of `yp_jpeg_decode` (its
// arguments' meaning): the coefficient grids (or a lossless file's samples)
// in `f`, the latched successive-approximation bits, the scanned
// components and the MCU where the last scan's data ran out. Returns 0 or
// `yp_jpeg_decode`'s error status.
int jpeg_entropy(Frame& f, const uint8_t* data, const int32_t* frame, const int32_t* scans,
                 int nscans, const uint8_t* huff, int (&bits)[4][10], int (&prev)[4][10],
                 bool (&scanned)[4], int64_t& ran_out) {
  f.W = frame[0], f.H = frame[1], f.nc = frame[2], f.color = frame[3], f.progressive = frame[4];
  const bool arithmetic = frame[5] != 0;
  f.lossless = frame[6], f.precision = frame[7];
  const int nc = f.nc;
  const int block = f.lossless ? 1 : 8;  // a lossless file's "blocks" are samples
  if ((nc != 1 && nc != 3 && nc != 4 && !(nc == 2 && f.color == kJpegRaw)) || f.W <= 0 ||
      f.H <= 0 || nscans < 1)
    return 1;
  for (int c = 0; c < nc; ++c) {
    f.hs[c] = frame[8 + 2 * c];
    f.vs[c] = frame[9 + 2 * c];
    if (f.hs[c] < 1 || f.hs[c] > 4 || f.vs[c] < 1 || f.vs[c] > 4) return 1;
    f.hmax = std::max(f.hmax, f.hs[c]);
    f.vmax = std::max(f.vmax, f.vs[c]);
  }
  for (int c = 0; c < nc; ++c)
    if (f.hmax % f.hs[c] || f.vmax % f.vs[c]) return 3;
  if (f.lossless && (f.precision < 2 || f.precision > 8 || arithmetic || f.progressive)) return 1;
  f.mx = (f.W + block * f.hmax - 1) / (block * f.hmax);
  f.my = (f.H + block * f.vmax - 1) / (block * f.vmax);
  for (int c = 0; c < nc; ++c) {
    f.dh[c] = static_cast<int>((static_cast<int64_t>(f.H) * f.vs[c] + f.vmax - 1) / f.vmax);
    f.dw[c] = static_cast<int>((static_cast<int64_t>(f.W) * f.hs[c] + f.hmax - 1) / f.hmax);
    f.brow[c] = f.my * f.vs[c];
    f.bcol[c] = f.mx * f.hs[c];
    if (f.lossless)
      f.samples[c].assign(static_cast<size_t>(f.dh[c]) * f.dw[c], 0);
    else
      f.coef[c].assign(static_cast<size_t>(f.brow[c]) * f.bcol[c] * 64, 0);
  }
  std::vector<Huffman> tables(8);
  // the latched successive-approximation bits of zigzag 0-9 (-1: never
  // sent) after the last scan and before it (start_pass_phuff_decoder)
  std::fill(&bits[0][0], &bits[0][0] + 40, -1);
  std::fill(&prev[0][0], &prev[0][0] + 40, -1);
  std::fill(scanned, scanned + 4, false);
  ran_out = -1;
  for (int i = 0; i < nscans; ++i) {
    const int32_t* sc = scans + kScanFields * i;
    const int ns = sc[2];
    if (ns < 1 || ns > 4 || sc[0] < 0 || sc[1] < 0) return 1;
    int blocks = 0;
    for (int s = 0; s < ns; ++s) {
      if (sc[3 + s] < 0 || sc[3 + s] >= nc) return 1;
      for (int t = 0; t < s; ++t)
        if (sc[3 + t] == sc[3 + s]) return 1;
      blocks += f.hs[sc[3 + s]] * f.vs[sc[3 + s]];
    }
    if (ns > 1 && blocks > 10) return 1;
    const int ss = sc[7], se = sc[8], ah = sc[9], al = sc[10];
    if (f.progressive && ((ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
                          (ah && al != ah - 1) || al > 13 || al < 0))
      return 1;
    const int64_t row_mcus = ns == 1 ? f.dw[sc[3]] : f.mx;
    if (f.lossless && (ss < 1 || ss > 7 || se != 0 || ah != 0 || al < 0 || al >= f.precision ||
                       sc[11] % row_mcus))
      return 1;
    for (int s = 0; s < ns; ++s) {
      const int32_t* cd = sc + 12 + 5 * s;  // DC, AC table numbers; L, U, Kx
      if (cd[0] < 0 || cd[0] > 15 || cd[1] < 0 || cd[1] > 15 || cd[2] < 0 || cd[2] > cd[3] ||
          cd[3] > 15 || cd[4] < 0 || cd[4] > 255)
        return 1;
      for (int t = 0; t < 2 && !arithmetic; ++t) {
        const uint8_t* h = huff + ((static_cast<int64_t>(i) * 4 + s) * 2 + t) * (16 + 256);
        if (!tables[2 * s + t].build(h, h + 16, t ? 255 : f.lossless ? 16 : 15)) return 2;
      }
    }
    for (int s = 0; s < ns; ++s) {
      const int c = sc[3 + s];
      scanned[c] = true;
      for (int k = std::min(ss, 1); k <= std::min(std::max(se, 9), 9); ++k)
        prev[c][k] = i ? bits[c][k] : 0;
      for (int k = ss; k <= std::min(se, 9); ++k) bits[c][k] = al;
    }
    if (f.lossless)
      decode_scan_lossless(f, data, sc, tables.data());
    else if (arithmetic)
      decode_scan_arith(f, data, sc);  // never out of data: a marker reads as zeros
    else
      ran_out = decode_scan(f, data, sc, tables.data());
  }
  return 0;
}

}  // namespace

extern "C" {

int yp_jpeg_decode(const uint8_t* data, const int32_t* frame, const int32_t* scans, int nscans,
                   const int32_t* quant, const uint8_t* huff, int grey, uint8_t* out) {
  Frame f;
  int bits[4][10], prev[4][10];
  bool scanned[4];
  int64_t ran_out;
  if (const int status = jpeg_entropy(f, data, frame, scans, nscans, huff, bits, prev, scanned,
                                      ran_out))
    return status;
  const int nc = f.nc;
  // libjpeg-turbo smooths the blocks of a progressive file whose zigzag 1-9
  // are not all complete (smoothing_ok)
  bool smooth = f.progressive != 0;
  for (int c = 0; c < nc && smooth; ++c) {
    smooth = scanned[c] && bits[c][0] >= 0;
    for (int k = 0; k < 10 && smooth; ++k) smooth = quant[64 * c + kSmoothPos[k]] != 0;
  }
  bool useful = false;
  for (int c = 0; c < nc; ++c)
    for (int k = 1; k < 10; ++k) useful = useful || bits[c][k] != 0;
  if (smooth && useful) {
    if (nscans == 1) std::fill(&prev[0][0], &prev[0][0] + 40, -1);
    const int32_t* last = scans + kScanFields * (nscans - 1);
    int64_t good = f.my - 1;  // the last iMCU row the last scan's data reached
    if (ran_out >= 0) {
      if (last[2] > 1) {
        good = ran_out / f.mx;
      } else {
        const int c = last[3];
        good = ran_out / ((f.dw[c] + 7) / 8) / f.vs[c];
      }
    }
    for (int c = 0; c < (grey && f.color != kJpegRgb && nc < 4 ? 1 : nc); ++c)
      smooth_component(f, c, bits[c], prev[c], good, quant + 64 * c);
  }
  // IDCT into the component planes (those the output needs; a lossless
  // file's are its samples), upsampling, colour conversion
  const int needed = grey && f.color != kJpegRgb && nc < 4 ? 1 : nc;
  std::vector<std::vector<uint8_t>> full(needed);
  std::vector<uint8_t> plane;
  for (int c = 0; c < needed; ++c) {
    int64_t pitch = f.dw[c];
    if (!f.lossless) {
      pitch = static_cast<int64_t>(f.bcol[c]) * 8;
      const int rows = std::min(f.brow[c], (f.dh[c] + 7) / 8);
      plane.assign(static_cast<size_t>(f.brow[c]) * 8 * pitch, 0);
      for (int r = 0; r < rows; ++r)
        for (int bc = 0; bc < f.bcol[c] && bc * 8 < f.dw[c]; ++bc)
          idct_block(f.coef[c].data() + (static_cast<int64_t>(r) * f.bcol[c] + bc) * 64,
                     quant + 64 * c, plane.data() + r * 8 * pitch + bc * 8, pitch);
    }
    full[c].resize(static_cast<size_t>(f.H) * f.W);
    upsample_plane(f.lossless ? f.samples[c].data() : plane.data(), pitch, f.dh[c], f.dw[c],
                   f.hmax / f.hs[c], f.vmax / f.vs[c], full[c].data(), f.H, f.W, !f.lossless);
  }
  const int64_t n = static_cast<int64_t>(f.H) * f.W;
  if (f.color == kJpegRaw && !grey) {
    for (int64_t i = 0; i < n; ++i)
      for (int c = 0; c < nc; ++c) out[nc * i + c] = full[c][i];
  } else if (nc == 4) {
    // libjpeg-turbo's CMYK output (null_convert of CMYK; ycck_cmyk_convert of
    // YCCK: 255 - each range-limited YCbCr-to-RGB value, K as it is), then
    // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, k - ((255 - x) * k >> 8) of C, M, Y,
    // or icvCvt_CMYK2Gray_8u_C4C1R of that BGR (14-bit weights, rounded)
    const uint8_t *P0 = full[0].data(), *P1 = full[1].data(), *P2 = full[2].data();
    const uint8_t* K = full[3].data();
    for (int64_t i = 0; i < n; ++i) {
      int c = P0[i], m = P1[i], y = P2[i];
      const int k = K[i];
      if (f.color == kJpegYcck) {
        const int yy = P0[i], xb = P1[i] - 128, xr = P2[i] - 128;
        c = 255 - std::clamp(yy + ((91881 * xr + 32768) >> 16), 0, 255);
        m = 255 - std::clamp(yy + ((-22554 * xb + 32768 - 46802 * xr) >> 16), 0, 255);
        y = 255 - std::clamp(yy + ((116130 * xb + 32768) >> 16), 0, 255);
      }
      const int r = k - ((255 - c) * k >> 8), g = k - ((255 - m) * k >> 8),
                b = k - ((255 - y) * k >> 8);
      if (grey) {
        out[i] = static_cast<uint8_t>((1868 * b + 9617 * g + 4899 * r + (1 << 13)) >> 14);
      } else {
        out[3 * i] = static_cast<uint8_t>(b);
        out[3 * i + 1] = static_cast<uint8_t>(g);
        out[3 * i + 2] = static_cast<uint8_t>(r);
      }
    }
  } else if (grey) {
    if (needed == 1) {
      std::memcpy(out, full[0].data(), n);
    } else {  // rgb_gray_convert: build_rgb_y_table's weights, the half on blue
      const uint8_t *R = full[0].data(), *G = full[1].data(), *B = full[2].data();
      for (int64_t i = 0; i < n; ++i)
        out[i] = static_cast<uint8_t>((19595 * R[i] + 38470 * G[i] + 7471 * B[i] + 32768) >> 16);
    }
  } else if (f.color == kJpegGrey || nc == 1) {
    for (int64_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
  } else if (f.color == kJpegRgb) {
    for (int64_t i = 0; i < n; ++i) {
      out[3 * i] = full[2][i];
      out[3 * i + 1] = full[1][i];
      out[3 * i + 2] = full[0][i];
    }
  } else {
    // the entries of build_ycc_rgb_table (SCALEBITS 16, ONE_HALF 1 << 15),
    // computed in place of the lookups: the same integers, and a loop the
    // compiler vectorizes (|products| < 2^24)
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (int64_t i = 0; i < n; ++i) {
      const int y = Y[i], xb = Cb[i] - 128, xr = Cr[i] - 128;
      out[3 * i] = static_cast<uint8_t>(std::clamp(y + ((116130 * xb + 32768) >> 16), 0, 255));
      out[3 * i + 1] = static_cast<uint8_t>(
          std::clamp(y + ((-22554 * xb + 32768 - 46802 * xr) >> 16), 0, 255));
      out[3 * i + 2] = static_cast<uint8_t>(std::clamp(y + ((91881 * xr + 32768) >> 16), 0, 255));
    }
  }
  return 0;
}

// The quantized coefficients of a sequential or progressive DCT file after
// all its scans (`yp_jpeg_decode`'s arguments), without smoothing: each
// component's grid of blocks in turn, int16 in natural order, into `out`.
// Returns 0 or `yp_jpeg_decode`'s error status (1 for a lossless file).
// Twin: `data/jpeg.py:entropy_decode_numpy`.
int yp_jpeg_coefficients(const uint8_t* data, const int32_t* frame, const int32_t* scans,
                         int nscans, const uint8_t* huff, int16_t* out) {
  if (frame[6]) return 1;
  Frame f;
  int bits[4][10], prev[4][10];
  bool scanned[4];
  int64_t ran_out;
  if (const int status = jpeg_entropy(f, data, frame, scans, nscans, huff, bits, prev, scanned,
                                      ran_out))
    return status;
  for (int c = 0; c < f.nc; ++c) {
    std::memcpy(out, f.coef[c].data(), f.coef[c].size() * sizeof(int16_t));
    out += f.coef[c].size();
  }
  return 0;
}

}  // extern "C"

// JPEG encode: the entropy-coded scan data that libjpeg-turbo writes for
// `cv2.imencode(".jpg", img)` (4:2:0 for a BGR image, one component for a
// grey one; the Annex K Huffman tables; no restarts), stuffed and filled
// with 1-bits to a byte. `img`: height x width x channels (1 or 3, BGR);
// `quant`: two 64-entry tables in natural order. Returns the byte count,
// -1 on bad parameters, -2 if `cap` is too small. The steps and their
// numpy twins are in `data/jpeg.py` (`encode_blocks`,
// `entropy_encode_numpy`).
namespace {

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
                                {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct HuffCodes {
  uint32_t code[256];
  int len[256];
};

// Canonical codes of a table (`jpeg_make_c_derived_tbl`).
void make_codes(const uint8_t* bits, const uint8_t* vals, HuffCodes* t) {
  std::memset(t, 0, sizeof(*t));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      t->code[vals[k]] = code++;
      t->len[vals[k]] = l;
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool overflow = false;

  void put_byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }
  void put(uint32_t v, int len) {
    acc = (acc << len) | (v & ((1u << len) - 1));
    nacc += len;
    while (nacc >= 8) {
      nacc -= 8;
      put_byte(static_cast<uint8_t>(acc >> nacc));
    }
  }
  void flush() {
    if (nacc) put((1u << (8 - nacc)) - 1, 8 - nacc);
  }
};

int nbits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// `jpeg_fdct_islow`, in place on level-shifted samples (natural order).
void fdct_islow(int32_t* d) {
  const int64_t c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270, c0899 = 7373,
                c1175 = 9633, c1501 = 12299, c1847 = 15137, c1961 = 16069, c2053 = 16819,
                c2562 = 20995, c3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int shift = pass == 0 ? 11 : 15;
    for (int i = 0; i < 8; ++i) {
      const int step = pass == 0 ? 1 : 8;
      int32_t* p = pass == 0 ? d + 8 * i : d + i;
      auto descale = [](int64_t v, int n) { return static_cast<int32_t>((v + (int64_t(1) << (n - 1))) >> n); };
      int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (pass == 0) {
        p[0] = static_cast<int32_t>((t10 + t11) * 4);
        p[4 * step] = static_cast<int32_t>((t10 - t11) * 4);
      } else {
        p[0] = descale(t10 + t11, 2);
        p[4 * step] = descale(t10 - t11, 2);
      }
      int64_t z1 = (t12 + t13) * c0541;
      p[2 * step] = descale(z1 + t13 * c0765, shift);
      p[6 * step] = descale(z1 - t12 * c1847, shift);
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      const int64_t z5 = (z3 + z4) * c1175;
      t4 *= c0298;
      t5 *= c2053;
      t6 *= c3072;
      t7 *= c1501;
      z1 *= -c0899;
      z2 *= -c2562;
      z3 = z3 * -c1961 + z5;
      z4 = z4 * -c0390 + z5;
      p[7 * step] = descale(t4 + z1 + z3, shift);
      p[5 * step] = descale(t5 + z2 + z4, shift);
      p[3 * step] = descale(t6 + z2 + z3, shift);
      p[step] = descale(t7 + z1 + z4, shift);
    }
  }
}

struct Divisor {
  int64_t recip, corr;
  int shift;
};

// `compute_reciprocal` for a 16-bit `DCTELEM`.
Divisor reciprocal(int64_t d) {
  int b = 0;
  while ((d >> (b + 1)) != 0) ++b;
  int r = 16 + b;
  int64_t fq = (int64_t(1) << r) / d, fr = (int64_t(1) << r) % d, c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= d / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r - 16};
}

// One block: rows y0.., columns x0.. of a plane padded to cover it, FDCT,
// quantized into `q` (natural order).
void code_block(const int32_t* plane, int stride, int y0, int x0, const Divisor* div,
                int32_t* q) {
  int32_t d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[8 * r + c] = plane[(y0 + r) * stride + x0 + c] - 128;
  fdct_islow(d);
  for (int k = 0; k < 64; ++k) {
    const int64_t a = d[k] < 0 ? -int64_t(d[k]) : d[k];
    const int32_t m = static_cast<int32_t>(((a + div[k].corr) * div[k].recip) >> (16 + div[k].shift));
    q[k] = d[k] < 0 ? -m : m;
  }
}

void emit_block(BitWriter& bw, const int32_t* q, int* last_dc, const HuffCodes& dc,
                const HuffCodes& ac) {
  const int diff = q[0] - *last_dc;
  *last_dc = q[0];
  int s = nbits(diff);
  bw.put(dc.code[s], dc.len[s]);
  if (s) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = q[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.len[0xF0]);
      run -= 16;
    }
    s = nbits(v);
    const int sym = (run << 4) | s;
    bw.put(ac.code[sym], ac.len[sym]);
    bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.len[0]);
}

}  // namespace

extern "C" int yp_jpeg_encode(const uint8_t* img, int H, int W, int channels,
                              const int32_t* quant, uint8_t* out, int64_t cap) {
  if (H <= 0 || W <= 0 || (channels != 1 && channels != 3)) return -1;
  HuffCodes dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    uint8_t dc_vals[12];
    for (int i = 0; i < 12; ++i) dc_vals[i] = static_cast<uint8_t>(i);
    make_codes(kDcBits[t], dc_vals, &dc[t]);
    make_codes(kAcBits[t], kAcVals[t], &ac[t]);
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 64; ++k) div[t][k] = reciprocal(int64_t(quant[64 * t + k]) * 8);
  BitWriter bw{out, cap};
  int32_t q[64];
  if (channels == 1) {
    const int hb = (H + 7) / 8, wb = (W + 7) / 8, PW = wb * 8, PH = hb * 8;
    std::vector<int32_t> plane(static_cast<size_t>(PH) * PW);
    for (int y = 0; y < PH; ++y)
      for (int x = 0; x < PW; ++x)
        plane[static_cast<size_t>(y) * PW + x] = img[static_cast<size_t>(std::min(y, H - 1)) * W + std::min(x, W - 1)];
    int last = 0;
    for (int by = 0; by < hb; ++by)
      for (int bx = 0; bx < wb; ++bx) {
        code_block(plane.data(), PW, by * 8, bx * 8, div[0], q);
        emit_block(bw, q, &last, dc[0], ac[0]);
      }
  } else {
    // rgb_ycc_convert's fixed-point tables (SCALEBITS 16)
    auto fix = [](double v) { return static_cast<int64_t>(v * 65536.0 + 0.5); };
    const int64_t half = 1 << 15, offset = int64_t(128) << 16;
    const int my = (H + 15) / 16, mx = (W + 15) / 16, hy = (H + 7) / 8, wy = (W + 7) / 8;
    const int YW = wy * 8, YH = hy * 8, CW = mx * 16, CH = H + (H & 1);
    std::vector<int32_t> Y(static_cast<size_t>(YH) * YW), cb(static_cast<size_t>(CH) * CW),
        cr(static_cast<size_t>(CH) * CW);
    for (int y = 0; y < std::max(YH, CH); ++y) {
      const uint8_t* row = img + static_cast<size_t>(std::min(y, H - 1)) * W * 3;
      for (int x = 0; x < std::max(YW, CW); ++x) {
        const uint8_t* px = row + 3 * std::min(x, W - 1);
        const int64_t b = px[0], g = px[1], r = px[2];
        if (y < YH && x < YW)
          Y[static_cast<size_t>(y) * YW + x] = static_cast<int32_t>((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16);
        if (y < CH && x < CW) {
          cb[static_cast<size_t>(y) * CW + x] = static_cast<int32_t>((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16);
          cr[static_cast<size_t>(y) * CW + x] = static_cast<int32_t>((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16);
        }
      }
    }
    // h2v2_downsample, then the rows replicated to the full MCU height
    const int SW = mx * 8, SH = my * 8, rows = CH / 2;
    std::vector<int32_t> sub[2] = {std::vector<int32_t>(static_cast<size_t>(SH) * SW),
                                   std::vector<int32_t>(static_cast<size_t>(SH) * SW)};
    for (int c = 0; c < 2; ++c) {
      const std::vector<int32_t>& src = c == 0 ? cb : cr;
      for (int y = 0; y < SH; ++y) {
        const int sy = std::min(y, rows - 1);
        const int32_t* r0 = src.data() + static_cast<size_t>(2 * sy) * CW;
        const int32_t* r1 = r0 + CW;
        for (int x = 0; x < SW; ++x)
          sub[c][static_cast<size_t>(y) * SW + x] = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + 1 + (x & 1)) >> 2;
      }
    }
    int last[3] = {0, 0, 0};
    int32_t blk[4][64];
    for (int m = 0; m < my; ++m)
      for (int n = 0; n < mx; ++n) {
        for (int i = 0; i < 4; ++i) {
          const int by = 2 * m + i / 2, bx = 2 * n + i % 2;
          if (by < hy && bx < wy) {
            code_block(Y.data(), YW, by * 8, bx * 8, div[0], blk[i]);
          } else {  // a dummy block: zero AC, the DC of the block before it
            std::memset(blk[i], 0, sizeof(blk[i]));
            blk[i][0] = by < hy ? blk[i - 1][0] : blk[1][0];
          }
          emit_block(bw, blk[i], &last[0], dc[0], ac[0]);
        }
        for (int c = 0; c < 2; ++c) {
          code_block(sub[c].data(), SW, m * 8, n * 8, div[1], q);
          emit_block(bw, q, &last[1 + c], dc[1], ac[1]);
        }
      }
  }
  bw.flush();
  return bw.overflow ? -2 : static_cast<int>(bw.n);
}

// ---- grey reads, the covariance of object messages, run-length BMP -------

extern "C" {

// Grey of n colour pixels as each decoder that `cv2.imread(...,
// IMREAD_GRAYSCALE)` runs computes it. kind 0: libpng's rgb_to_gray of
// 8-bit RGB (`png_set_rgb_to_gray(png, 1, 0.299, 0.587)`: the weights
// 29900 * 32768 / 100000 and 58700 * 32768 / 100000 truncated, blue the
// rest of 32768; the sum truncated by 15 bits); kind 1: the same of 16-bit
// big-endian RGB, rounded, then its high byte (`png_set_strip_16`); kind 2:
// OpenCV's `icvCvt_BGR2Gray_8u_C3C1R` of BGR (the BMP and PxM decoders:
// weights of 14 bits, rounded); kind 3: libpng's gamma-corrected path of
// 8-bit RGB (a file with a significant gAMA or an sRGB chunk), through
// `tables` (256 entries each: gamma_to_1, gamma_from_1, and gamma_table for
// grey pixels): a pixel whose three samples differ is
// from_1[(weights . to_1[rgb] + 16384) >> 15]; kind 4: the same of 16-bit
// big-endian RGB through libpng's 16-bit tables (`tables`: 3 x 65536 u16
// lookups by the 16-bit value, gamma_16_to_1, gamma_16_from_1 and
// gamma_16_table), then the high byte; kind 5: OpenCV's
// `cvtColor(COLOR_BGR2GRAY)` of 8-bit BGR (weights of 15 bits, rounded: the
// Radiance, GIF and TIFF decoders' grey). Returns 0, 1 on an unknown kind.
// Twins: `data/native.py` (`png_rgb_to_grey`, `cv_bgr_to_grey`,
// `cv_cvt_bgr_to_grey`).
int yp_grey_u8(const uint8_t* src, int64_t n, int kind, const uint8_t* tables, uint8_t* out) {
  if (kind == 3) {
    const uint8_t *to1 = tables, *from1 = tables + 256, *same = tables + 512;
    for (int64_t i = 0; i < n; ++i, src += 3) {
      const uint32_t r = src[0], g = src[1], b = src[2];
      out[i] = r == g && r == b
                   ? same[r]
                   : from1[(9797u * to1[r] + 19234u * to1[g] + 3737u * to1[b] + 16384u) >> 15];
    }
  } else if (kind == 0) {
    for (int64_t i = 0; i < n; ++i, src += 3)
      out[i] = static_cast<uint8_t>((9797u * src[0] + 19234u * src[1] + 3737u * src[2]) >> 15);
  } else if (kind == 1) {
    for (int64_t i = 0; i < n; ++i, src += 6) {
      const uint32_t r = (src[0] << 8) | src[1], g = (src[2] << 8) | src[3],
                     b = (src[4] << 8) | src[5];
      const uint32_t grey16 = (9797u * r + 19234u * g + 3737u * b + 16384u) >> 15;
      out[i] = static_cast<uint8_t>(grey16 >> 8);
    }
  } else if (kind == 2) {
    for (int64_t i = 0; i < n; ++i, src += 3)
      out[i] = static_cast<uint8_t>((1868u * src[0] + 9617u * src[1] + 4899u * src[2] + 8192u) >> 14);
  } else if (kind == 5) {
    for (int64_t i = 0; i < n; ++i, src += 3)
      out[i] = static_cast<uint8_t>((3735u * src[0] + 19235u * src[1] + 9798u * src[2] + 16384u) >> 15);
  } else if (kind == 4) {
    // 16-bit RGB through libpng's 16-bit gamma tables, each a lookup by the
    // 16-bit value (gamma_16_to_1, gamma_16_from_1, gamma_16_table), then
    // the high byte
    auto lookup = [tables](int which, uint32_t v) -> uint32_t {
      uint16_t w;
      std::memcpy(&w, tables + 2 * (static_cast<size_t>(which) * 65536 + v), 2);
      return w;
    };
    for (int64_t i = 0; i < n; ++i, src += 6) {
      const uint32_t r = (src[0] << 8) | src[1], g = (src[2] << 8) | src[3],
                     b = (src[4] << 8) | src[5];
      uint32_t w;
      if (r == g && r == b) {
        w = lookup(2, r);
      } else {
        const uint32_t grey16 =
            (9797u * lookup(0, r) + 19234u * lookup(0, g) + 3737u * lookup(0, b) + 16384u) >> 15;
        w = lookup(1, grey16);
      }
      out[i] = static_cast<uint8_t>(w >> 8);
    }
  } else {
    return 1;
  }
  return 0;
}

// Full row-major n x n -> the upper triangle packed row by row ((0, 0),
// (0, 1) .. (0, n - 1), (1, 1), ..), as `covariance_helper.h` packs the
// covariance of an object message. Returns 0.
int yp_cov_pack_upper(const float* full, int n, float* packed) {
  int64_t k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j) packed[k++] = full[static_cast<int64_t>(i) * n + j];
  return 0;
}

// The packed upper triangle -> the full symmetric row-major matrix. Returns 0.
int yp_cov_unpack_upper(const float* packed, int n, float* full) {
  int64_t k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j, ++k)
      full[static_cast<int64_t>(i) * n + j] = full[static_cast<int64_t>(j) * n + i] = packed[k];
  return 0;
}

}  // extern "C"

namespace {

// The pixel cursor of OpenCV's BMP decoder (`FillUniColor`): a row `y` in
// file order (the first row the bottom one of a bottom-up file) and a
// column `x`; a fill runs on into the next row.
struct RleCursor {
  uint8_t* out;
  const uint8_t* pal;
  int W, H, x = 0, y = 0;
  bool bottom_up;

  uint8_t* pixel(int col) {
    const int row = bottom_up ? H - 1 - y : y;
    return out + (static_cast<int64_t>(row) * W + col) * 3;
  }
  void put(int col, int index) { std::memcpy(pixel(col), pal + 3 * index, 3); }
  void fill(int64_t count, int index) {
    do {
      const int64_t end = std::min<int64_t>(x + count, W);
      count -= end - x;
      for (; x < end; ++x) put(x, index);
      if (x >= W) {
        x = 0;
        if (++y >= H) break;
      }
    } while (count > 0);
  }
};

}  // namespace

extern "C" {

// Run-length BMP pixels (BI_RLE8 at bpp 8, BI_RLE4 at bpp 4) from `data`
// (`len` bytes from the pixel offset) into `out` (height x width x 3 BGR)
// through `palette` (256 BGR entries), as OpenCV's `BmpDecoder::readData`
// reads them: an encoded run must fit in its row (and in RLE8 ends the row
// where it reaches its end); an absolute run likewise, padded to a word;
// end-of-line fills the rest of the row with palette entry 0 (in RLE8 not
// after a run that ended the row); in RLE8 a delta fills dx + dy * width
// pixels with entry 0 in row order and end-of-bitmap the rest of the
// image; in RLE4 a delta fills dx pixels and end-of-bitmap ends the row as
// end-of-line does, the codes going on to the last row. Returns 0, 1 on bad
// parameters, 2 where a run does not fit its row (OpenCV stops there, the
// rest of its image unset), 3 where the data ends first (OpenCV: None).
// Twin: `data/bmp.py:rle_numpy`.
int yp_bmp_rle(const uint8_t* data, int64_t len, int bpp, int W, int H, int bottom_up,
               const uint8_t* palette, uint8_t* out) {
  if ((bpp != 4 && bpp != 8) || W <= 0 || H <= 0) return 1;
  RleCursor c{out, palette, W, H};
  c.bottom_up = bottom_up != 0;
  int64_t p = 0;
  bool line_end_flag = false;
  for (;;) {
    if (p + 2 > len) return 3;
    const int n = data[p], code = data[p + 1];
    p += 2;
    if (n) {  // encoded run
      if (c.x + n > W) return 2;
      if (bpp == 8) {
        const int y0 = c.y;
        c.fill(n, code);
        line_end_flag = c.y != y0;
        if (c.y >= H) break;
      } else {
        for (int i = 0; i < n; ++i) c.put(c.x + i, i & 1 ? code & 15 : code >> 4);
        c.x += n;
      }
    } else if (code > 2) {  // absolute run
      if (c.x + code > W) return 2;
      const int64_t size = bpp == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
      if (p + size > len) return 3;
      for (int i = 0; i < code; ++i) {
        const int b = bpp == 8 ? data[p + i] : data[p + (i >> 1)];
        c.put(c.x + i, bpp == 8 ? b : (i & 1 ? b & 15 : b >> 4));
      }
      c.x += code;
      p += size;
      line_end_flag = false;
    } else {  // end of line (0), end of bitmap (1), delta (2)
      int64_t dx = W - c.x, dy = H - c.y;
      if (bpp == 4 || code || !line_end_flag || dx < W) {
        if (code == 2) {
          if (p + 2 > len) return 3;
          dx = data[p];
          dy = data[p + 1];
          p += 2;
        }
        if (c.y >= H) break;
        // RLE8: a delta moves on by dy rows too, end-of-bitmap fills the
        // rest of the image; RLE4: a delta skips dx pixels, end-of-bitmap
        // ends the row as end-of-line does, and the codes go on
        c.fill(dx + (bpp == 8 && code ? dy * W : 0), 0);
        if (c.y >= H) break;
      }
      line_end_flag = false;
      if (c.y >= H) break;
    }
  }
  return 0;
}

}  // extern "C"

namespace {

// OpenCV 5 computes a row's source coordinates 16 pixels at a time in vector
// code and the rest of the row in scalar code built with FMA contraction:
// `fma(x, a, y * b + c)` against `fma(x, a, y * b) + c`, in f32.
constexpr int kCvVectorPixels = 16;

inline float cv_coord(int x, int y, float a, float b, float c, int vector_end) {
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  return x < vector_end ? std::fma(fx, a, fy * b + c) : std::fma(fx, a, fy * b) + c;
}

// An f32 through `std::floor` / `std::nearbyint` as an int32 conversion
// gives it: out of range or NaN is INT_MIN, outside every image.
inline int64_t cv_int(float r) {
  return (r >= -2147483648.0f && r < 2147483648.0f) ? static_cast<int64_t>(r) : INT32_MIN;
}

inline int64_t cv_reflect(int64_t p, int64_t n) {
  if (n == 1) return 0;
  int64_t q = p % (2 * n);
  if (q < 0) q += 2 * n;
  return q >= n ? 2 * n - 1 - q : q;
}

}  // namespace

extern "C" {

// dst (H, W, c) u8 = src (sh, sw, c) u8 at minv (x, y, 1), bilinear; a tap
// outside the source reads 0. `minv` is the inverse map in f32 (row-major
// 3x3).
int yp_cv_warp_perspective_u8(const uint8_t* src, int sh, int sw, int c, const float* minv,
                              uint8_t* dst, int H, int W) {
  if (sh < 1 || sw < 1 || c < 1 || H < 0 || W < 0) return 1;
  const int vend = (W / kCvVectorPixels) * kCvVectorPixels;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const float w = cv_coord(x, y, minv[6], minv[7], minv[8], vend);
      const float sx = cv_coord(x, y, minv[0], minv[1], minv[2], vend) / w;
      const float sy = cv_coord(x, y, minv[3], minv[4], minv[5], vend) / w;
      const int64_t ix = cv_int(std::floor(sx)), iy = cv_int(std::floor(sy));
      const float dx = sx - static_cast<float>(ix), dy = sy - static_cast<float>(iy);
      uint8_t* out = dst + (static_cast<int64_t>(y) * W + x) * c;
      for (int k = 0; k < c; ++k) {
        float p[2][2];
        for (int j = 0; j < 2; ++j) {
          for (int i = 0; i < 2; ++i) {
            const int64_t py = iy + j, px = ix + i;
            p[j][i] = (px >= 0 && px < sw && py >= 0 && py < sh)
                          ? static_cast<float>(src[(py * sw + px) * c + k]) : 0.0f;
          }
        }
        const float v0 = std::fma(dx, p[0][1] - p[0][0], p[0][0]);
        const float v1 = std::fma(dx, p[1][1] - p[1][0], p[1][0]);
        const float v = std::nearbyint(std::fma(dy, v1 - v0, v0));
        out[k] = static_cast<uint8_t>(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
      }
    }
  }
  return 0;
}

// dst (H, W, c) u8 = src (sh, sw, c) u8 at m (x, y, 1), nearest (half to
// even), the index reflected (`BORDER_REFLECT`). `m` holds the 2x3 map in its
// first 6 of 9 f32 values.
int yp_cv_warp_affine_u8(const uint8_t* src, int sh, int sw, int c, const float* m,
                         uint8_t* dst, int H, int W) {
  if (sh < 1 || sw < 1 || c < 1 || H < 0 || W < 0) return 1;
  const int vend = (W / kCvVectorPixels) * kCvVectorPixels;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const float sx = cv_coord(x, y, m[0], m[1], m[2], vend);
      const float sy = cv_coord(x, y, m[3], m[4], m[5], vend);
      const int64_t ix = cv_reflect(cv_int(std::nearbyint(sx)), sw);
      const int64_t iy = cv_reflect(cv_int(std::nearbyint(sy)), sh);
      std::memcpy(dst + (static_cast<int64_t>(y) * W + x) * c, src + (iy * sw + ix) * c, c);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// OpenCV's RANSAC homography (`cv2.findHomography(src, dst, cv2.RANSAC)` of
// OpenCV 5.0): the classic registrator's draws, subset checks, normalised DLT
// and f32 inlier test, the DLT refitted and refined by Levenberg-Marquardt on
// the inliers, the mask recomputed from the final H. Every sum runs in point
// order and nothing is fused, as in the numpy twin
// (`evaluation/homography_ransac.py`), which gives the same bits.

namespace {

constexpr double kDblEps = 2.220446049250313e-16;    // DBL_EPSILON
constexpr double kFltEps = 1.1920928955078125e-07;   // FLT_EPSILON
constexpr double kDblMin = 2.2250738585072014e-308;  // DBL_MIN
constexpr int kRansacAttempts = 10000;
constexpr int kLmIterations = 10;

// cv::RNG: multiply-with-carry on a 64-bit state
struct CvRng {
  uint64_t state = ~0ull;
  uint32_t next() {
    state = static_cast<uint64_t>(static_cast<uint32_t>(state)) * 4164903690ull + (state >> 32);
    return static_cast<uint32_t>(state);
  }
  int uniform(int n) { return static_cast<int>(next() % static_cast<uint32_t>(n)); }
};

// haveCollinearPoints(p, 4): the last point on a line through two others
bool hg_collinear(const float* p) {
  for (int j = 0; j < 3; ++j) {
    const double dx1 = p[2 * j] - p[6], dy1 = p[2 * j + 1] - p[7];
    for (int k = 0; k < j; ++k) {
      const double dx2 = p[2 * k] - p[6], dy2 = p[2 * k + 1] - p[7];
      if (std::fabs(dx2 * dy1 - dy2 * dx1) <=
          kFltEps * (std::fabs(dx1) + std::fabs(dy1) + std::fabs(dx2) + std::fabs(dy2)))
        return true;
    }
  }
  return false;
}

// determinant(Matx33d) of the rows (x, y, 1) of points a, b, c
double hg_det3(const float* p, int a, int b, int c) {
  const double a0 = p[2 * a], a1 = p[2 * a + 1], b0 = p[2 * b], b1 = p[2 * b + 1];
  const double c0 = p[2 * c], c1 = p[2 * c + 1];
  return a0 * (b1 * 1.0 - c1 * 1.0) - a1 * (b0 * 1.0 - c0 * 1.0) + 1.0 * (b0 * c1 - c0 * b1);
}

// checkSubset of four drawn pairs
bool hg_subset_ok(const float* s, const float* d) {
  static const int kTriples[4][3] = {{0, 1, 2}, {1, 2, 3}, {0, 2, 3}, {0, 1, 3}};
  if (hg_collinear(s) || hg_collinear(d)) return false;
  int negative = 0;
  for (const auto& t : kTriples)
    negative += hg_det3(s, t[0], t[1], t[2]) * hg_det3(d, t[0], t[1], t[2]) < 0;
  return negative == 0 || negative == 4;
}

// The eigenvector of the smallest eigenvalue of a symmetric 9x9 matrix by
// cyclic Jacobi (OpenCV's rotation, its hypot as a square root of squares,
// the diagonal kept apart).
void hg_jacobi_smallest(double a[9][9], double out[9]) {
  double w[9], v[9][9];
  for (int i = 0; i < 9; ++i) {
    w[i] = a[i][i];
    for (int j = 0; j < 9; ++j) v[i][j] = i == j ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < 30; ++sweep) {
    bool any = false;
    for (int p = 0; p < 8; ++p)
      for (int q = p + 1; q < 9; ++q) any = any || std::fabs(a[p][q]) > kDblEps;
    if (!any) break;
    for (int p = 0; p < 8; ++p) {
      for (int q = p + 1; q < 9; ++q) {
        const double apq = a[p][q];
        if (!(std::fabs(apq) > kDblEps)) continue;
        const double y = (w[q] - w[p]) * 0.5;
        double t = std::fabs(y) + std::sqrt(apq * apq + y * y);
        double s = std::sqrt(apq * apq + t * t);
        const double c = t / s;
        s = apq / s;
        t = (apq / t) * apq;
        if (y < 0) {
          s = -s;
          t = -t;
        }
        w[p] -= t;
        w[q] += t;
        for (int i = 0; i < 9; ++i) {
          if (i == p || i == q) continue;
          const double a0 = a[p][i], b0 = a[q][i];
          a[p][i] = a[i][p] = a0 * c - b0 * s;
          a[q][i] = a[i][q] = a0 * s + b0 * c;
        }
        a[p][q] = a[q][p] = 0.0;
        for (int i = 0; i < 9; ++i) {
          const double v0 = v[p][i], v1 = v[q][i];
          v[p][i] = v0 * c - v1 * s;
          v[q][i] = v0 * s + v1 * c;
        }
      }
    }
  }
  int best = 0;
  for (int i = 1; i < 9; ++i)
    if (w[i] < w[best]) best = i;
  for (int i = 0; i < 9; ++i) out[i] = v[best][i];
}

void hg_matmul3(const double* a, const double* b, double* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j];
}

// HomographyEstimatorCallback::runKernel on count pairs: false where the
// points do not spread.
bool hg_dlt(const float* src, const float* dst, int count, double h[9]) {
  auto at = [](const float* p, int i, int k) -> double { return p[2 * i + k]; };
  double cm[2] = {0, 0}, cb[2] = {0, 0}, sm[2] = {0, 0}, sb[2] = {0, 0};
  for (int i = 0; i < count; ++i)
    for (int k = 0; k < 2; ++k) {
      cm[k] += at(dst, i, k);
      cb[k] += at(src, i, k);
    }
  for (int k = 0; k < 2; ++k) {
    cm[k] /= count;
    cb[k] /= count;
  }
  for (int i = 0; i < count; ++i)
    for (int k = 0; k < 2; ++k) {
      sm[k] += std::fabs(at(dst, i, k) - cm[k]);
      sb[k] += std::fabs(at(src, i, k) - cb[k]);
    }
  for (int k = 0; k < 2; ++k)
    if (std::fabs(sm[k]) < kDblEps || std::fabs(sb[k]) < kDblEps) return false;
  for (int k = 0; k < 2; ++k) {
    sm[k] = count / sm[k];
    sb[k] = count / sb[k];
  }
  double ltl[9][9] = {};
  for (int i = 0; i < count; ++i) {
    const double x = (at(dst, i, 0) - cm[0]) * sm[0], y = (at(dst, i, 1) - cm[1]) * sm[1];
    const double bx = (at(src, i, 0) - cb[0]) * sb[0], by = (at(src, i, 1) - cb[1]) * sb[1];
    const double lx[9] = {bx, by, 1, 0, 0, 0, -x * bx, -x * by, -x};
    const double ly[9] = {0, 0, 0, bx, by, 1, -y * bx, -y * by, -y};
    for (int j = 0; j < 9; ++j)
      for (int k = j; k < 9; ++k) ltl[j][k] += lx[j] * lx[k] + ly[j] * ly[k];
  }
  for (int j = 0; j < 9; ++j)
    for (int k = 0; k < j; ++k) ltl[j][k] = ltl[k][j];
  double h0[9], tmp[9];
  hg_jacobi_smallest(ltl, h0);
  const double inv_norm[9] = {1.0 / sm[0], 0, cm[0], 0, 1.0 / sm[1], cm[1], 0, 0, 1};
  const double norm2[9] = {sb[0], 0, -cb[0] * sb[0], 0, sb[1], -cb[1] * sb[1], 0, 0, 1};
  hg_matmul3(inv_norm, h0, tmp);
  hg_matmul3(tmp, norm2, h);
  // scaled to H[2,2] = 1 unless that entry vanishes (a degenerate set)
  const double scale = std::fabs(h[8]) > kDblEps ? 1.0 / h[8] : 1.0;
  for (int i = 0; i < 9; ++i) h[i] = h[i] * scale;
  return true;
}

// computeError in f32: H[2,2] taken as 1
inline float hg_error(const float hf[8], const float* s, const float* d) {
  const float x = s[0], y = s[1];
  const float ww = 1.0f / (hf[6] * x + hf[7] * y + 1.0f);
  const float dx = (hf[0] * x + hf[1] * y + hf[2]) * ww - d[0];
  const float dy = (hf[3] * x + hf[4] * y + hf[5]) * ww - d[1];
  return dx * dx + dy * dy;
}

int hg_inliers(const double h[9], const float* src, const float* dst, int n, uint8_t* mask) {
  float hf[8];
  for (int i = 0; i < 8; ++i) hf[i] = static_cast<float>(h[i]);
  const float thresh = 9.0f;  // the default threshold 3, squared
  int good = 0;
  for (int i = 0; i < n; ++i) {
    mask[i] = hg_error(hf, src + 2 * i, dst + 2 * i) <= thresh;
    good += mask[i];
  }
  return good;
}

int hg_update_num_iters(double p, double ep, int model_points, int max_iters) {
  p = std::min(std::max(p, 0.0), 1.0);
  ep = std::min(std::max(ep, 0.0), 1.0);
  double num = std::max(1.0 - p, kDblMin);
  double denom = 1.0 - std::pow(1.0 - ep, static_cast<double>(model_points));
  if (denom < kDblMin) return 0;
  num = std::log(num);
  denom = std::log(denom);
  if (denom >= 0 || -num >= max_iters * (-denom)) return max_iters;
  return static_cast<int>(std::nearbyint(num / denom));
}

// The refinement's residuals (2m) and, where jac is set, Jacobian (2m x 9)
void hg_residuals(const double p[9], const float* src, const float* dst, int m, double* err,
                  double* jac) {
  for (int i = 0; i < m; ++i) {
    const double mx = src[2 * i], my = src[2 * i + 1];
    double ww = p[6] * mx + p[7] * my + p[8];
    ww = std::fabs(ww) > kDblEps ? 1.0 / ww : 0.0;
    const double xi = (p[0] * mx + p[1] * my + p[2]) * ww;
    const double yi = (p[3] * mx + p[4] * my + p[5]) * ww;
    err[2 * i] = xi - static_cast<double>(dst[2 * i]);
    err[2 * i + 1] = yi - static_cast<double>(dst[2 * i + 1]);
    if (!jac) continue;
    double* jx = jac + 18 * i;
    double* jy = jx + 9;
    const double rx[9] = {mx * ww, my * ww, ww, 0, 0, 0, -mx * ww * xi, -my * ww * xi, -ww * xi};
    const double ry[9] = {0, 0, 0, mx * ww, my * ww, ww, -mx * ww * yi, -my * ww * yi, -ww * yi};
    for (int k = 0; k < 9; ++k) {
      jx[k] = rx[k];
      jy[k] = ry[k];
    }
  }
}

double hg_normal_equations(const double* err, const double* jac, int rows, double a[9][9],
                           double g[9]) {
  double energy = 0.0;
  for (int j = 0; j < 9; ++j) {
    g[j] = 0.0;
    for (int k = 0; k < 9; ++k) a[j][k] = 0.0;
  }
  for (int r = 0; r < rows; ++r) {
    const double* jr = jac + 9 * r;
    for (int j = 0; j < 9; ++j)
      for (int k = 0; k < 9; ++k) a[j][k] += jr[j] * jr[k];
    for (int j = 0; j < 9; ++j) g[j] += jr[j] * err[r];
    energy += err[r] * err[r];
  }
  return energy;
}

// a x = b by L L^T; false where a pivot is not positive
bool hg_cholesky_solve(const double a[9][9], const double b[9], double x[9]) {
  double low[9][9] = {}, y[9];
  for (int i = 0; i < 9; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = a[i][j];
      for (int k = 0; k < j; ++k) s -= low[i][k] * low[j][k];
      if (i == j) {
        if (!(s > 0.0)) return false;
        low[i][i] = std::sqrt(s);
      } else {
        low[i][j] = s / low[j][j];
      }
    }
  }
  for (int i = 0; i < 9; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= low[i][k] * y[k];
    y[i] = s / low[i][i];
  }
  for (int i = 8; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 9; ++k) s -= low[k][i] * x[k];
    x[i] = s / low[i][i];
  }
  return true;
}

// OpenCV 5's Levenberg-Marquardt on the nine entries of H, over m pairs
void hg_refine(double h[9], const float* src, const float* dst, int m) {
  std::vector<double> err(2 * m), err2(2 * m), jac(18 * static_cast<size_t>(m));
  double p[9], a[9][9], g[9];
  for (int i = 0; i < 9; ++i) p[i] = h[i];
  hg_residuals(p, src, dst, m, err.data(), jac.data());
  double energy = hg_normal_equations(err.data(), jac.data(), 2 * m, a, g);
  double lam = 1e-4, up = 2.0;
  for (int it = 1; it <= kLmIterations; ++it) {
    double d[9], damped[9][9], neg_g[9], x[9];
    for (int i = 0; i < 9; ++i) {
      d[i] = std::min(std::max(a[i][i], 1e-6), 1e32);
      neg_g[i] = -g[i];
      for (int k = 0; k < 9; ++k) damped[i][k] = a[i][k];
    }
    for (int i = 0; i < 9; ++i) damped[i][i] = a[i][i] + lam * d[i];
    bool done = false;
    if (!hg_cholesky_solve(damped, neg_g, x)) {
      lam *= up;
      up *= 2.0;
    } else {
      double probe[9];
      for (int i = 0; i < 9; ++i) probe[i] = p[i] + x[i];
      hg_residuals(probe, src, dst, m, err2.data(), nullptr);
      double energy2 = 0.0;
      for (int r = 0; r < 2 * m; ++r) energy2 += err2[r] * err2[r];
      const double change = energy - energy2;
      if (!(change >= 0.0) || std::fabs(change) < kDblEps) {
        lam *= up;
        up *= 2.0;
      } else {
        double pred = 0.0, step = 0.0;
        for (int i = 0; i < 9; ++i) pred += x[i] * (g[i] - lam * d[i] * x[i]);
        for (int i = 0; i < 9; ++i) step += x[i] * x[i];
        const double rho = change / (-0.5 * pred);
        const double q = 2.0 * rho - 1.0;
        lam *= std::max(1.0 - q * q * q, 1.0 / 3.0);
        up = 2.0;
        done = 1e-6 > change / energy2 || 1e-6 > step;
        for (int i = 0; i < 9; ++i) p[i] = probe[i];
        hg_residuals(p, src, dst, m, err.data(), jac.data());
        energy = hg_normal_equations(err.data(), jac.data(), 2 * m, a, g);
      }
    }
    if (done || lam >= 1e32) break;
  }
  const double scale = 1.0 / p[8];
  for (int i = 0; i < 9; ++i) h[i] = p[i] * scale;
}

}  // namespace

extern "C" {

// cv2.findHomography(src, dst, cv2.RANSAC) on n (x, y) f32 pairs: h (9 f64,
// row-major) and mask (n u8). Returns 1 with a model, 0 without one (h
// untouched, the mask zero), -1 for bad arguments.
int yp_find_homography(const float* src, const float* dst, int n, int max_iters,
                       double confidence, double* h, uint8_t* mask) {
  if (n < 0 || max_iters < 0 || !(confidence > 0.0 && confidence < 1.0)) return -1;
  std::memset(mask, 0, static_cast<size_t>(n));
  if (n < 4) return 0;
  double model[9];
  if (n == 4) {
    if (!hg_dlt(src, dst, 4, model)) return 0;
    std::memcpy(h, model, sizeof(model));
    std::memset(mask, 1, 4);
    return 1;
  }
  // the classic RANSAC registrator
  CvRng rng;
  std::vector<uint8_t> cur(n), best(n);
  double best_h[9];
  int best_count = 0, niters = std::max(max_iters, 1);
  for (int it = 0; it < niters; ++it) {
    int idx[4];
    float s[8], d[8];
    bool found = false;
    for (int attempt = 0; attempt < kRansacAttempts && !found; ++attempt) {
      for (int i = 0; i < 4; ++i) {
        int j = rng.uniform(n);
        while (std::find(idx, idx + i, j) != idx + i) j = rng.uniform(n);
        idx[i] = j;
        s[2 * i] = src[2 * j];
        s[2 * i + 1] = src[2 * j + 1];
        d[2 * i] = dst[2 * j];
        d[2 * i + 1] = dst[2 * j + 1];
      }
      found = hg_subset_ok(s, d);
    }
    if (!found) {
      if (it == 0) return 0;
      break;
    }
    if (!hg_dlt(s, d, 4, model)) continue;
    const int good = hg_inliers(model, src, dst, n, cur.data());
    if (good > std::max(best_count, 3)) {
      best_count = good;
      std::memcpy(best_h, model, sizeof(model));
      best.swap(cur);
      niters = hg_update_num_iters(confidence, static_cast<double>(n - good) / n, 4, niters);
    }
  }
  if (best_count <= 0) return 0;
  // the inliers' refit and refinement, then the mask from the final H
  std::vector<int> inl;
  for (int i = 0; i < n; ++i)
    if (best[i]) inl.push_back(i);
  const int m = static_cast<int>(inl.size());
  std::vector<float> s_in(2 * m), d_in(2 * m);
  for (int i = 0; i < m; ++i)
    for (int k = 0; k < 2; ++k) {
      s_in[2 * i + k] = src[2 * inl[i] + k];
      d_in[2 * i + k] = dst[2 * inl[i] + k];
    }
  if (hg_dlt(s_in.data(), d_in.data(), m, model))
    std::memcpy(best_h, model, sizeof(model));
  hg_refine(best_h, s_in.data(), d_in.data(), m);
  std::memcpy(h, best_h, sizeof(best_h));
  hg_inliers(h, src, dst, n, mask);
  return 1;
}

}  // extern "C"

namespace {

// An LZW string table: each entry's prefix code, first and last byte and
// length (the strings are written back to front along the prefixes).
struct LzwTable {
  std::vector<int32_t> prefix, length, first, last;
  explicit LzwTable(int size, int literals)
      : prefix(size, 0), length(size, 0), first(size, 0), last(size, 0) {
    for (int i = 0; i < literals; ++i) {
      first[i] = last[i] = i;
      length[i] = 1;
    }
  }
  // Writes `code`'s string at out[at..], the part before `limit` only;
  // false where a byte of it is past 255.
  bool put(int code, int64_t at, int64_t limit, uint8_t* out) const {
    int c = code;
    for (int64_t j = at + length[code] - 1; j >= at; --j) {
      if (j < limit) {
        if (last[c] > 255) return false;
        out[j] = static_cast<uint8_t>(last[c]);
      }
      c = prefix[c];
    }
    return true;
  }
};

}  // namespace

extern "C" {

// libtiff's `LZWDecode` of one strip or tile (`src`, `len` bytes) into
// `occ` bytes of `out`: MSB-first codes of 9 to 12 bits, the width growing
// once the table holds 511, 1023 and 2047 entries (the early change), clear
// 256 (after which the next code must be a byte), end 257; no EOI at the end
// of the data is taken as one; a string past the buffer is cut; the table
// grows to 4095 + 1024 entries. `out` is zeroed first and keeps what was
// decoded before an error. Returns 0, 1 on bad parameters, 2 on a corrupted
// table (a code past the table, or no clear code first), 3 where the data
// ends before `occ` bytes. Twin: `data/tiff.py:lzw_numpy`.
int yp_tiff_lzw(const uint8_t* src, int64_t len, uint8_t* out, int64_t occ) {
  if (len < 0 || occ < 0) return 1;
  std::memset(out, 0, static_cast<size_t>(occ));
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4095 + 1024;
  LzwTable t(kSize, 256);
  int nbits = 9, free_ent = kFirst, old = -1, maxcode = (1 << 9) - 2;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t pos = 0, op = 0;
  auto next = [&](int* code) {
    while (nacc < nbits && pos < len) {
      acc = ((acc << 8) | src[pos++]) & 0xFFFFFFFFu;
      nacc += 8;
    }
    if (nacc < nbits) return false;
    *code = static_cast<int>((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    nacc -= nbits;
    return true;
  };
  while (op < occ) {
    int code;
    if (!next(&code) || code == kEoi) break;
    if (code == kClear) {
      nbits = 9, free_ent = kFirst, maxcode = (1 << 9) - 2;
      if (!next(&code) || code == kEoi) break;
      if (code > kClear) return 2;
      out[op++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (old < 0 || free_ent >= kSize || code > free_ent) return 2;
    t.prefix[free_ent] = old;
    t.first[free_ent] = t.first[old];
    t.length[free_ent] = t.length[old] + 1;
    t.last[free_ent] = code < free_ent ? t.first[code] : t.first[old];
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - 2;
    }
    t.put(code, op, occ, out);
    op += t.length[code];
    old = code;
  }
  return op >= occ ? 0 : 3;
}

// libtiff's `PackBitsDecode` of one strip or tile into `occ` bytes of `out`
// (zeroed first): a count n of 0..127 copies n + 1 bytes, -127..-1 repeats
// the next byte 1 - n times, -128 is skipped; a run past the buffer is cut.
// Returns 0, 1 on bad parameters, 3 where the data ends first. Twin:
// `data/tiff.py:packbits_numpy`.
int yp_packbits(const uint8_t* src, int64_t len, uint8_t* out, int64_t occ) {
  if (len < 0 || occ < 0) return 1;
  std::memset(out, 0, static_cast<size_t>(occ));
  int64_t p = 0, op = 0, cc = len;
  while (cc > 0 && op < occ) {
    int n = static_cast<int8_t>(src[p++]);
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      const int64_t k = std::min<int64_t>(-n + 1, occ - op);
      if (cc == 0) break;
      std::memset(out + op, src[p++], static_cast<size_t>(k));
      op += k;
      --cc;
    } else {
      const int64_t k = std::min<int64_t>(n, occ - op - 1);
      if (cc < k + 1) break;
      std::memcpy(out + op, src + p, static_cast<size_t>(k + 1));
      op += k + 1;
      p += k + 1;
      cc -= k + 1;
    }
  }
  return op >= occ ? 0 : 3;
}

// GIF's LZW as OpenCV 5's `GifDecoder::lzwDecode` reads a frame of `n`
// pixels: `blocks` is the frame's data sub-blocks with their length bytes,
// through the zero-length terminator (`len` bytes); LSB-first codes of
// `min_size + 1` bits growing to 12, read a byte at a time within the
// sub-blocks; clear and end-of-information codes both reset the table and
// the decode goes on; a full table (4096) takes no more entries. Pixels
// past the frame's last still count; there a bad code is skipped, but a
// byte read once the count has passed the last pixel is refused, as is a
// string that runs past it from within. `out` (n palette indices) is zeroed
// first. Returns 0, 1 on bad parameters, 2 on a code past the table (or a
// first code after a reset that is no colour), 3 on a string or a read past
// the last pixel, 4 where the sub-blocks end early, 5 on fewer pixels than
// `n`, 6 on an index past 255. Twin: `data/gif.py:lzw_numpy`.
int yp_gif_lzw(const uint8_t* blocks, int64_t len, int min_size, uint8_t* out, int64_t n) {
  if (min_size < 2 || min_size > 11 || len < 1 || n < 0) return 1;
  std::memset(out, 0, static_cast<size_t>(n));
  constexpr int kMax = 4096;
  const int clear = 1 << min_size, eoi = clear + 1;
  LzwTable t(kMax, clear);
  int size = min_size + 1, nxt = eoi + 1, prev = -1;
  uint32_t acc = 0;
  int nacc = 0;
  int64_t idx = 0, pos = 1, left = blocks[0];
  while (left) {
    if (nacc < size) {
      if (idx > n) return 3;
      if (pos >= len) return 4;
      acc |= static_cast<uint32_t>(blocks[pos++]) << nacc;
      nacc += 8;
      --left;
    }
    while (nacc >= size) {
      const int code = static_cast<int>(acc & ((1u << size) - 1));
      acc >>= size;
      nacc -= size;
      if (code == clear || code == eoi) {
        size = min_size + 1, nxt = eoi + 1, prev = -1;
        if (code == eoi) break;
        continue;
      }
      if (prev < 0) {
        if (code >= clear) {
          if (idx >= n) continue;
          return 2;
        }
      } else if (code < nxt || (code == nxt && nxt < kMax)) {
        if (nxt < kMax) {
          t.prefix[nxt] = prev;
          t.length[nxt] = t.length[prev] + 1;
          t.first[nxt] = t.first[prev];
          t.last[nxt] = code < nxt ? t.first[code] : t.first[prev];
          ++nxt;
          if (nxt == (1 << size) && size < 12) ++size;
        }
      } else if (idx >= n) {
        continue;
      } else {
        return 2;
      }
      const int64_t k = t.length[code];
      if (k > 1 && idx < n && n < idx + k) return 3;
      // an index above 255 (min_size 9 to 11) is past any colour table
      if (!t.put(code, idx, n, out)) return 6;
      idx += k;
      prev = code;
    }
    if (!left) {
      if (pos >= len) return 4;
      left = blocks[pos++];
    }
  }
  return idx < n ? 5 : 0;
}

// Radiance's pixels as `rgbe.c`'s `RGBE_ReadPixels_RLE` reads them from
// `data` (`len` bytes from the pixel offset) into `out` (height x width x 4
// R, G, B, E bytes): flat below width 8 or above 32767; else scanlines
// starting `2 2` and the width, each channel in turn as runs (a count above
// 128) and literals, and a scanline not so started read flat from its first
// pixel to the end of the image. Returns 0, 1 on bad parameters, 2 on bad
// scanline data (a count of 0, a run past its channel, a wrong width), 3
// where the data ends first. Twin: `data/radiance.py:rgbe_numpy`.
int yp_hdr_rgbe(const uint8_t* data, int64_t len, int W, int H, uint8_t* out) {
  if (W <= 0 || H <= 0 || len < 0) return 1;
  const int64_t total = static_cast<int64_t>(W) * H * 4;
  auto flat = [&](int64_t p, int64_t start) {
    const int64_t need = total - start * 4;
    if (p + need > len) return 3;
    std::memcpy(out + start * 4, data + p, static_cast<size_t>(need));
    return 0;
  };
  if (W < 8 || W > 0x7FFF) return flat(0, 0);
  std::vector<uint8_t> line(static_cast<size_t>(4) * W);
  int64_t p = 0;
  for (int y = 0; y < H; ++y) {
    if (p + 4 > len) return 3;
    const uint8_t* head = data + p;
    p += 4;
    if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80)) {
      std::memcpy(out + static_cast<int64_t>(y) * W * 4, head, 4);
      return flat(p, static_cast<int64_t>(y) * W + 1);
    }
    if (((head[2] << 8) | head[3]) != W) return 2;
    int64_t q = 0;
    for (int c = 0; c < 4; ++c) {
      const int64_t end = static_cast<int64_t>(c + 1) * W;
      while (q < end) {
        if (p + 2 > len) return 3;
        int count = data[p];
        const uint8_t value = data[p + 1];
        p += 2;
        if (count > 128) {
          count -= 128;
          if (count > end - q) return 2;
          std::memset(line.data() + q, value, static_cast<size_t>(count));
          q += count;
        } else {
          if (count == 0 || count > end - q) return 2;
          line[q] = value;
          if (count > 1) {
            if (p + count - 1 > len) return 3;
            std::memcpy(line.data() + q + 1, data + p, static_cast<size_t>(count - 1));
            p += count - 1;
          }
          q += count;
        }
      }
    }
    uint8_t* row = out + static_cast<int64_t>(y) * W * 4;
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < 4; ++c) row[4 * x + c] = line[static_cast<size_t>(c) * W + x];
  }
  return 0;
}

}  // extern "C"
