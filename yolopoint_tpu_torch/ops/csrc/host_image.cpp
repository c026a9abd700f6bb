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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
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
