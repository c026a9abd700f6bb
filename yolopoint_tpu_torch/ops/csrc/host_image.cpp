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

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>

namespace {

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

}  // extern "C"
