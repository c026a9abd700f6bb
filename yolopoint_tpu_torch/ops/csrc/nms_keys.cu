// K1: fused keypoint NMS + per-tile packed keys, and K6: the same NMS
// written out as the full suppressed map, for sm_90a.
//
// K1 replaces the TPU kernel `_kernel_keys` in yolopoint_tpu/ops/pallas_nms.py
// (launched by `_run_nms_keys_kernel` / `nms_tile_keys`). It computes, for a
// (B, H, W) f32 or bf16 heatmap (comparisons in f32):
//   threshold at `conf` -> `iterations`-round simple_nms with a (2r+1)^2
//   window max and -inf edges -> zero a `border` -> pack each survivor as
//   (f32 bits & ~pos_mask) | (dy*t + dx) -> max over each t x t tile,
// writing only the (B, H/t * W/t) int32 keys (0 = empty tile).
//
// K6 replaces `_kernel` in the same file (launched by `_run_nms_kernel` /
// `nms_tile_reduce`): the same threshold -> NMS -> border, for any H and W,
// writing the (B, H, W) f32 suppressed map (the kept scores, 0 elsewhere).
// It is the same kernel with the key epilogue swapped for a map store.
//
// Bound on this card: one read of the heatmap plus the key or map write
// (bytes), against ~2r compares per pixel for each of the 2*iterations-1
// separable window maxima (operations). The work is all in on-chip memory;
// the design keeps it there and cuts what each pixel costs:
//
// - A block stages one 2D tile of the map plus a halo of (2*iterations-1)*r
//   pixels on every side (the suppression's reach, so interior pixels are
//   exact), its first column rounded down to a multiple of kChunk so that
//   rows load in 16-byte chunks. Staged pixels outside the image read as
//   -inf, the edge rule of the reference's reduce_window (so K6 takes any H
//   and W unpadded); pixels past the staged tile are out of the window.
// - Scores stay at the input's width: every value compared is an input
//   value, 0 or -inf, so a bf16 heatmap is staged and maxed in bf16 storage
//   (4 bytes a pixel with the scratch plane, 8 for f32), which keeps
//   kBlocksPerSm blocks of the large interior on an SM.
// - The kept maxima are bits, one 32-bit word per 32 staged pixels. The
//   suppression window is a dilation: funnel shifts across words for the
//   row, an OR over 2r+1 rows for the column. Suppressed scores are zeroed
//   in place as -0.0, a value no thresholded score takes (staging turns
//   -0.0 into +0.0): it compares as 0 in every window maximum, and marks the
//   pixel as suppressed for the next maxima test. Suppression only grows
//   from round to round, so zeroing in place is exact; the kept scores are
//   read back from the heatmap at the end.
// - Window maxima come from registers: the row pass loads three 16-byte
//   chunks and takes 8 outputs, the column pass (one warp per 32 columns)
//   loads kRows + 2r values of a column and takes kRows outputs, both by
//   doubling (max of 2, 4, 8 ...), and the column pass turns its test into
//   mask words with one ballot per row. Radii up to kMaxStaticRadius are
//   compiled with their windows unrolled; larger ones loop over shared
//   memory.
// - Round k only computes the pixels that the rounds after it read: the
//   interior plus 2*(iterations-k)*r, so later rounds shrink toward the
//   interior.
// - Threads walk 2D ranges with one division per thread and pass.
// - The interior is 64 x 128 where that grid fills the card with
//   kBlocksPerSm blocks an SM, else 32 x 64 (batch 1, small maps, f32).
//
// Where the halo leaves no interior that fits a block's shared memory, or
// only one that stages more than kMaxStagedRatio times its own pixels (at 3
// iterations on 640 x 640 maps: from r = 13 with K6's 1-pixel tile, from
// r = 12 in f32 and r = 16 in bf16 with K1's tile of r), a global-memory
// branch computes the same map round by round, as the plain version does, in
// f32 planes of a scratch the caller passes (kGlobalScratchBytes a pixel):
// threshold; window max along rows, then columns, with out-of-image pixels
// out of the window; the maxima test; for each later round the kept mask
// dilated by r (rows, then columns), the suppressed scores replaced by +0.0,
// the window max and test again. Then the border, and K1's keys per tile.
// One thread a pixel (a tile for the keys); simple, not fast.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 3;        // blocks of the large interior on one SM
constexpr int kSms = 132;              // SMs of the H100 SXM
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kSmemReserved = 1024;    // per block, taken by the runtime
constexpr int kSmemLimit = 227 * 1024; // a block's dynamic shared memory at most
constexpr int kWord = 32;              // staged pixels per mask word
constexpr int kChunk = 8;              // pixels per staged chunk (16 bytes of bf16)
constexpr int kRows = 8;               // output rows per column-pass item
constexpr int kMaxStaticRadius = 8;
constexpr int kLargeTH = 64;           // interior of a block, rows x columns
constexpr int kLargeTW = 128;
constexpr int kSmallTH = 32;
constexpr int kSmallTW = 64;
constexpr int kDynamic = -1;           // the radius template for r > kMaxStaticRadius
constexpr int kMaxStagedRatio = 16;    // staged pixels of a block per interior pixel, at most
constexpr int kGlobalScratchBytes = 15; // a pixel's scratch in the global branch
constexpr int kGlobalThreads = 256;

struct Params {
  int H, W;
  float conf;
  int radius, iterations, border, tile, pos_mask;
  int TH, TW, halo;  // interior tile and halo
  int SH, SP, NW;    // staged rows, staged row pitch (pixels), mask words per staged row
  int vec;           // rows of the heatmap load as aligned 16-byte chunks
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The thresholded score, as the plain version computes it.
__device__ __forceinline__ float thresh(float v, float conf) { return v >= conf ? v : 0.f; }

__device__ __forceinline__ bool neg_zero(float v) { return __float_as_uint(v) == 0x80000000u; }

// 8 staged values (exact at the storage width) to and from f32 registers.
__device__ __forceinline__ void load8(const float* s, float (&v)[kChunk]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float (&v)[kChunk]) {
  const uint4 q = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void store8(float* s, const float (&v)[kChunk]) {
  *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(s + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
// Truncation is exact: every value is a bf16 value, 0 or -inf.
__device__ __forceinline__ void store8(__nv_bfloat16* s, const float (&v)[kChunk]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (__float_as_uint(v[2 * i]) >> 16) | (__float_as_uint(v[2 * i + 1]) & 0xFFFF0000u);
  *reinterpret_cast<uint4*>(s) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ float load1(const float* s) { return *s; }
__device__ __forceinline__ float load1(const __nv_bfloat16* s) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(s)) << 16);
}
// Chunk c of a staged row, -inf outside [0, nc).
template <typename T>
__device__ __forceinline__ void load8_or_inf(const T* row, int c, int nc, float (&v)[kChunk]) {
  if (c >= 0 && c < nc) {
    load8(row + c * kChunk, v);
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) v[i] = -CUDART_INF_F;
  }
}

// Bits [lo, hi) of a word, clipped to [0, 32).
__device__ __forceinline__ uint32_t span_bits(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, kWord);
  if (hi <= lo) return 0u;
  const uint32_t below_hi = hi >= kWord ? ~0u : (1u << hi) - 1u;
  return below_hi & ~((1u << lo) - 1u);
}

// Bits of the 32 staged pixels from image column gx that lie inside the image.
__device__ __forceinline__ uint32_t in_bits(const Params& p, int gy, int gx) {
  return (gy < 0 || gy >= p.H) ? 0u : span_bits(-gx, p.W - gx);
}

// Calls f(y, x) for every (y, x) in [ya, yb) x [xa, xb), worker `id` of `n`
// taking every n-th item in row-major order: one division per call.
template <typename F>
__device__ __forceinline__ void for_each_2d(int ya, int yb, int xa, int xb, int id, int n, F&& f) {
  const int w = xb - xa;
  if (w <= 0 || yb <= ya) return;
  int y = ya + id / w, x = xa + id % w;
  const int dy = n / w, dx = n % w;
  while (y < yb) {
    f(y, x);
    y += dy;
    x += dx;
    if (x >= xb) {
      x -= w;
      ++y;
    }
  }
}

// One doubling level: a[j] = max(a[j], a[j + S]).
template <int S, int N>
__device__ __forceinline__ void level(float (&a)[N]) {
#pragma unroll
  for (int j = 0; j + 2 * S <= N; ++j) a[j] = fmaxf(a[j], a[j + S]);
}

// In place, a[i] becomes max(a[i .. i + 2R]) for i + 2R < N: levels of
// 2, 4, 8, 16 values, then one max of two overlapping levels.
template <int R, int N>
__device__ __forceinline__ void window_max(float (&a)[N]) {
  constexpr int L = 2 * R + 1;
  constexpr int P = L >= 16 ? 16 : L >= 8 ? 8 : L >= 4 ? 4 : L >= 2 ? 2 : 1;
  if constexpr (P > 1) level<1>(a);
  if constexpr (P > 2) level<2>(a);
  if constexpr (P > 4) level<4>(a);
  if constexpr (P > 8) level<8>(a);
  if constexpr (L > P) {
#pragma unroll
    for (int i = 0; i + L <= N; ++i) a[i] = fmaxf(a[i], a[i + L - P]);
  }
}

// tmp = max of ss over the row window, on rows [ya, yb) and chunks [ca, cb).
template <typename T, int R>
__device__ void row_pass(const T* ss, T* tmp, const Params& p, int r, int ya, int yb, int ca,
                         int cb) {
  const int nc = p.SP / kChunk;
  for_each_2d(ya, yb, ca, cb, threadIdx.x, kThreads, [&](int y, int c) {
    const T* row = ss + y * p.SP;
    float o[kChunk];
    if constexpr (R >= 0) {
      float lo[kChunk], mid[kChunk], hi[kChunk];
      load8(row + c * kChunk, mid);
      if constexpr (R > 0) {
        load8_or_inf(row, c - 1, nc, lo);
        load8_or_inf(row, c + 1, nc, hi);
      }
      float w[kChunk + 2 * R];  // staged columns c*kChunk - R .. c*kChunk + kChunk - 1 + R
#pragma unroll
      for (int j = 0; j < kChunk + 2 * R; ++j) {
        const int k = kChunk - R + j;
        w[j] = k < kChunk ? lo[k] : k < 2 * kChunk ? mid[k - kChunk] : hi[k - 2 * kChunk];
      }
      window_max<R>(w);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) o[i] = w[i];
    } else {
      for (int i = 0; i < kChunk; ++i) {
        const int x = c * kChunk + i;
        float m = -CUDART_INF_F;
        for (int j = max(x - r, 0); j <= min(x + r, p.SP - 1); ++j) m = fmaxf(m, load1(row + j));
        o[i] = m;
      }
    }
    store8(tmp + y * p.SP + c * kChunk, o);
  });
}

// The maxima test on rows [ya, yb) and columns [xa, xb): max of tmp over
// the column window, against the pixel's own score, not suppressed and
// inside the image; one warp per 32 columns and kRows rows, one ballot per
// row ORed into the mask words.
template <typename T, int R>
__device__ void col_pass(const T* ss, const T* tmp, uint32_t* maxb, const Params& p, int r, int ya,
                         int yb, int xa, int xb, int gy0, int gx0) {
  const int lane = threadIdx.x % kWord, warp = threadIdx.x / kWord;
  const int groups = (yb - ya + kRows - 1) / kRows;
  for_each_2d(0, groups, xa / kWord, (xb + kWord - 1) / kWord, warp, kThreads / kWord,
              [&](int g, int w) {
    const int y0 = ya + g * kRows, x = w * kWord + lane;
    const bool col_in = x < p.SP;
    const uint32_t cols = span_bits(xa - w * kWord, xb - w * kWord);
    float m[kRows];
    if constexpr (R >= 0) {
      float a[kRows + 2 * R];
#pragma unroll
      for (int j = 0; j < kRows + 2 * R; ++j) {
        const int row = y0 - R + j;
        a[j] = (col_in && row < p.SH) ? load1(tmp + row * p.SP + x) : -CUDART_INF_F;
      }
      window_max<R>(a);
#pragma unroll
      for (int q = 0; q < kRows; ++q) m[q] = a[q];
    } else {
      for (int q = 0; q < kRows; ++q) {
        const int y = y0 + q;
        float v = -CUDART_INF_F;
        if (col_in)
          for (int j = max(y - r, 0); j <= min(y + r, p.SH - 1); ++j)
            v = fmaxf(v, load1(tmp + j * p.SP + x));
        m[q] = v;
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int y = y0 + q;
      if (y >= yb) break;
      const float s = col_in ? load1(ss + y * p.SP + x) : 0.f;
      const uint32_t bits = __ballot_sync(~0u, !neg_zero(s) && s == m[q]);
      if (lane == 0) maxb[y * p.NW + w] |= bits & cols & in_bits(p, gy0 + y, gx0 + w * kWord);
    }
  });
}

// hb = the kept maxima dilated along the row by r: funnel shifts across words.
__device__ void row_dilate(const uint32_t* maxb, uint32_t* hb, const Params& p, int r, int ya,
                           int yb, int wa, int wb) {
  for_each_2d(ya, yb, wa, wb, threadIdx.x, kThreads, [&](int y, int w) {
    const uint32_t* row = maxb + y * p.NW;
    auto word = [&](int j) { return (j >= 0 && j < p.NW) ? row[j] : 0u; };
    uint32_t h = row[w];
    for (int k = 1; k <= r; ++k) {
      const int s = k / kWord, m = k % kWord;
      h |= __funnelshift_l(word(w - s - 1), word(w - s), m) |
           __funnelshift_r(word(w + s), word(w + s + 1), m);
    }
    hb[y * p.NW + w] = h;
  });
}

// The suppression mask (hb ORed over 2r+1 rows, inside the image), applied
// to the scores in place as -0.0, chunk by chunk on rows [ya, yb).
template <typename T>
__device__ void suppress(const uint32_t* hb, T* ss, const Params& p, int r, int ya, int yb, int ca,
                         int cb, int gy0, int gx0) {
  const uint8_t* hb8 = reinterpret_cast<const uint8_t*>(hb);  // byte c of a row: chunk c
  const int pitch8 = p.NW * 4;
  for_each_2d(ya, yb, ca, cb, threadIdx.x, kThreads, [&](int y, int c) {
    uint32_t bits = 0;
    for (int j = y - r; j <= y + r; ++j) bits |= hb8[j * pitch8 + c];
    bits &= in_bits(p, gy0 + y, gx0 + c * kChunk);
    if (!(bits & 0xFFu)) return;
    T* s = ss + y * p.SP + c * kChunk;
    float v[kChunk];
    load8(s, v);
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (bits & (1u << i)) v[i] = -0.f;
    store8(s, v);
  });
}

template <typename T>
__device__ void stage(const T* img, T* ss, const Params& p, int gy0, int gx0) {
  for_each_2d(0, p.SH, 0, p.SP / kChunk, threadIdx.x, kThreads, [&](int y, int c) {
    const int gy = gy0 + y, gx = gx0 + c * kChunk;
    // thresholded, with -0.0 turned into +0.0 (-0.0 marks a suppressed pixel)
    auto score = [&](float raw) {
      const float t = thresh(raw, p.conf);
      return t == 0.f ? 0.f : t;
    };
    float v[kChunk];
    if (gy >= 0 && gy < p.H && gx >= 0 && gx + kChunk <= p.W && p.vec) {
      load8(img + (size_t)gy * p.W + gx, v);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = score(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const bool in = gy >= 0 && gy < p.H && gx + i >= 0 && gx + i < p.W;
        v[i] = in ? score(to_f32(img[(size_t)gy * p.W + gx + i])) : -CUDART_INF_F;
      }
    }
    store8(ss + y * p.SP + c * kChunk, v);
  });
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
nms_tile_kernel(const T* __restrict__ heat, void* __restrict__ out, Params p, int map) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ss = reinterpret_cast<T*>(smem);     // scores, suppressed ones as -0.0
  T* tmp = ss + p.SH * p.SP;               // row maxima
  uint32_t* maxb = reinterpret_cast<uint32_t*>(tmp + p.SH * p.SP);  // kept maxima
  uint32_t* hb = reinterpret_cast<uint32_t*>(tmp);  // row dilation, while tmp is free
  const int r = R >= 0 ? R : p.radius;

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * p.TH, tx0 = blockIdx.x * p.TW;  // image position of the interior
  const int gy0 = ty0 - p.halo;                       // image row of staged row 0
  const int gx0 = (tx0 - p.halo) & ~(kChunk - 1);     // ... and column, floored to a chunk
  const int oy = p.halo, ox = tx0 - gx0;              // staged position of the interior
  const T* img = heat + (size_t)b * p.H * p.W;

  stage(img, ss, p, gy0, gx0);
  for (int i = threadIdx.x; i < p.SH * p.NW; i += kThreads) maxb[i] = 0u;
  __syncthreads();

  for (int k = 1; k <= p.iterations; ++k) {
    const int e = 2 * (p.iterations - k) * r;  // what the later rounds read beyond the interior
    const int ya = oy - e, yb = oy + p.TH + e, xa = ox - e, xb = ox + p.TW + e;
    if (k > 1) {
      row_dilate(maxb, hb, p, r, ya - 2 * r, yb + 2 * r, (xa - r) / kWord,
                 (xb + r + kWord - 1) / kWord);
      __syncthreads();
      suppress(hb, ss, p, r, ya - r, yb + r, (xa - r) / kChunk, (xb + r + kChunk - 1) / kChunk,
               gy0, gx0);
      __syncthreads();
    }
    row_pass<T, R>(ss, tmp, p, r, ya - r, yb + r, xa / kChunk, (xb + kChunk - 1) / kChunk);
    __syncthreads();
    col_pass<T, R>(ss, tmp, maxb, p, r, ya, yb, xa, xb, gy0, gx0);
    __syncthreads();
  }

  auto kept = [&](int y, int x) {  // interior coordinates
    const int sy = oy + y, sx = ox + x, gy = ty0 + y, gx = tx0 + x;
    return ((maxb[sy * p.NW + sx / kWord] >> (sx % kWord)) & 1u) && gy >= p.border &&
           gy < p.H - p.border && gx >= p.border && gx < p.W - p.border;
  };
  if (map) {
    // K6: the suppressed map of the interior, row by row (coalesced)
    float* dst = static_cast<float*>(out) + (size_t)b * p.H * p.W;
    for_each_2d(0, min(p.TH, p.H - ty0), 0, min(p.TW, p.W - tx0), threadIdx.x, kThreads,
                [&](int y, int x) {
      const size_t i = (size_t)(ty0 + y) * p.W + tx0 + x;
      dst[i] = kept(y, x) ? thresh(to_f32(img[i]), p.conf) : 0.f;
    });
    return;
  }

  // K1: key packing and the t x t tile max on the interior
  int32_t* keys = static_cast<int32_t*>(out);
  const int t = p.tile, ntw = p.W / t;
  for_each_2d(0, p.TH / t, 0, p.TW / t, threadIdx.x, kThreads, [&](int i, int j) {
    const int gy = ty0 + i * t, gx = tx0 + j * t;
    if (gy >= p.H || gx >= p.W) return;
    int32_t best = 0;
    for (int dy = 0; dy < t; ++dy) {
      for (int dx = 0; dx < t; ++dx) {
        if (!kept(i * t + dy, j * t + dx)) continue;
        const float v = thresh(to_f32(img[(size_t)(gy + dy) * p.W + gx + dx]), p.conf);
        if (v > 0.f) best = max(best, (__float_as_int(v) & ~p.pos_mask) | (dy * t + dx));
      }
    }
    keys[(size_t)b * (p.H / t) * ntw + (gy / t) * ntw + gx / t] = best;
  });
}

size_t smem_bytes(int TH, int TW, int halo, int elem) {
  const size_t SH = TH + 2 * halo;
  const size_t SP = (TW + 2 * halo + 2 * kChunk - 2) / kChunk * kChunk;
  const size_t NW = (SP + kWord - 1) / kWord;
  return SH * SP * 2 * elem + SH * NW * 4;
}

size_t blocks(int B, int H, int W, int TH, int TW) {
  return (size_t)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// The interior: large where kBlocksPerSm of its blocks fit on an SM and its
// grid fills every SM with them, else small; then shrunk by whole tiles
// until it fits a block's shared memory. -1 (the global branch) where none
// fits, or where the one that fits stages more than kMaxStagedRatio times
// its own pixels (a halo that large is recomputed by every block).
int configure(Params& p, int B, int elem) {
  const int t = p.tile;
  auto up = [t](int v) { return (v + t - 1) / t * t; };
  p.TH = up(kLargeTH);
  p.TW = up(kLargeTW);
  const bool fits = (smem_bytes(p.TH, p.TW, p.halo, elem) + kSmemReserved) * kBlocksPerSm <=
                    (size_t)kSmemPerSm;
  if (!fits || blocks(B, p.H, p.W, p.TH, p.TW) < (size_t)kSms * kBlocksPerSm) {
    p.TH = up(kSmallTH);
    p.TW = up(kSmallTW);
  }
  while (smem_bytes(p.TH, p.TW, p.halo, elem) > (size_t)kSmemLimit && p.TH > t) p.TH -= t;
  while (smem_bytes(p.TH, p.TW, p.halo, elem) > (size_t)kSmemLimit && p.TW > t) p.TW -= t;
  if (smem_bytes(p.TH, p.TW, p.halo, elem) > (size_t)kSmemLimit) return -1;
  p.SH = p.TH + 2 * p.halo;
  p.SP = (p.TW + 2 * p.halo + 2 * kChunk - 2) / kChunk * kChunk;
  p.NW = (p.SP + kWord - 1) / kWord;
  if ((size_t)p.SH * p.SP > (size_t)kMaxStagedRatio * p.TH * p.TW) return -1;
  return (int)smem_bytes(p.TH, p.TW, p.halo, elem);
}

template <typename T, int R>
int launch(const void* heat, void* out, int B, Params p, int map, cudaStream_t stream) {
  static unsigned configured = 0;  // one bit per device: the attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(nms_tile_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_tile_kernel<T, R>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const int smem = configure(p, B, sizeof(T));
  if (smem < 0) return (int)cudaErrorInvalidValue;
  p.vec = p.W % kChunk == 0 && reinterpret_cast<uintptr_t>(heat) % 16 == 0;
  const dim3 grid((p.W + p.TW - 1) / p.TW, (p.H + p.TH - 1) / p.TH, B);
  nms_tile_kernel<T, R><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(heat), out, p,
                                                          map);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_radius(const void* heat, void* out, int B, const Params& p, int map, cudaStream_t s) {
  static_assert(kMaxStaticRadius == 8, "one case per static radius");
  switch (p.radius) {
    case 0: return launch<T, 0>(heat, out, B, p, map, s);
    case 1: return launch<T, 1>(heat, out, B, p, map, s);
    case 2: return launch<T, 2>(heat, out, B, p, map, s);
    case 3: return launch<T, 3>(heat, out, B, p, map, s);
    case 4: return launch<T, 4>(heat, out, B, p, map, s);
    case 5: return launch<T, 5>(heat, out, B, p, map, s);
    case 6: return launch<T, 6>(heat, out, B, p, map, s);
    case 7: return launch<T, 7>(heat, out, B, p, map, s);
    case 8: return launch<T, 8>(heat, out, B, p, map, s);
    default: return launch<T, kDynamic>(heat, out, B, p, map, s);
  }
}

// ---------------------------------------------------------------- global branch

// The planes of the global branch, each B*H*W pixels: thresholded scores s,
// suppressed scores z, row maxima t (f32); kept maxima km, row dilation d,
// suppression mask sup (bytes).
struct Planes {
  float *s, *z, *t;
  uint8_t *km, *d, *sup;
};

Planes planes(void* scratch, size_t n) {
  char* base = static_cast<char*>(scratch);
  return {reinterpret_cast<float*>(base), reinterpret_cast<float*>(base + 4 * n),
          reinterpret_cast<float*>(base + 8 * n), reinterpret_cast<uint8_t*>(base + 12 * n),
          reinterpret_cast<uint8_t*>(base + 13 * n), reinterpret_cast<uint8_t*>(base + 14 * n)};
}

// Grid-stride loop over the n pixels of the batch.
#define FOR_EACH_PIXEL(i, n) \
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < (n); \
       i += (size_t)gridDim.x * blockDim.x)

template <typename T>
__global__ void g_threshold(const T* __restrict__ heat, float* __restrict__ s, size_t n,
                            float conf) {
  FOR_EACH_PIXEL(i, n) s[i] = thresh(to_f32(heat[i]), conf);
}

// t = max of src over the row window [x - r, x + r] inside the image
__global__ void g_row_max(const float* __restrict__ src, float* __restrict__ t, size_t n, int W,
                          int r) {
  FOR_EACH_PIXEL(i, n) {
    const int x = (int)(i % W);
    const float* row = src + (i - x);
    float m = -CUDART_INF_F;
    for (int j = max(x - r, 0); j <= min(x + r, W - 1); ++j) m = fmaxf(m, row[j]);
    t[i] = m;
  }
}

// The maxima test: src equal to the max of t over the column window. Round 1
// sets km; later rounds add the new maxima outside the suppressed area.
__global__ void g_col_test(const float* __restrict__ src, const float* __restrict__ t,
                           const uint8_t* __restrict__ sup, uint8_t* __restrict__ km, size_t n,
                           int H, int W, int r, int first) {
  FOR_EACH_PIXEL(i, n) {
    const size_t plane = (size_t)H * W;
    const int y = (int)(i % plane / W);
    const float* col = t + (i - (size_t)y * W);
    float m = -CUDART_INF_F;
    for (int j = max(y - r, 0); j <= min(y + r, H - 1); ++j) m = fmaxf(m, col[(size_t)j * W]);
    const bool is_max = src[i] == m;
    km[i] = first ? is_max : (km[i] | (is_max && !sup[i]));
  }
}

// d = km ORed over the row window
__global__ void g_row_dilate(const uint8_t* __restrict__ km, uint8_t* __restrict__ d, size_t n,
                             int W, int r) {
  FOR_EACH_PIXEL(i, n) {
    const int x = (int)(i % W);
    const uint8_t* row = km + (i - x);
    uint8_t v = 0;
    for (int j = max(x - r, 0); j <= min(x + r, W - 1) && !v; ++j) v = row[j];
    d[i] = v;
  }
}

// sup = d ORed over the column window; z = s with the suppressed pixels +0.0
__global__ void g_suppress(const uint8_t* __restrict__ d, const float* __restrict__ s,
                           uint8_t* __restrict__ sup, float* __restrict__ z, size_t n, int H,
                           int W, int r) {
  FOR_EACH_PIXEL(i, n) {
    const size_t plane = (size_t)H * W;
    const int y = (int)(i % plane / W);
    const uint8_t* col = d + (i - (size_t)y * W);
    uint8_t v = 0;
    for (int j = max(y - r, 0); j <= min(y + r, H - 1) && !v; ++j) v = col[(size_t)j * W];
    sup[i] = v;
    z[i] = v ? 0.f : s[i];
  }
}

__device__ __forceinline__ bool in_border(int y, int x, int H, int W, int border) {
  return y >= border && y < H - border && x >= border && x < W - border;
}

// K6: the kept thresholded scores inside the border
__global__ void g_map(const float* __restrict__ s, const uint8_t* __restrict__ km,
                      float* __restrict__ out, size_t n, int H, int W, int border) {
  FOR_EACH_PIXEL(i, n) {
    const int x = (int)(i % W), y = (int)(i % ((size_t)H * W) / W);
    out[i] = km[i] && in_border(y, x, H, W, border) ? s[i] : 0.f;
  }
}

// K1: per t x t tile, the max packed key of the kept scores inside the border
__global__ void g_keys(const float* __restrict__ s, const uint8_t* __restrict__ km,
                       int32_t* __restrict__ keys, size_t n_tiles, int H, int W, int border,
                       int t, int pos_mask) {
  FOR_EACH_PIXEL(k, n_tiles) {
    const int ntw = W / t, nth = H / t;
    const int tx = (int)(k % ntw), ty = (int)(k / ntw % nth);
    const size_t base = k / ((size_t)ntw * nth) * H * W;
    int32_t best = 0;
    for (int dy = 0; dy < t; ++dy) {
      for (int dx = 0; dx < t; ++dx) {
        const int y = ty * t + dy, x = tx * t + dx;
        const size_t i = base + (size_t)y * W + x;
        if (!km[i] || !in_border(y, x, H, W, border)) continue;
        const float v = s[i];
        if (v > 0.f) best = max(best, (__float_as_int(v) & ~pos_mask) | (dy * t + dx));
      }
    }
    keys[k] = best;
  }
}

int global_blocks(size_t n) {
  return (int)std::min<size_t>((n + kGlobalThreads - 1) / kGlobalThreads, (size_t)kSms * 16);
}

template <typename T>
int run_global(const T* heat, void* out, void* scratch, int B, const Params& p, int map,
               cudaStream_t st) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * p.H * p.W;
  const Planes q = planes(scratch, n);
  const int g = global_blocks(n), r = p.radius;
  g_threshold<T><<<g, kGlobalThreads, 0, st>>>(heat, q.s, n, p.conf);
  g_row_max<<<g, kGlobalThreads, 0, st>>>(q.s, q.t, n, p.W, r);
  g_col_test<<<g, kGlobalThreads, 0, st>>>(q.s, q.t, q.sup, q.km, n, p.H, p.W, r, 1);
  for (int k = 1; k < p.iterations; ++k) {
    g_row_dilate<<<g, kGlobalThreads, 0, st>>>(q.km, q.d, n, p.W, r);
    g_suppress<<<g, kGlobalThreads, 0, st>>>(q.d, q.s, q.sup, q.z, n, p.H, p.W, r);
    g_row_max<<<g, kGlobalThreads, 0, st>>>(q.z, q.t, n, p.W, r);
    g_col_test<<<g, kGlobalThreads, 0, st>>>(q.z, q.t, q.sup, q.km, n, p.H, p.W, r, 0);
  }
  if (map) {
    g_map<<<g, kGlobalThreads, 0, st>>>(q.s, q.km, static_cast<float*>(out), n, p.H, p.W,
                                        p.border);
  } else {
    const size_t tiles = (size_t)B * (p.H / p.tile) * (p.W / p.tile);
    g_keys<<<global_blocks(tiles), kGlobalThreads, 0, st>>>(
        q.s, q.km, static_cast<int32_t*>(out), tiles, p.H, p.W, p.border, p.tile, p.pos_mask);
  }
  return (int)cudaGetLastError();
}

// The shared-memory kernel where an interior fits, else the global branch.
int run(const void* heat, int heat_is_bf16, void* out, void* scratch, int B, const Params& p,
        int map, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params fit = p;
  if (configure(fit, B, heat_is_bf16 ? 2 : 4) < 0) {
    return heat_is_bf16
               ? run_global(static_cast<const __nv_bfloat16*>(heat), out, scratch, B, p, map, s)
               : run_global(static_cast<const float*>(heat), out, scratch, B, p, map, s);
  }
  return heat_is_bf16 ? launch_radius<__nv_bfloat16>(heat, out, B, p, map, s)
                      : launch_radius<float>(heat, out, B, p, map, s);
}

}  // namespace

extern "C" int yp_nms_tile_keys(const void* heat, int heat_is_bf16, void* keys, void* scratch,
                                int B, int H, int W, float conf, int radius, int iterations,
                                int border, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || tile <= 0 || radius < 0 || iterations < 1 ||
      H % tile != 0 || W % tile != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  int pos_bits = 1;
  while ((1 << pos_bits) <= tile * tile - 1) ++pos_bits;
  Params p{};
  p.H = H;
  p.W = W;
  p.conf = conf;
  p.radius = radius;
  p.iterations = iterations;
  p.border = border;
  p.tile = tile;
  p.pos_mask = (1 << pos_bits) - 1;
  p.halo = (2 * iterations - 1) * radius;
  return run(heat, heat_is_bf16, keys, scratch, B, p, 0, stream);
}

extern "C" int yp_nms_suppressed_map(const void* heat, int heat_is_bf16, void* out,
                                     void* scratch, int B, int H, int W, float conf, int radius,
                                     int iterations, int border, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || radius < 0 || iterations < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.H = H;
  p.W = W;
  p.conf = conf;
  p.radius = radius;
  p.iterations = iterations;
  p.border = border;
  p.tile = 1;  // the interior is any whole number of pixels
  p.halo = (2 * iterations - 1) * radius;
  return run(heat, heat_is_bf16, out, scratch, B, p, 1, stream);
}
