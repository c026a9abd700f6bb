// K1: fused keypoint NMS + per-tile packed keys, and K6: the same NMS
// written out as the full suppressed map, for sm_90a.
//
// K1 replaces the TPU kernel `_kernel_keys` in yolopoint_tpu/ops/pallas_nms.py
// (launched by `_run_nms_keys_kernel` / `nms_tile_keys`). It computes, for a
// (B, H, W) f32 or bf16 heatmap (math in f32):
//   threshold at `conf` -> `iterations`-round simple_nms with a (2r+1)^2
//   window max and -inf edges -> zero a `border` -> pack each survivor as
//   (f32 bits & ~pos_mask) | (dy*t + dx) -> max over each t x t tile,
// writing only the (B, H/t * W/t) int32 keys (0 = empty tile).
//
// K6 replaces `_kernel` in the same file (launched by `_run_nms_kernel` /
// `nms_tile_reduce`): the same threshold -> NMS -> border, for any H and W,
// writing the (B, H, W) f32 suppressed map (the kept scores, 0 elsewhere).
// It is the same kernel with the key epilogue swapped for a map store
// (template flag `kMap`, tile edge 1).
//
// Bound on this card: one read of the heatmap plus the key write (K1) or
// the f32 map write (K6) (bytes), against ~5 separable window maxes of 2r
// compares each per pixel (operations). The design keeps every
// intermediate out of device memory:
// a block stages one 2D tile of the map plus a halo of (2*iterations-1)*r
// pixels on every side in shared memory (the suppression's influence radius,
// so interior pixels are exact), runs all NMS rounds there on f32 scores,
// a one-byte flag plane and one f32 scratch plane, and writes only the keys
// (K1) or the interior of the map (K6).
// Rows AND columns are tiled because a 640-wide band plus its halo does not
// fit in 227 KB of shared memory at f32. Staged pixels outside the image
// read as -inf, the edge rule of the reference's reduce_window (so K6 takes
// any H and W unpadded); pixels past the staged tile are simply out of the
// window, which only perturbs the halo.
// The halo is recomputed by neighbouring blocks; that redundancy (about 2x
// at the default 64 x 128 interior and r = 4) is the price of exactness
// without a second pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemLimit = 200 * 1024;
constexpr uint8_t kMax = 1;   // pixel is a kept maximum
constexpr uint8_t kSupp = 2;  // pixel is inside a kept maximum's window
constexpr uint8_t kIn = 4;    // pixel lies inside the image

struct Params {
  int H, W;
  float conf;
  int radius, iterations, border, tile, pos_mask;
  int TH, TW, halo, SH, SW;  // interior tile, halo, staged tile
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Scores with the current suppression applied: 0 where suppressed, -inf
// outside the image.
__device__ __forceinline__ float supp_score(const float* sv, const uint8_t* flg, int i) {
  const uint8_t f = flg[i];
  if (!(f & kIn)) return -CUDART_INF_F;
  return (f & kSupp) ? 0.f : sv[i];
}

template <typename T, bool kMap>
__global__ void __launch_bounds__(kThreads)
nms_tile_kernel(const T* __restrict__ heat, void* __restrict__ out, Params p) {
  extern __shared__ float smem[];
  const int SW = p.SW, SH = p.SH, S = SH * SW, r = p.radius;
  float* sv = smem;       // thresholded scores, -inf outside the image
  float* tmp = smem + S;  // row pass of the separable window max
  uint8_t* flg = reinterpret_cast<uint8_t*>(smem + 2 * S);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * p.TH - p.halo;  // image row of staged row 0
  const int x0 = blockIdx.x * p.TW - p.halo;
  const T* img = heat + (size_t)b * p.H * p.W;

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int ly = i / SW, lx = i - ly * SW;
    const int gy = y0 + ly, gx = x0 + lx;
    const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    float v = -CUDART_INF_F;
    if (in) {
      v = to_f32(img[(size_t)gy * p.W + gx]);
      v = v >= p.conf ? v : 0.f;
    }
    sv[i] = v;
    flg[i] = in ? kIn : 0;
  }
  __syncthreads();

  // round 1: strict window maxima of the thresholded scores
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int ly = i / SW, lx = i - ly * SW;
    const int a = max(lx - r, 0), e = min(lx + r, SW - 1);
    const float* row = sv + ly * SW;
    float m = -CUDART_INF_F;
    for (int j = a; j <= e; ++j) m = fmaxf(m, row[j]);
    tmp[i] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int ly = i / SW, lx = i - ly * SW;
    const int a = max(ly - r, 0), e = min(ly + r, SH - 1);
    float m = -CUDART_INF_F;
    for (int j = a; j <= e; ++j) m = fmaxf(m, tmp[j * SW + lx]);
    if ((flg[i] & kIn) && sv[i] == m) flg[i] |= kMax;
  }
  __syncthreads();

  for (int it = 1; it < p.iterations; ++it) {
    // suppression mask: dilation of the kept maxima by the window
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const int ly = i / SW, lx = i - ly * SW;
      const int a = max(lx - r, 0), e = min(lx + r, SW - 1);
      const uint8_t* row = flg + ly * SW;
      uint8_t any = 0;
      for (int j = a; j <= e; ++j) any |= row[j];
      tmp[i] = (any & kMax) ? 1.f : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const int ly = i / SW, lx = i - ly * SW;
      const int a = max(ly - r, 0), e = min(ly + r, SH - 1);
      float m = 0.f;
      for (int j = a; j <= e; ++j) m = fmaxf(m, tmp[j * SW + lx]);
      flg[i] = m > 0.f ? (flg[i] | kSupp) : (flg[i] & ~kSupp);
    }
    __syncthreads();
    // re-admit maxima of the suppressed map that lie outside every window
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const int ly = i / SW, lx = i - ly * SW;
      const int a = max(lx - r, 0), e = min(lx + r, SW - 1);
      float m = -CUDART_INF_F;
      for (int j = a; j <= e; ++j) m = fmaxf(m, supp_score(sv, flg, ly * SW + j));
      tmp[i] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const int ly = i / SW, lx = i - ly * SW;
      const int a = max(ly - r, 0), e = min(ly + r, SH - 1);
      float m = -CUDART_INF_F;
      for (int j = a; j <= e; ++j) m = fmaxf(m, tmp[j * SW + lx]);
      const uint8_t f = flg[i];
      if ((f & kIn) && !(f & kSupp) && supp_score(sv, flg, i) == m) flg[i] = f | kMax;
    }
    __syncthreads();
  }

  if constexpr (kMap) {
    // K6: border removal and the suppressed map of the interior
    float* map = static_cast<float*>(out) + (size_t)b * p.H * p.W;
    for (int k = threadIdx.x; k < p.TH * p.TW; k += blockDim.x) {
      const int gy = blockIdx.y * p.TH + k / p.TW;
      const int gx = blockIdx.x * p.TW + k % p.TW;
      if (gy >= p.H || gx >= p.W) continue;
      const int i = (gy - y0) * SW + (gx - x0);
      const bool ok = (flg[i] & kMax) && gy >= p.border && gy < p.H - p.border &&
                      gx >= p.border && gx < p.W - p.border;
      map[(size_t)gy * p.W + gx] = ok ? sv[i] : 0.f;
    }
    return;
  }

  // K1: border removal, key packing and the t x t tile max on the interior
  int32_t* keys = static_cast<int32_t*>(out);
  const int t = p.tile;
  const int tiles_x = p.TW / t, n_tiles = (p.TH / t) * tiles_x;
  const int ntw = p.W / t;
  for (int k = threadIdx.x; k < n_tiles; k += blockDim.x) {
    const int gy0 = blockIdx.y * p.TH + (k / tiles_x) * t;
    const int gx0 = blockIdx.x * p.TW + (k % tiles_x) * t;
    if (gy0 >= p.H || gx0 >= p.W) continue;
    int32_t best = 0;
    for (int dy = 0; dy < t; ++dy) {
      const int gy = gy0 + dy;
      for (int dx = 0; dx < t; ++dx) {
        const int gx = gx0 + dx;
        const int i = (gy - y0) * SW + (gx - x0);
        const bool ok = (flg[i] & kMax) && gy >= p.border && gy < p.H - p.border &&
                        gx >= p.border && gx < p.W - p.border;
        const float v = ok ? sv[i] : 0.f;
        if (v > 0.f) {
          const int32_t key = (__float_as_int(v) & ~p.pos_mask) | (dy * t + dx);
          best = max(best, key);
        }
      }
    }
    keys[(size_t)b * (p.H / t) * ntw + (gy0 / t) * ntw + gx0 / t] = best;
  }
}

size_t smem_bytes(int TH, int TW, int halo) {
  const size_t S = (size_t)(TH + 2 * halo) * (TW + 2 * halo);
  return S * (2 * sizeof(float) + 1);
}

template <typename T, bool kMap>
int launch(const void* heat, void* out, int B, const Params& p0, cudaStream_t stream) {
  Params p = p0;
  const int t = p.tile;
  // default interior 64 x 128 (multiples of t), shrunk until it fits
  p.TH = ((64 + t - 1) / t) * t;
  p.TW = ((128 + t - 1) / t) * t;
  while (smem_bytes(p.TH, p.TW, p.halo) > (size_t)kSmemLimit && p.TH > t) p.TH -= t;
  while (smem_bytes(p.TH, p.TW, p.halo) > (size_t)kSmemLimit && p.TW > t) p.TW -= t;
  const size_t smem = smem_bytes(p.TH, p.TW, p.halo);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  p.SH = p.TH + 2 * p.halo;
  p.SW = p.TW + 2 * p.halo;
  cudaError_t err = cudaFuncSetAttribute(
      nms_tile_kernel<T, kMap>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.W + p.TW - 1) / p.TW, (p.H + p.TH - 1) / p.TH, B);
  nms_tile_kernel<T, kMap><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(heat), out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yp_nms_tile_keys(const void* heat, int heat_is_bf16, void* keys, int B, int H,
                                int W, float conf, int radius, int iterations, int border,
                                int tile, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return heat_is_bf16 ? launch<__nv_bfloat16, false>(heat, keys, B, p, s)
                      : launch<float, false>(heat, keys, B, p, s);
}

extern "C" int yp_nms_suppressed_map(const void* heat, int heat_is_bf16, void* out, int B,
                                     int H, int W, float conf, int radius, int iterations,
                                     int border, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return heat_is_bf16 ? launch<__nv_bfloat16, true>(heat, out, B, p, s)
                      : launch<float, true>(heat, out, B, p, s);
}
