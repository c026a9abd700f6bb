// K4 + K5: inverse homography warp of NHWC f32 images, for sm_90a.
//
// Replaces both Pallas warps of yolopoint_tpu/ops/pallas_warp.py: `_kernel`
// (K5, the whole image resident in VMEM, launched by `_warp_pallas` /
// `warp_image_pallas`) and `_wkernel` (K4, a DMA'd source window of a fixed
// `max_scale` size per 16x128 output tile, launched by
// `_warp_pallas_windowed` / `warp_image_pallas_windowed`). For each output
// pixel (b, i, j): the normalized output coords (xs[j], ys[i]) go through
// the output -> source homography, w_k = (h_k0 x + h_k1 y) + h_k2, then
// (w0 / w2, w1 / w2) is mapped to source pixels, ((s + 1) * 0.5) * (size -
// 1); the pixel is sampled bilinearly, or nearest with floor(s + 0.5), zero
// outside the frame. C <= 4 channels, f32 in and out. It computes the exact
// f32 `_warp_image_xla` of yolopoint_tpu/ops/geometry.py; every operation
// is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction), in the plain version's order, so nearest mode picks the
// same pixel as the plain version on the same grid.
//
// Bound on this card: bytes, one read of the source pixels the taps reach
// and one write of the f32 output (~2 flops per byte). One thread per
// output pixel with its taps read through L1/L2 (the first port of this
// kernel) ran at a quarter of that bound: each 256-pixel strip of an output
// row landed on a thin diagonal strip of the source, the rows around it were
// fetched again by other blocks, each thread paid two 64-bit divisions, and
// C scalar loads per tap at a 4C-byte stride used a third of each sector.
// L1/L2 did not do what the TPU kernels' VMEM windows did. The design here:
//  * 2-D output tiles of 32x32 pixels, grid (tiles_x, tiles_y, B) with x
//    fastest, so that neighbouring tiles share their source halo in L2;
//    256 threads, 4 pixels of one column each; no 64-bit division.
//  * Each pixel's source coordinates stay in registers. A block reduction
//    takes the exact window of the tile: the bounding box of its in-frame
//    taps (floor and floor + 1 bilinear, floor(s + 0.5) nearest). Taps off
//    the frame or not finite are skipped, tested in float before any cast,
//    so there is no fixed scale guess (K4's `max_scale`) and no tap is
//    dropped.
//  * Where the window fits the shared-memory budget (24 KB; the augmentation
//    warps' windows reach ~20 KB at C = 3), the block copies it with
//    coalesced cp.async (16-byte where the row pitch W*C and the pointers
//    allow it, else 4-byte) and samples from shared memory. Otherwise
//    (strong zoom-out, or w2 changing sign inside the tile, which sends taps
//    across the frame) it samples from global memory, and adds one to a
//    counter of such tiles. A tile with no tap in the frame loads nothing.
//    Both branches compute each value with the same operations, so the
//    result is bit-equal to the plain version either way.
//  * Each pixel's output goes to a stage in shared memory, apart from the
//    window, and the tile leaves in 16-byte stores (a 32-pixel row at C = 3
//    is 384 contiguous bytes in NHWC).
//  * 24 KB of window and 12 KB of stage (C = 3) let 6 blocks share an SM
//    (40 registers a thread): the per-tile phases (coordinates, window
//    load, sampling, store) run one after the other in a block, so the
//    overlap comes from the other blocks on the SM.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                              // output tile edge, pixels
constexpr int kThreads = 256;                          // one tile column per lane
constexpr int kWarps = kThreads / 32;
constexpr int kPix = kTile * kTile / kThreads;         // pixels per thread, rows kWarps apart
constexpr int kMaxC = 4;
constexpr int kWindowBytes = 24 * 1024;                // shared-memory window budget
constexpr int kBlocksPerSm = 6;                        // 6 x (24 KB + 12 KB stage at C = 3 + 1 KB)
static_assert(kPix * kWarps == kTile, "each warp covers whole tile rows");

// dynamic shared memory: the output stage (kTile x kTile x C floats), then the window
constexpr int smem_bytes(int C) { return kTile * kTile * C * 4 + kWindowBytes; }
static_assert(kBlocksPerSm * (smem_bytes(3) + 1024 + 128) <= 233472, "blocks per SM at C = 3");

__device__ __forceinline__ bool in_range(float v, int n) {
  return v >= 0.f && v <= (float)(n - 1);  // false for NaN
}

__device__ __forceinline__ bool inside(float x, float y, int W, int H) {
  return in_range(x, W) && in_range(y, H);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <bool SHARED>
__device__ __forceinline__ float tap(const float* __restrict__ src, int idx) {
  if (SHARED) return src[idx];
  return __ldg(src + idx);
}

// One output pixel from source pixel coords (sx, sy). `src` holds the
// pixels of rows >= oy at `pitch` floats a row, float column `x * C - ocol`:
// the whole image (oy = ocol = 0) or the tile's window in shared memory.
// Every in-frame tap lies in `src`; off-frame taps read nothing and count 0.
template <int C, bool NEAREST, bool SHARED>
__device__ __forceinline__ void sample(const float* __restrict__ src, int pitch, int oy, int ocol,
                                       int H, int W, float sx, float sy, float (&o)[C]) {
  if (NEAREST) {
    const float nx = floorf(__fadd_rn(sx, 0.5f)), ny = floorf(__fadd_rn(sy, 0.5f));
    const bool in = inside(nx, ny, W, H);
    const int t = in ? ((int)ny - oy) * pitch + (int)nx * C - ocol : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = in ? tap<SHARED>(src, t + c) : 0.f;
    return;
  }
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const bool in00 = inside(x0, y0, W, H), in01 = inside(x1, y0, W, H);
  const bool in10 = inside(x0, y1, W, H), in11 = inside(x1, y1, W, H);
  // an off-frame tap's index is 0 (a valid address) and its value is 0
  const int t00 = in00 ? ((int)y0 - oy) * pitch + (int)x0 * C - ocol : 0;
  const int t01 = in01 ? ((int)y0 - oy) * pitch + (int)x1 * C - ocol : 0;
  const int t10 = in10 ? ((int)y1 - oy) * pitch + (int)x0 * C - ocol : 0;
  const int t11 = in11 ? ((int)y1 - oy) * pitch + (int)x1 * C - ocol : 0;
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v00 = in00 ? tap<SHARED>(src, t00 + c) : 0.f;
    const float v01 = in01 ? tap<SHARED>(src, t01 + c) : 0.f;
    const float v10 = in10 ? tap<SHARED>(src, t10 + c) : 0.f;
    const float v11 = in11 ? tap<SHARED>(src, t11 + c) : 0.f;
    const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
    o[c] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
  }
}

// `vec`: W * C is a multiple of 4 and `img`, `out` are 16-byte aligned, so
// every image row starts on a 16-byte boundary.
template <int C, bool NEAREST>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
warp_kernel(const float* __restrict__ img, const float* __restrict__ hom,
            const float* __restrict__ xs, const float* __restrict__ ys,
            float* __restrict__ out, int H, int W, int vec, int* __restrict__ global_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                          // the output tile, row pitch kTile * C
  float* win = smem + kTile * kTile * C;        // the source window (16-byte aligned)
  __shared__ int part[kWarps][4];               // per-warp window bounds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int j = tx0 + lane;  // this thread's output column; rows ty0 + warp + k * kWarps
  const int row = W * C;     // floats per image row

  // 1. source coordinates, op by op in the plain version's order
  const float* h = hom + 9 * b;
  float hm[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) hm[k] = __ldg(h + k);
  const float x = __ldg(xs + min(j, W - 1));
  const float hx0 = __fmul_rn(hm[0], x), hx1 = __fmul_rn(hm[3], x), hx2 = __fmul_rn(hm[6], x);
  float sx[kPix], sy[kPix];
  int xmin = INT_MAX, xmax = -1, ymin = INT_MAX, ymax = -1;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int i = ty0 + warp + k * kWarps;
    if (j >= W || i >= H) {  // outside the image: no taps, never stored
      sx[k] = sy[k] = __int_as_float(0x7fc00000);
      continue;
    }
    const float y = __ldg(ys + i);
    const float w0 = __fadd_rn(__fadd_rn(hx0, __fmul_rn(hm[1], y)), hm[2]);
    const float w1 = __fadd_rn(__fadd_rn(hx1, __fmul_rn(hm[4], y)), hm[5]);
    const float w2 = __fadd_rn(__fadd_rn(hx2, __fmul_rn(hm[7], y)), hm[8]);
    sx[k] = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(w0, w2), 1.f), 0.5f), (float)(W - 1));
    sy[k] = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(w1, w2), 1.f), 0.5f), (float)(H - 1));
    // 2. this pixel's in-frame taps, tested in float before any cast
    if (NEAREST) {
      const float nx = floorf(__fadd_rn(sx[k], 0.5f)), ny = floorf(__fadd_rn(sy[k], 0.5f));
      if (inside(nx, ny, W, H)) {
        xmin = min(xmin, (int)nx); xmax = max(xmax, (int)nx);
        ymin = min(ymin, (int)ny); ymax = max(ymax, (int)ny);
      }
    } else {
      const float x0 = floorf(sx[k]), y0 = floorf(sy[k]);
      const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
      const bool xi0 = in_range(x0, W), xi1 = in_range(x1, W);
      const bool yi0 = in_range(y0, H), yi1 = in_range(y1, H);
      if ((xi0 || xi1) && (yi0 || yi1)) {
        xmin = min(xmin, (int)(xi0 ? x0 : x1)); xmax = max(xmax, (int)(xi1 ? x1 : x0));
        ymin = min(ymin, (int)(yi0 ? y0 : y1)); ymax = max(ymax, (int)(yi1 ? y1 : y0));
      }
    }
  }

  // 3. the tile's window: the bounding box of every in-frame tap
  xmin = __reduce_min_sync(0xffffffffu, xmin); xmax = __reduce_max_sync(0xffffffffu, xmax);
  ymin = __reduce_min_sync(0xffffffffu, ymin); ymax = __reduce_max_sync(0xffffffffu, ymax);
  if (lane == 0) {
    part[warp][0] = xmin; part[warp][1] = xmax; part[warp][2] = ymin; part[warp][3] = ymax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    xmin = min(xmin, part[w][0]); xmax = max(xmax, part[w][1]);
    ymin = min(ymin, part[w][2]); ymax = max(ymax, part[w][3]);
  }
  const bool empty = xmax < xmin;  // no tap of the tile lies in the frame
  int c0 = 0, pitch = 0;           // the window's first float column and its row length
  bool in_smem = true;
  if (empty) {
    ymin = 0;
  } else {
    c0 = xmin * C;
    int c1 = (xmax + 1) * C;
    if (vec) { c0 &= ~3; c1 = (c1 + 3) & ~3; }  // 16-byte chunks; c1 <= row as row % 4 == 0
    pitch = c1 - c0;
    in_smem = (long long)pitch * (ymax - ymin + 1) * 4 <= kWindowBytes;
  }

  // 4. sample from the window in shared memory, or from global memory,
  //    into the output stage
  const float* src = img + (size_t)b * H * row;
  float* dst = stage + warp * (kTile * C) + lane * C;  // pixel k: + k * kWarps * kTile * C
  float o[C];
  if (in_smem) {  // block-uniform
    if (!empty) {
      const int wh = ymax - ymin + 1;
      for (int r = warp; r < wh; r += kWarps) {
        const float* g = src + (size_t)(ymin + r) * row + c0;
        float* s = win + r * pitch;
        if (vec) {
          for (int q = lane * 4; q < pitch; q += 128) cp_async16(s + q, g + q);
        } else {
          for (int q = lane; q < pitch; q += 32) cp_async4(s + q, g + q);
        }
      }
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      sample<C, NEAREST, true>(win, pitch, ymin, c0, H, W, sx[k], sy[k], o);
#pragma unroll
      for (int c = 0; c < C; ++c) dst[k * kWarps * kTile * C + c] = o[c];
    }
  } else {
    if (global_tiles != nullptr && threadIdx.x == 0) atomicAdd(global_tiles, 1);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      sample<C, NEAREST, false>(src, row, 0, 0, H, W, sx[k], sy[k], o);
#pragma unroll
      for (int c = 0; c < C; ++c) dst[k * kWarps * kTile * C + c] = o[c];
    }
  }

  // 5. store the staged tile in 16-byte stores
  __syncthreads();
  const int n = min(kTile, W - tx0) * C;  // floats in one tile row
  const int th = min(kTile, H - ty0);
  for (int r = warp; r < th; r += kWarps) {
    const float* s = stage + r * (kTile * C);
    float* d = out + ((size_t)b * H + ty0 + r) * row + (size_t)tx0 * C;
    if (vec) {  // d is 16-byte aligned: row % 4 == 0 and tx0 * C % 4 == 0
      for (int q = lane * 4; q < n; q += 128) {
        if (q + 4 <= n) {
          *reinterpret_cast<float4*>(d + q) = *reinterpret_cast<const float4*>(s + q);
        } else {
          for (int e = q; e < n; ++e) d[e] = s[e];
        }
      }
    } else {
      for (int e = lane; e < n; e += 32) d[e] = s[e];
    }
  }
}

template <int C, bool NEAREST>
cudaError_t launch(const float* img, const float* hom, const float* xs, const float* ys, float* out,
                   int B, int H, int W, int* global_tiles, cudaStream_t stream) {
  static unsigned configured = 0;  // one bit per device: the attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(warp_kernel<C, NEAREST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(C));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(warp_kernel<C, NEAREST>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  const int vec = (W * C) % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  warp_kernel<C, NEAREST><<<grid, kThreads, smem_bytes(C), stream>>>(img, hom, xs, ys, out, H, W,
                                                                     vec, global_tiles);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mode(const float* img, const float* hom, const float* xs, const float* ys,
                        float* out, int B, int H, int W, int nearest, int* global_tiles,
                        cudaStream_t stream) {
  if (nearest) return launch<C, true>(img, hom, xs, ys, out, B, H, W, global_tiles, stream);
  return launch<C, false>(img, hom, xs, ys, out, B, H, W, global_tiles, stream);
}

}  // namespace

// `global_tiles` may be null; else it gets one added per tile that samples
// from global memory (its window did not fit the shared-memory budget).
extern "C" int yp_warp_image(const void* img, const void* hom, const void* xs, const void* ys,
                             void* out, int B, int H, int W, int C, int nearest,
                             void* global_tiles, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC || B > 65535 ||
      (H + kTile - 1) / kTile > 65535 || (long long)H * W * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const float* im = static_cast<const float*>(img);
  const float* hm = static_cast<const float*>(hom);
  const float* gx = static_cast<const float*>(xs);
  const float* gy = static_cast<const float*>(ys);
  float* o = static_cast<float*>(out);
  int* g = static_cast<int*>(global_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch_mode<1>(im, hm, gx, gy, o, B, H, W, nearest, g, s);
    case 2: return (int)launch_mode<2>(im, hm, gx, gy, o, B, H, W, nearest, g, s);
    case 3: return (int)launch_mode<3>(im, hm, gx, gy, o, B, H, W, nearest, g, s);
    default: return (int)launch_mode<4>(im, hm, gx, gy, o, B, H, W, nearest, g, s);
  }
}
