// K4 + K5: inverse homography warp of NHWC f32 images, for sm_90a.
//
// Replaces both Pallas warps of yolopoint_tpu/ops/pallas_warp.py: `_kernel`
// (K5, the whole image resident in VMEM, launched by `_warp_pallas` /
// `warp_image_pallas`) and `_wkernel` (K4, a DMA'd source window per
// 16x128 output tile, launched by `_warp_pallas_windowed` /
// `warp_image_pallas_windowed`). For each output pixel (b, i, j): the
// normalized output coords (xs[j], ys[i]) go through the output -> source
// homography, w_k = (h_k0 x + h_k1 y) + h_k2, then (w0 / w2, w1 / w2) is
// mapped to source pixels, ((s + 1) * 0.5) * (size - 1); the pixel is
// sampled bilinearly, or nearest with floor(s + 0.5), zero outside the
// frame. C <= 4 channels, f32 in and out. It computes the exact f32
// `_warp_image_xla` of yolopoint_tpu/ops/geometry.py; every operation is
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn, no FMA
// contraction), in the plain version's order, so nearest mode picks the
// same pixel as the plain version on the same grid.
//
// Bound on this card: bytes, one read and one write of the f32 image
// (~2 flops per byte). The TPU has no vector gather, so its kernels recast
// the warp as bf16 one-hot / tent matmuls on the MXU over VMEM-resident
// images (K5) or windows (K4). Hopper gathers natively and its L1/L2 do
// what VMEM residency and the windows did: one thread per output pixel
// does its own coordinate math and reads its 4 taps (nearest: 1) of all C
// channels through the read-only cache; neighbouring threads read
// neighbouring source pixels. No window (K4 zeroed taps outside its
// max_scale window) and no bf16 rounding of taps or weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;

__device__ __forceinline__ bool inside(float x, float y, int W, int H) {
  return x >= 0.f && x <= (float)(W - 1) && y >= 0.f && y <= (float)(H - 1);
}

template <int C, bool NEAREST>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ img, const float* __restrict__ hom,
            const float* __restrict__ xs, const float* __restrict__ ys,
            float* __restrict__ out, int B, int H, int W) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long HW = (long long)H * W;
  if (p >= (long long)B * HW) return;
  const int b = (int)(p / HW);
  const int rem = (int)(p - (long long)b * HW);
  const int i = rem / W, j = rem - (rem / W) * W;

  const float* h = hom + 9 * b;
  const float x = __ldg(xs + j), y = __ldg(ys + i);
  const float w0 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(h + 0), x), __fmul_rn(__ldg(h + 1), y)), __ldg(h + 2));
  const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(h + 3), x), __fmul_rn(__ldg(h + 4), y)), __ldg(h + 5));
  const float w2 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(h + 6), x), __fmul_rn(__ldg(h + 7), y)), __ldg(h + 8));
  const float sx = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(w0, w2), 1.f), 0.5f), (float)(W - 1));
  const float sy = __fmul_rn(__fmul_rn(__fadd_rn(__fdiv_rn(w1, w2), 1.f), 0.5f), (float)(H - 1));

  const float* src = img + (size_t)b * HW * C;
  float* o = out + (size_t)p * C;
  if (NEAREST) {
    const float nx = floorf(__fadd_rn(sx, 0.5f)), ny = floorf(__fadd_rn(sy, 0.5f));
    const bool in = inside(nx, ny, W, H);
    const float* t = src + ((long long)(in ? ny : 0.f) * W + (long long)(in ? nx : 0.f)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = in ? __ldg(t + c) : 0.f;
    return;
  }
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const bool in00 = inside(x0, y0, W, H), in01 = inside(x1, y0, W, H);
  const bool in10 = inside(x0, y1, W, H), in11 = inside(x1, y1, W, H);
  // a tap outside the frame reads pixel 0 and is replaced by 0 below
  const float* t00 = src + (in00 ? ((long long)y0 * W + (long long)x0) * C : 0);
  const float* t01 = src + (in01 ? ((long long)y0 * W + (long long)x1) * C : 0);
  const float* t10 = src + (in10 ? ((long long)y1 * W + (long long)x0) * C : 0);
  const float* t11 = src + (in11 ? ((long long)y1 * W + (long long)x1) * C : 0);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v00 = in00 ? __ldg(t00 + c) : 0.f;
    const float v01 = in01 ? __ldg(t01 + c) : 0.f;
    const float v10 = in10 ? __ldg(t10 + c) : 0.f;
    const float v11 = in11 ? __ldg(t11 + c) : 0.f;
    const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, wx));
    o[c] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy));
  }
}

template <int C>
int launch(const float* img, const float* hom, const float* xs, const float* ys, float* out,
           int B, int H, int W, int nearest, cudaStream_t stream) {
  const long long n = (long long)B * H * W;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (nearest)
    warp_kernel<C, true><<<blocks, kThreads, 0, stream>>>(img, hom, xs, ys, out, B, H, W);
  else
    warp_kernel<C, false><<<blocks, kThreads, 0, stream>>>(img, hom, xs, ys, out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yp_warp_image(const void* img, const void* hom, const void* xs, const void* ys,
                             void* out, int B, int H, int W, int C, int nearest, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC ||
      (long long)B * H * W > (long long)INT32_MAX * kThreads)
    return (int)cudaErrorInvalidValue;
  const float* im = static_cast<const float*>(img);
  const float* hm = static_cast<const float*>(hom);
  const float* gx = static_cast<const float*>(xs);
  const float* gy = static_cast<const float*>(ys);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(im, hm, gx, gy, o, B, H, W, nearest, s);
    case 2: return launch<2>(im, hm, gx, gy, o, B, H, W, nearest, s);
    case 3: return launch<3>(im, hm, gx, gy, o, B, H, W, nearest, s);
    default: return launch<4>(im, hm, gx, gy, o, B, H, W, nearest, s);
  }
}
