// K3: bilinear descriptor sampling + L2 renorm, for sm_90a.
//
// Replaces the TPU kernel `_kernel` in yolopoint_tpu/ops/pallas_gather.py
// (launched by `_sample_pallas` / `sample_descriptors_pallas`). For (B, N)
// full-resolution points (x, y) on a (B, Hc, Wc, D) coarse descriptor map
// (f32 or bf16): align-corners bilinear sampling with zero weight for taps
// outside the map, then L2 renorm with rsqrt(max(|v|^2, 1e-16)); output
// (B, N, D) f32. It computes the exact f32 `sample_descriptors` of
// yolopoint_tpu/ops/sampling.py.
//
// Bound on this card: bytes, the distinct map rows the points tap plus the
// output; there are ~2 flops per byte. On the TPU the map sat in VMEM and
// sampling was a bf16 one-hot matmul on the MXU; on Hopper a gather is
// native, so one warp takes one point: each tap is one coalesced read of D
// channels (lane c reads channels c, c+32, ...), accumulation in f32
// registers, and a warp-shuffle reduction of the norm. No bf16 rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerLane = 16;  // D <= 512

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sample_descriptors_kernel(const T* __restrict__ desc, const float2* __restrict__ pts,
                          float* __restrict__ out, int B, int Hc, int Wc, int D, int N, int cell) {
  const int warp = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B * N) return;  // uniform per warp
  const int b = warp / N;
  const float2 p = pts[warp];
  // pixel -> [-1, 1] over the full-res image -> coarse pixel, align_corners
  const float xn = __fsub_rn(__fdiv_rn(p.x, 0.5f * (float)(Wc * cell)), 1.f);
  const float yn = __fsub_rn(__fdiv_rn(p.y, 0.5f * (float)(Hc * cell)), 1.f);
  const float cx = __fmul_rn(__fmul_rn(__fadd_rn(xn, 1.f), 0.5f), (float)(Wc - 1));
  const float cy = __fmul_rn(__fmul_rn(__fadd_rn(yn, 1.f), 0.5f), (float)(Hc - 1));
  const float fx = floorf(cx), fy = floorf(cy);
  const float wx = cx - fx, wy = cy - fy;
  const int x0 = (int)fx, y0 = (int)fy;
  const bool inx0 = x0 >= 0 && x0 < Wc, inx1 = x0 + 1 >= 0 && x0 + 1 < Wc;
  const bool iny0 = y0 >= 0 && y0 < Hc, iny1 = y0 + 1 >= 0 && y0 + 1 < Hc;
  const T* map = desc + (size_t)b * Hc * Wc * D;
  const T* r00 = map + ((long long)y0 * Wc + x0) * D;
  const T* r01 = r00 + D;
  const T* r10 = r00 + (long long)Wc * D;
  const T* r11 = r10 + D;

  float acc[kMaxPerLane];
  float n2 = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    acc[k] = 0.f;
    if (c < D) {
      const float v00 = (iny0 && inx0) ? to_f32(r00[c]) : 0.f;
      const float v01 = (iny0 && inx1) ? to_f32(r01[c]) : 0.f;
      const float v10 = (iny1 && inx0) ? to_f32(r10[c]) : 0.f;
      const float v11 = (iny1 && inx1) ? to_f32(r11[c]) : 0.f;
      // the reference's operation order, each rounded (no FMA contraction)
      const float top = __fadd_rn(__fmul_rn(v00, __fsub_rn(1.f, wx)), __fmul_rn(v01, wx));
      const float bot = __fadd_rn(__fmul_rn(v10, __fsub_rn(1.f, wx)), __fmul_rn(v11, wx));
      acc[k] = __fadd_rn(__fmul_rn(top, __fsub_rn(1.f, wy)), __fmul_rn(bot, wy));
      n2 += acc[k] * acc[k];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
  const float inv = rsqrtf(fmaxf(n2, 1e-16f));
  float* o = out + (size_t)warp * D;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < D) o[c] = acc[k] * inv;
  }
}

template <typename T>
int launch(const void* desc, const void* pts, void* out, int B, int Hc, int Wc, int D, int N,
           int cell, cudaStream_t stream) {
  const long long warps = (long long)B * N;
  const int per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  sample_descriptors_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(desc), static_cast<const float2*>(pts), static_cast<float*>(out),
      B, Hc, Wc, D, N, cell);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int yp_sample_descriptors(const void* desc, int desc_is_bf16, const void* points,
                                     void* out, int B, int Hc, int Wc, int D, int N, int cell,
                                     void* stream) {
  if (B <= 0 || N <= 0 || Hc <= 0 || Wc <= 0 || D <= 0 || D > 32 * kMaxPerLane || cell <= 0 ||
      (long long)B * N > (1LL << 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return desc_is_bf16 ? launch<__nv_bfloat16>(desc, points, out, B, Hc, Wc, D, N, cell, s)
                      : launch<float>(desc, points, out, B, Hc, Wc, D, N, cell, s);
}

extern "C" const char* yp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
