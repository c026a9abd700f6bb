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
// output; there are ~2 flops per byte, so no tensor core applies (on the TPU
// the map sat in VMEM and sampling was a bf16 one-hot matmul on the MXU; a
// gather is native here, and exact in f32). What keeps a gather from its
// bound is latency: a point's chain is a load of the point, its index math,
// the four tap loads, a reduction and the stores. So the design aims at
// bytes in flight and few instructions a byte:
//   - the width D is a template parameter, with an instantiation for each
//     family's width (64, 128, 192, 256, 320): a group of `kFamilyLanes` = 16
//     lanes (half a warp) takes a point, each lane D / 64 vectors of 4
//     channels of each tap row (a 16-byte load in f32, 8 bytes in bf16) and
//     writes them as 16-byte stores; no lane slot is dead, and a warp
//     carries two points with all their tap loads issued before any is used;
//   - blocks are two warps (four points), so a batch-1 launch (N = 600-1000:
//     150-250 blocks) spreads over all 132 SMs;
//   - any other D <= 512, or a map or output whose base is not aligned to a
//     vector, takes the generic instantiation of the same kernel (`kD` =
//     0): the width at run time, one channel a load, 16 predicated loads a
//     lane of 32 lanes.
// The entry point picks the instantiation from D and the pointers.
// `tools/bench_torch_gather.py` builds variants of this file with 8 or 32
// lanes a point (`kFamilyLanes`, `lanes_a_point`), 2 or 4 points a group
// (`kPoints`: all their tap loads issued before any is used) and four-warp
// blocks. Only a warp a point at D = 128 and 256 was faster anywhere (at
// batch 1, with the map read from memory; equal at batch 16), and it keeps
// one point in a warp (PERF.md).
// The blend keeps the reference's operation order, each step rounded and
// without FMA contraction; only the norm's summation order is the kernel's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;     // two warps a block
constexpr int kFamilyLanes = 16; // lanes a point at a family's width
constexpr int kPoints = 1;       // points a lane group carries at once
constexpr int kMaxWidth = 512;   // the generic instantiation's 16 channels a lane

// lanes a point at width d (0: the generic instantiation)
__host__ __device__ constexpr int lanes_a_point(int d) { return d == 0 ? 32 : kFamilyLanes; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four channels starting at p (16-byte aligned in f32, 8-byte in bf16)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// kD: the width (0: generic, D at run time)
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
sample_descriptors_kernel(const T* __restrict__ desc, const float* __restrict__ pts,
                          float* __restrict__ out, int B, int Hc, int Wc, int D, int N, int cell) {
  constexpr bool kGeneric = kD == 0;
  constexpr int kLanes = lanes_a_point(kD);
  constexpr int kVec = kGeneric ? 1 : 4;                          // channels a load
  constexpr int kPerLane = kGeneric ? kMaxWidth / kLanes : kD / (kLanes * kVec);
  constexpr int kGroups = kThreads / kLanes;
  static_assert(kGeneric || kD % (kLanes * kVec) == 0, "a lane takes whole vectors");
  const int width = kGeneric ? D : kD;
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const long long total = (long long)B * N;
  // point i of the group is first + i * kGroups + group: one load
  // instruction of a warp reads neighbouring points
  const long long first = (long long)blockIdx.x * kGroups * kPoints + group;

  float2 p[kPoints];  // read as two floats: the points need no 8-byte alignment
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const long long q = first + (long long)i * kGroups;
    p[i] = q < total ? make_float2(pts[2 * q], pts[2 * q + 1]) : make_float2(0.f, 0.f);
  }

  const T* r00[kPoints];
  float wx[kPoints], wy[kPoints];
  bool in00[kPoints], in01[kPoints], in10[kPoints], in11[kPoints];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const long long q = first + (long long)i * kGroups;
    const bool live = q < total;
    const int b = live ? (int)q / N : 0;  // total < 2^31
    // pixel -> [-1, 1] over the full-res image -> coarse pixel, align_corners
    const float xn = __fsub_rn(__fdiv_rn(p[i].x, 0.5f * (float)(Wc * cell)), 1.f);
    const float yn = __fsub_rn(__fdiv_rn(p[i].y, 0.5f * (float)(Hc * cell)), 1.f);
    const float cx = __fmul_rn(__fmul_rn(__fadd_rn(xn, 1.f), 0.5f), (float)(Wc - 1));
    const float cy = __fmul_rn(__fmul_rn(__fadd_rn(yn, 1.f), 0.5f), (float)(Hc - 1));
    const float fx = floorf(cx), fy = floorf(cy);
    wx[i] = cx - fx;
    wy[i] = cy - fy;
    const int x0 = (int)fx, y0 = (int)fy;
    const bool inx0 = x0 >= 0 && x0 < Wc, inx1 = x0 + 1 >= 0 && x0 + 1 < Wc;
    const bool iny0 = y0 >= 0 && y0 < Hc, iny1 = y0 + 1 >= 0 && y0 + 1 < Hc;
    in00[i] = live && iny0 && inx0;
    in01[i] = live && iny0 && inx1;
    in10[i] = live && iny1 && inx0;
    in11[i] = live && iny1 && inx1;
    r00[i] = desc + (((long long)b * Hc + y0) * Wc + x0) * width;
  }

  // every tap load of every point, before any value is used
  float v[kPoints][4][kPerLane][kVec];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const T* rows[4] = {r00[i], r00[i] + width, r00[i] + (long long)Wc * width,
                        r00[i] + (long long)(Wc + 1) * width};
    const bool in[4] = {in00[i], in01[i], in10[i], in11[i]};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = (k * kLanes + lane) * kVec;
        if constexpr (kGeneric) {
          v[i][t][k][0] = (in[t] && c < D) ? to_f32(rows[t][c]) : 0.f;
        } else if (in[t]) {
          load4(rows[t] + c, v[i][t][k]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[i][t][k][j] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const float ux = __fsub_rn(1.f, wx[i]), uy = __fsub_rn(1.f, wy[i]);
    float acc[kPerLane][kVec];
    float n2 = 0.f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        // the reference's operation order, each rounded (no FMA contraction)
        const float top = __fadd_rn(__fmul_rn(v[i][0][k][j], ux), __fmul_rn(v[i][1][k][j], wx[i]));
        const float bot = __fadd_rn(__fmul_rn(v[i][2][k][j], ux), __fmul_rn(v[i][3][k][j], wx[i]));
        acc[k][j] = __fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, wy[i]));
        n2 += acc[k][j] * acc[k][j];
      }
    }
    // the group's lanes are a power of two aligned in the warp: the xor
    // offsets below kLanes stay inside it
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
    const float inv = rsqrtf(fmaxf(n2, 1e-16f));
    const long long q = first + (long long)i * kGroups;
    if (q >= total) continue;
    float* o = out + q * width;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = (k * kLanes + lane) * kVec;
      if constexpr (kGeneric) {
        if (c < D) o[c] = acc[k][0] * inv;
      } else {
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[k][0] * inv, acc[k][1] * inv, acc[k][2] * inv, acc[k][3] * inv);
      }
    }
  }
}

template <typename T, int kD>
int launch(const void* desc, const void* pts, void* out, int B, int Hc, int Wc, int D, int N,
           int cell, cudaStream_t stream) {
  constexpr long long kPerBlock = (kThreads / lanes_a_point(kD)) * kPoints;
  const unsigned blocks = (unsigned)(((long long)B * N + kPerBlock - 1) / kPerBlock);
  sample_descriptors_kernel<T, kD><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(desc), static_cast<const float*>(pts), static_cast<float*>(out),
      B, Hc, Wc, D, N, cell);
  return (int)cudaGetLastError();
}

// D's own instantiation where the map's base holds whole vectors (rows of a
// family's width then do too) and the output's base 16 bytes, else the
// generic one
template <typename T>
int dispatch(const void* desc, const void* pts, void* out, int B, int Hc, int Wc, int D, int N,
             int cell, cudaStream_t s) {
  const bool aligned = reinterpret_cast<uintptr_t>(desc) % (4 * sizeof(T)) == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned) {
    switch (D) {
      case 64: return launch<T, 64>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
      case 128: return launch<T, 128>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
      case 192: return launch<T, 192>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
      case 256: return launch<T, 256>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
      case 320: return launch<T, 320>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
      default: break;
    }
  }
  return launch<T, 0>(desc, pts, out, B, Hc, Wc, D, N, cell, s);
}

}  // namespace

extern "C" int yp_sample_descriptors(const void* desc, int desc_is_bf16, const void* points,
                                     void* out, int B, int Hc, int Wc, int D, int N, int cell,
                                     void* stream) {
  if (B <= 0 || N <= 0 || Hc <= 0 || Wc <= 0 || D <= 0 || D > kMaxWidth || cell <= 0 ||
      (long long)B * N > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return desc_is_bf16 ? dispatch<__nv_bfloat16>(desc, points, out, B, Hc, Wc, D, N, cell, s)
                      : dispatch<float>(desc, points, out, B, Hc, Wc, D, N, cell, s);
}

extern "C" const char* yp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
