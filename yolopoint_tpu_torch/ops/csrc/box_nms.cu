// K2: exact greedy box NMS keep mask, for sm_90a.
//
// Replaces the TPU kernel `_kernel` in yolopoint_tpu/ops/pallas_box_nms.py
// (launched by `pallas_greedy_nms`). Input: score-sorted, class-offset xyxy
// boxes (B, K, 4) f32 and a validity mask (B, K); output: the (B, K) greedy
// keep mask, equal to the Jacobi fixpoint `_greedy_nms_keep` of
// yolopoint_tpu/ops/nms.py.
//
// Bound on this card: K(K-1)/2 IoUs per image (operations); the boxes in and
// the mask out are a few KB. The TPU kernel ran the greedy recursion as a
// blockwise Jacobi fixpoint of 0/1 mat-vecs on the MXU; here one CTA per
// image (1) writes the upper-triangular overlap bitmask (row i holds bit j
// iff j > i, both valid and IoU > thr) to a global scratch the wrapper
// allocates (K*K bits: 32 KB at K = 512, 512 KB at K = 2048, L2-resident),
// then (2) one warp scans it in the torchvision style: 32 boxes at a time,
// the warp resolves the block serially from its diagonal words (held one per
// lane, exchanged by shuffles), then ORs the kept rows into the removed-bit
// words of the later blocks, one word per lane.
//
// The IoU is `box_iou` of yolopoint_tpu/ops/boxes.py with eps 1e-7, each
// operation rounded on its own (__f*_rn: no FMA contraction), so the mask is
// bit-for-bit the one the CPU computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float area_rn(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

__device__ __forceinline__ float iou_rn(float4 a, float4 b, float area_a, float area_b) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return __fdiv_rn(inter, den);
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, uint32_t* __restrict__ mask, int K, float thr) {
  extern __shared__ float4 sbox[];
  float* sarea = reinterpret_cast<float*>(sbox + K);
  uint32_t* remv = reinterpret_cast<uint32_t*>(sarea + K);
  const int nw = (K + 31) / 32;
  uint8_t* sval = reinterpret_cast<uint8_t*>(remv + nw);

  const int b = blockIdx.x;
  const float4* bx = boxes + (size_t)b * K;
  uint32_t* m = mask + (size_t)b * K * nw;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float4 v = bx[i];
    sbox[i] = v;
    sarea[i] = area_rn(v);
    sval[i] = valid[(size_t)b * K + i] != 0;
  }
  for (int w = threadIdx.x; w < nw; w += blockDim.x) remv[w] = 0u;
  __syncthreads();

  // (1) overlap bits: row i suppresses strictly later columns j
  for (int idx = threadIdx.x; idx < K * nw; idx += blockDim.x) {
    const int i = idx / nw, w = idx - i * nw;
    uint32_t bits = 0u;
    const int j0 = max(w * 32, i + 1), j1 = min(w * 32 + 32, K);
    if (sval[i] && j0 < j1) {
      const float4 a = sbox[i];
      const float aa = sarea[i];
      for (int j = j0; j < j1; ++j)
        if (sval[j] && iou_rn(a, sbox[j], aa, sarea[j]) > thr) bits |= 1u << (j - w * 32);
    }
    m[idx] = bits;
  }
  __syncthreads();

  // (2) serial greedy scan, one warp
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int w = 0; w < nw; ++w) {
    const int i = w * 32 + lane;
    const uint32_t diag = i < K ? m[(size_t)i * nw + w] : 0u;
    uint32_t removed = remv[w];
    uint32_t kept = 0u;
    for (int bit = 0; bit < 32; ++bit) {
      const uint32_t d = __shfl_sync(0xffffffffu, diag, bit);
      const int ii = w * 32 + bit;
      if (ii < K && sval[ii] && !((removed >> bit) & 1u)) {
        kept |= 1u << bit;
        removed |= d;
      }
    }
    if (i < K) keep[(size_t)b * K + i] = (kept >> lane) & 1u;
    for (int w2 = w + 1 + lane; w2 < nw; w2 += 32) {
      uint32_t acc = remv[w2];
      for (uint32_t kk = kept; kk; kk &= kk - 1) {
        const int bit = __ffs(kk) - 1;
        acc |= m[(size_t)(w * 32 + bit) * nw + w2];
      }
      remv[w2] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int yp_greedy_nms(const void* boxes, const void* valid, void* keep, void* mask_scratch,
                             int B, int K, float iou_thres, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int nw = (K + 31) / 32;
  const size_t smem = (size_t)K * (sizeof(float4) + sizeof(float) + 1) + nw * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<uint32_t*>(mask_scratch), K, iou_thres);
  return (int)cudaGetLastError();
}
