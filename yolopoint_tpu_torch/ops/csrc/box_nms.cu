// K2: exact greedy box NMS keep mask, for sm_90a.
//
// Replaces the TPU kernel `_kernel` in yolopoint_tpu/ops/pallas_box_nms.py
// (launched by `pallas_greedy_nms`). Input: score-sorted, class-offset xyxy
// boxes (B, K, 4) f32 and a validity mask (B, K), K <= kMaxK; output: the
// (B, K) greedy keep mask, equal to the Jacobi fixpoint `_greedy_nms_keep` of
// yolopoint_tpu/ops/nms.py. Box i is kept iff it is valid and no earlier kept
// box overlaps it with IoU > thr.
//
// Bound on this card: K(K-1)/2 IoUs per image (operations); the boxes in and
// the mask out are a few KB. The TPU kernel ran the recursion as a blockwise
// Jacobi fixpoint of 0/1 mat-vecs on the MXU. Here one launch has two phases:
//
// (1) The overlap bitmask, spread over the card. Word w of row i holds bit j
//     iff column 32w + j > i, both boxes are valid and their IoU > thr. A CTA
//     takes one block of 32 rows (staged in shared memory) and up to
//     kMaxWarps of the column words from the diagonal on; a warp makes one
//     32 x 32 bit block: lane j holds column box 32w + j in registers and
//     tests it against each valid row in turn, and one ballot gives each
//     row's word. Only words that hold some j > i are made; a row block with
//     no valid box writes nothing (no kept row reads it) and a column word
//     with no valid box is 0 without arithmetic. The warps of a CTA, and so
//     the number of CTAs, are picked from (B, K) so that small launches still
//     spread over the SMs. Pairs whose intersection is 0 (all pairs of
//     different classes) skip the division: 0/den is 0, -0 or NaN, none of
//     which is > thr when thr >= 0, so the bit is exact. The mask is stored
//     column word major, m[w][i], so that what the scan needs next is one
//     contiguous run.
// (2) The greedy scan, one warp of the last CTA of the image to finish (an
//     arrival counter per image, reset by that CTA for the next launch). It
//     walks the 32-row blocks in order. For block w it needs column word w of
//     every earlier row, m[w][0 .. 32w), which cp.async brings into a ring
//     of shared buffers kScanDepth - 1 blocks ahead, while the warp resolves
//     the blocks before it; the words of the kept earlier rows are ORed,
//     lane by lane, then across the warp (one redux), which gives the boxes
//     of block w already removed.
//     The block itself is resolved serially from its diagonal words (one
//     shuffle each, all independent of the scan's state). So the scan never
//     waits on device memory once per kept box, and an image with no valid
//     box costs a pass over `valid`.
//
// The IoU is `box_iou` of yolopoint_tpu/ops/boxes.py with eps 1e-7, each
// operation rounded on its own (__f*_rn: no FMA contraction), min and max
// passing NaN on as torch.minimum / torch.maximum / clamp do, so the mask is
// bit-for-bit the one the CPU computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 32;                 // boxes per mask word: one warp's ballot
constexpr int kMaxK = 2048;               // the dense keep's candidate cap
constexpr int kMaxWords = kMaxK / kWord;  // mask words per row at most
constexpr int kMaxWarps = 8;              // warps of a mask CTA at most
constexpr int kSms = 132;                 // SMs of the H100 SXM
constexpr int kFillCtas = 2 * kSms;       // CTAs a launch should have at least
constexpr int kScanDepth = 2;             // column words the scan has in flight, plus one
constexpr int kSmemDefault = 48 * 1024;   // a block's shared memory without opting in

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// clamp(x, min=0), NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float area_rn(float4 a) {
  return __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
}

// IoU(a, c) > thr, as box_iou computes the IoU
__device__ __forceinline__ bool overlaps(float4 a, float4 c, float area_a, float area_c,
                                         float thr) {
  const float w = clamp0(__fsub_rn(min_nan(a.z, c.z), max_nan(a.x, c.x)));
  const float h = clamp0(__fsub_rn(min_nan(a.w, c.w), max_nan(a.y, c.y)));
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f && thr >= 0.f) return false;  // 0/den is 0, -0 or NaN
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_c), inter), 1e-7f);
  return __fdiv_rn(inter, den) > thr;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The scan of one image by one warp (see (2) above). `buf` holds
// kScanDepth slots of KP words: column word w goes to slot w % kScanDepth,
// fetched kScanDepth - 1 blocks ahead.
__device__ void greedy_scan(const uint32_t* __restrict__ m, const uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ keep, uint32_t* buf, int K, int nw) {
  const int lane = threadIdx.x % kWord, KP = nw * kWord;
  // column word w of rows [0, 32(w + 1)) into its slot
  auto fetch = [&](int w) {
    if (w >= nw) return;
    const uint32_t* src = m + (size_t)w * KP;
    uint32_t* dst = buf + (w % kScanDepth) * KP;
    for (int q = lane; q < (w + 1) * kWord / 4; q += kWord) cp_async16(dst + 4 * q, src + 4 * q);
  };
  // bit w: row 32w + lane is valid
  uint64_t my_valid = 0;
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const int i = w * kWord + lane;
    if (w < nw && i < K && valid[i]) my_valid |= 1ull << w;
  }
  if (!__any_sync(~0u, my_valid != 0)) {  // nothing valid: nothing kept
    for (int i = lane; i < K; i += kWord) keep[i] = 0;
    return;
  }
  for (int w = 0; w < kScanDepth - 1; ++w) {
    fetch(w);
    cp_async_commit();
  }
  uint64_t my_kept = 0;  // bit w: row 32w + lane is kept
  for (int w = 0; w < nw; ++w) {
    fetch(w + kScanDepth - 1);  // into the slot read in the last iteration
    cp_async_commit();
    const uint32_t vbits = __ballot_sync(~0u, (my_valid >> w) & 1u);
    uint32_t kept = 0;
    cp_async_wait<kScanDepth - 1>();  // column w has landed
    __syncwarp();
    if (vbits) {
      const uint32_t* col = buf + (w % kScanDepth) * KP;
      uint32_t acc = 0;
#pragma unroll 8
      for (int b = 0; b < w; ++b)
        if ((my_kept >> b) & 1u) acc |= col[b * kWord + lane];
      uint32_t removed = __reduce_or_sync(~0u, acc) | ~vbits;
      const uint32_t diag = col[w * kWord + lane];
#pragma unroll
      for (int r = 0; r < kWord; ++r) {
        const uint32_t d = __shfl_sync(~0u, diag, r);
        if (!((removed >> r) & 1u)) removed |= d;
      }
      kept = ~removed;
    }
    const uint32_t mine = (kept >> lane) & 1u;
    my_kept |= (uint64_t)mine << w;
    if (w * kWord + lane < K) keep[w * kWord + lane] = (uint8_t)mine;
    __syncwarp();  // the slot read here is the next fetch's target
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(kMaxWarps * kWord)
greedy_nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, uint32_t* __restrict__ mask,
                  unsigned* __restrict__ arrivals, int K, float thr) {
  extern __shared__ __align__(16) uint32_t scan_buf[];  // kScanDepth * KP words, for the scan
  __shared__ float4 row_box[kWord];
  __shared__ float row_area[kWord];
  __shared__ uint32_t row_bits;
  __shared__ int is_last;

  const int nw = (K + kWord - 1) / kWord, KP = nw * kWord;
  const int lane = threadIdx.x % kWord, warp = threadIdx.x / kWord, W = blockDim.x / kWord;
  const int b = blockIdx.y;
  const float4* bx = boxes + (size_t)b * K;
  const uint8_t* vl = valid + (size_t)b * K;
  uint32_t* m = mask + (size_t)b * nw * KP;

  // this CTA's row block rb and its first column word: row block rb has
  // ceil((nw - rb) / W) CTAs
  int rb = 0, c = blockIdx.x;
  for (int n = (nw + W - 1) / W; c >= n; n = (nw - rb + W - 1) / W) {
    c -= n;
    ++rb;
  }
  if (warp == 0) {
    const int i = rb * kWord + lane;
    const bool v = i < K && vl[i];
    const float4 a = v ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    row_box[lane] = a;
    row_area[lane] = area_rn(a);
    const uint32_t bits = __ballot_sync(~0u, v);
    if (lane == 0) row_bits = bits;
  }
  __syncthreads();
  const uint32_t rows = row_bits;
  const int w = rb + c * W + warp;
  if (rows && w < nw) {
    const int j = w * kWord + lane;
    const bool cv = j < K && vl[j];
    const float4 cb = cv ? bx[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ca = area_rn(cb);
    uint32_t mine = 0;
    if (__ballot_sync(~0u, cv)) {
#pragma unroll 4
      for (int r = 0; r < kWord; ++r) {
        if (!((rows >> r) & 1u)) continue;
        const bool bit = cv && j > rb * kWord + r &&
                         overlaps(row_box[r], cb, row_area[r], ca, thr);
        const uint32_t word = __ballot_sync(~0u, bit);
        if (lane == r) mine = word;
      }
    }
    m[(size_t)w * KP + rb * kWord + lane] = mine;
  }

  // the last CTA of the image to arrive scans it
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&arrivals[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last || warp != 0) return;
  __threadfence();
  if (lane == 0) arrivals[b] = 0u;  // ready for the next launch
  greedy_scan(m, vl, keep + (size_t)b * K, scan_buf, K, nw);
}

// Mask CTAs of one image with W warps each: row block rb has ceil((nw - rb) / W).
int mask_ctas(int nw, int W) {
  int n = 0;
  for (int k = 1; k <= nw; ++k) n += (k + W - 1) / W;
  return n;
}

// The warps of a mask CTA: the most (up to kMaxWarps) that still give the
// launch kFillCtas CTAs.
int mask_warps(int B, int nw) {
  int W = kMaxWarps;
  while (W > 1 && (long long)B * mask_ctas(nw, W) < kFillCtas) W /= 2;
  return W;
}

}  // namespace

extern "C" int yp_greedy_nms(const void* boxes, const void* valid, void* keep, void* mask_scratch,
                             void* arrivals, int B, int K, float iou_thres, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK || B > 65535) return (int)cudaErrorInvalidValue;
  const int nw = (K + kWord - 1) / kWord;
  const int W = mask_warps(B, nw);
  const dim3 grid(mask_ctas(nw, W), B);
  const size_t smem = (size_t)kScanDepth * nw * kWord * sizeof(uint32_t);
  if (smem > kSmemDefault - 1024) {  // the static shared arrays take < 1 KB
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<grid, W * kWord, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), static_cast<uint32_t*>(mask_scratch),
      static_cast<unsigned*>(arrivals), K, iou_thres);
  return (int)cudaGetLastError();
}
