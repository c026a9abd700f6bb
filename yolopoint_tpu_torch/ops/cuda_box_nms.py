"""K2: exact greedy box-NMS keep mask (CUDA kernel `csrc/box_nms.cu`).

Counterpart of `pallas_greedy_nms` in `yolopoint_tpu/ops/pallas_box_nms.py`
(the Pallas kernel `_kernel`). Input: score-sorted, class-offset xyxy boxes
`(B, K, 4)` f32 and a validity mask `(B, K)`; output: the `(B, K)` bool
greedy keep mask. A box is suppressed iff an earlier KEPT box overlaps it
with IoU > `iou_thres` (IoU of `box_iou`, eps 1e-7).

`greedy_nms_keep_torch` is the plain PyTorch version, the Jacobi fixpoint of
`_greedy_nms_keep` in `yolopoint_tpu/ops/nms.py`: the CPU path and the
kernel's reference on the card.

`launch_config` mirrors the kernel's choice of warps per mask CTA and its
grid (`mask_warps` in `csrc/box_nms.cu`); the tests emulate the kernel's
blocks from it. The kernel's scratch (the overlap bitmask and one arrival
counter per image, which the kernel returns to 0) is allocated once per
device and stream and reused.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.boxes import box_iou

# The launch configuration of `csrc/box_nms.cu` (the tests check each against
# the source's `constexpr` of the same role).
MAX_K = 2048        # the dense keep's candidate cap (`_DENSE_NMS_MAX` in the JAX package)
WORD = 32           # boxes per mask word
MAX_WARPS = 8       # warps of a mask CTA at most
SMS = 132           # SMs of the H100 SXM
FILL_CTAS = 2 * SMS  # CTAs a launch should have at least

# (device index, stream) -> (overlap bitmask, arrival counters)
_scratch: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def mask_ctas(nw: int, warps: int) -> int:
    """Mask CTAs of one image of `nw` words: row block rb has
    ceil((nw - rb) / warps) of them."""
    return sum(-(-k // warps) for k in range(1, nw + 1))


def launch_config(B: int, K: int) -> tuple[int, int]:
    """`(warps per CTA, CTAs per image)`: the most warps (up to MAX_WARPS)
    that still give the launch FILL_CTAS CTAs."""
    nw = -(-K // WORD)
    warps = MAX_WARPS
    while warps > 1 and B * mask_ctas(nw, warps) < FILL_CTAS:
        warps //= 2
    return warps, mask_ctas(nw, warps)


def _scratch_for(boxes: torch.Tensor, B: int, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bitmask (`B * nw * 32 nw` words, column word major per image) and
    `B` zeroed arrival counters of this device and stream, grown as needed."""
    nw = -(-K // WORD)
    key = (boxes.device.index, _build.stream_ptr(boxes))
    mask, arrivals = _scratch.get(key, (None, None))
    if mask is None or mask.numel() < B * nw * nw * WORD:
        mask = torch.empty(B * nw * nw * WORD, dtype=torch.int32, device=boxes.device)
    if arrivals is None or arrivals.numel() < B:
        arrivals = torch.zeros(B, dtype=torch.int32, device=boxes.device)
    _scratch[key] = (mask, arrivals)
    return mask, arrivals


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, got {tuple(valid.shape)}")


def overlap_mask_torch(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """`(B, K, K)` bool: row i suppresses column j iff j > i, both are
    valid and their IoU > `iou_thres` (the bits of the kernel's mask)."""
    _check(boxes, valid)
    K = boxes.shape[1]
    valid = valid.bool()
    idx = torch.arange(K, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    overlap = (box_iou(boxes, boxes) > iou_thres) & later
    return overlap & valid[:, :, None] & valid[:, None, :]


def greedy_nms_keep_torch(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Plain PyTorch version of K2: Jacobi iterations of the greedy
    recursion, exact at convergence (at most K rounds)."""
    overlap = overlap_mask_torch(boxes, valid, iou_thres)
    K = boxes.shape[1]
    valid = valid.bool()
    keep = valid & ~overlap.any(dim=1)
    for _ in range(K):
        new = valid & ~(overlap & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def greedy_nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """K2: greedy keep mask of score-sorted boxes, `K <= MAX_K`.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if boxes.device.type == "cpu":
        return greedy_nms_keep_torch(boxes, valid, iou_thres)
    _build.require_cuda(boxes, "boxes", (torch.float32,), 3)
    _build.require_cuda(valid, "valid", (torch.bool,), 2)
    _check(boxes, valid)
    B, K, _ = boxes.shape
    if K > MAX_K:
        raise ValueError(f"K={K} exceeds the dense keep's cap {MAX_K}")
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    mask, arrivals = _scratch_for(boxes, B, K)
    code = _build.library().yp_greedy_nms(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(),
        arrivals.data_ptr(), B, K, float(iou_thres), _build.stream_ptr(boxes),
    )
    _build.check(code, "greedy_nms_keep")
    _build.launch_counts["greedy_nms_keep"] += 1
    return keep
