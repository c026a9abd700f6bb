"""K2: exact greedy box-NMS keep mask (CUDA kernel `csrc/box_nms.cu`).

Counterpart of `pallas_greedy_nms` in `yolopoint_tpu/ops/pallas_box_nms.py`
(the Pallas kernel `_kernel`). Input: score-sorted, class-offset xyxy boxes
`(B, K, 4)` f32 and a validity mask `(B, K)`; output: the `(B, K)` bool
greedy keep mask. A box is suppressed iff an earlier KEPT box overlaps it
with IoU > `iou_thres` (IoU of `box_iou`, eps 1e-7).

`greedy_nms_keep_torch` is the plain PyTorch version, the Jacobi fixpoint of
`_greedy_nms_keep` in `yolopoint_tpu/ops/nms.py`: the CPU path and the
kernel's reference on the card.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.boxes import box_iou

MAX_K = 2048  # the dense keep's candidate cap (`_DENSE_NMS_MAX` in the JAX package)


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid must be {tuple(boxes.shape[:2])}, got {tuple(valid.shape)}")


def greedy_nms_keep_torch(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Plain PyTorch version of K2: Jacobi iterations of the greedy
    recursion, exact at convergence (at most K rounds)."""
    _check(boxes, valid)
    K = boxes.shape[1]
    valid = valid.bool()
    idx = torch.arange(K, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    overlap = (box_iou(boxes, boxes) > iou_thres) & later
    overlap &= valid[:, :, None] & valid[:, None, :]
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
    scratch = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32, device=boxes.device)
    code = _build.library().yp_greedy_nms(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
        B, K, float(iou_thres), _build.stream_ptr(boxes),
    )
    _build.check(code, "greedy_nms_keep")
    _build.launch_counts["greedy_nms_keep"] += 1
    return keep
