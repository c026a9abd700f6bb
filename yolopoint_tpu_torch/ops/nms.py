"""Fixed-shape box decode + NMS from the raw Detect levels.

Counterpart of `fused_detect_nms` and the dense branch of
`_select_detections` in `yolopoint_tpu/ops/nms.py`: one elementwise pass
decodes every anchor into xyxy boxes, its class and its final confidence
`obj * sigmoid(max cls logit)` (gated at `conf_thres` on both objectness and
confidence), an exact top-k keeps the `max_nms` best candidates, and the
greedy keep mask of K2 (`cuda_box_nms`) selects up to `max_det` detections.
"""

from __future__ import annotations

from typing import Sequence

import torch

from yolopoint_tpu_torch.ops.cuda_box_nms import MAX_K, greedy_nms_keep
from yolopoint_tpu_torch.ops.topk import exact_top_k

MAX_WH = 7680.0  # class-offset magnitude


def _select_detections(
    top_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    top_classes: torch.Tensor,
    iou_thres: float,
    max_det: int,
    agnostic: bool,
) -> dict[str, torch.Tensor]:
    """Greedy suppression + selection over score-sorted `(B, K, ...)`
    candidates (the dense branch, K <= `MAX_K`)."""
    B, K = top_scores.shape
    if K > MAX_K:
        raise NotImplementedError(
            f"{K} NMS candidates: the tiled scan for K > {MAX_K} is not ported yet"
        )
    top_valid = top_scores > 0.0
    boxes_off = top_boxes if agnostic else top_boxes + top_classes.float()[..., None] * MAX_WH
    keep = greedy_nms_keep(boxes_off.contiguous(), top_valid, iou_thres)
    kept_scores = torch.where(keep, top_scores, -1.0)
    k_out = min(max_det, K)
    out_scores, out_idx = exact_top_k(kept_scores, k_out)
    if max_det > k_out:
        pad = max_det - k_out
        out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
        out_idx = torch.nn.functional.pad(out_idx, (0, pad))
    out_boxes = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    out_classes = torch.gather(top_classes, 1, out_idx).int()
    return {
        "boxes": out_boxes,
        "scores": out_scores.clamp(min=0.0),
        "classes": out_classes,
        "valid": out_scores > 0.0,
    }


def fused_detect_nms(
    raw_levels: Sequence[torch.Tensor],
    anchors_ps,
    strides: Sequence[int] = (8, 16, 32),
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 1024,
    agnostic: bool = False,
    merge: bool = False,
) -> dict[str, torch.Tensor]:
    """Decode + final-confidence top-k + greedy NMS.

    Args:
      raw_levels: nl raw Detect tensors `(B, na, ny, nx, 5+nc)`, any dtype.
      anchors_ps: `(nl, na, 2)` per-stride anchors (`Detect.anchors_per_stride()`).

    Returns:
      dict with `boxes (B, max_det, 4)` xyxy, `scores (B, max_det)`,
      `classes (B, max_det)` int32, `valid (B, max_det)` bool and
      `n_candidates (B,)` int32, the count that passed the confidence gate.
    """
    if merge:
        raise NotImplementedError("merge-NMS (weighted box fusion) is not ported yet")
    dev = raw_levels[0].device
    B = raw_levels[0].shape[0]
    anchors_ps = torch.as_tensor(anchors_ps, dtype=torch.float32, device=dev)

    planes_l, gated_l = [], []
    for li, r in enumerate(raw_levels):
        _, na, ny, nx, _ = r.shape
        s = float(strides[li])
        rf = r.float()
        obj = torch.sigmoid(rf[..., 4])
        cls_max, cls_arg = rf[..., 5:].max(dim=-1)
        score = obj * torch.sigmoid(cls_max)
        gated = torch.where((obj > conf_thres) & (score > conf_thres), score, -1.0)
        gy = torch.arange(ny, dtype=torch.float32, device=dev)[:, None]
        gx = torch.arange(nx, dtype=torch.float32, device=dev)[None, :]
        sig = torch.sigmoid(rf[..., 0:4])
        cx = (sig[..., 0] * 2.0 - 0.5 + gx) * s
        cy = (sig[..., 1] * 2.0 - 0.5 + gy) * s
        anc = anchors_ps[li] * s  # (na, 2)
        w_half = (sig[..., 2] * 2.0) ** 2 * anc[None, :, None, None, 0] * 0.5
        h_half = (sig[..., 3] * 2.0) ** 2 * anc[None, :, None, None, 1] * 0.5
        planes = torch.stack(
            [cx - w_half, cy - h_half, cx + w_half, cy + h_half, cls_arg.float()], dim=-1
        )  # (B, na, ny, nx, 5)
        planes_l.append(planes.reshape(B, -1, 5))
        gated_l.append(gated.reshape(B, -1))
    planes = torch.cat(planes_l, dim=1)  # (B, N, 5)
    gated = torch.cat(gated_l, dim=1)  # (B, N)

    k = min(max_nms, gated.shape[1])
    sc, idx = exact_top_k(gated, k)
    g = torch.gather(planes, 1, idx[..., None].expand(-1, -1, 5))  # (B, K, 5)
    out = _select_detections(
        g[..., 0:4], sc, g[..., 4].int(), iou_thres, max_det, agnostic
    )
    out["n_candidates"] = (gated > 0.0).sum(dim=1).int()
    return out
