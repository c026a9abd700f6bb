"""Fixed-shape box NMS: decode, candidate top-k, exact greedy suppression.

Counterpart of `yolopoint_tpu/ops/nms.py`:
- `batched_box_nms` on decoded `(B, N, 5+nc)` predictions, single- or
  multi-label (one candidate per box and class over the gate);
- `fused_detect_nms`, the serving path from the raw Detect levels: one
  elementwise pass decodes every anchor into xyxy boxes, its class and its
  final confidence `obj * sigmoid(max cls logit)`, gated at `conf_thres` on
  both objectness and confidence;
- the shared tail `_select_detections`: an exact top-k (ties lowest index
  first) fixes the priority order of the `max_nms` best candidates; up to
  `_DENSE_NMS_MAX` of them the greedy keep mask of K2 (`cuda_box_nms`) runs
  over all at once, beyond it the exact tiled scan `_chunked_greedy_select`
  runs K2 on each 1024-candidate tile; `merge=True` replaces each kept box
  by the score-weighted mean of the candidates overlapping it
  (`_merge_weighted`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from yolopoint_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolopoint_tpu_torch.ops.cuda_box_nms import MAX_K, greedy_nms_keep
from yolopoint_tpu_torch.ops.topk import exact_top_k

MAX_WH = 7680.0  # class-offset magnitude
_DENSE_NMS_MAX = MAX_K  # candidate counts up to this run the dense keep


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[b, idx[b, i]]` for `x (B, K, ...)` and `idx (B, M)`."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _chunked_greedy_select(
    boxes_off: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_thres: float,
    max_det: int,
    tile: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy NMS over score-sorted `(B, K)` candidates of any K,
    without the (K, K) IoU matrix.

    A scan over score-ordered tiles of `tile` candidates carries a buffer of
    the `max_det` best survivors so far. Each tile is pre-suppressed against
    the buffer, then resolved within itself by K2; its survivors merge into
    the buffer by a stable top-k on score. While the buffer is not full no
    survivor has been dropped, so this is serial greedy; once it is full the
    output is already fixed, since no later candidate outranks a buffered one.

    Returns `(sel_idx (B, max_det) int64 indices into the candidates,
    sel_valid (B, max_det) bool)`, in descending score order.
    """
    B, K = scores.shape
    pad = (-K) % tile
    if pad:
        boxes_off = torch.nn.functional.pad(boxes_off, (0, 0, 0, pad))
        scores = torch.nn.functional.pad(scores, (0, pad), value=-1.0)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    dev = scores.device
    idx = torch.arange(K + pad, device=dev).expand(B, -1)
    b_boxes = torch.zeros((B, max_det, 4), dtype=boxes_off.dtype, device=dev)
    b_scores = torch.full((B, max_det), -1.0, dtype=scores.dtype, device=dev)
    b_idx = torch.zeros((B, max_det), dtype=torch.int64, device=dev)
    b_valid = torch.zeros((B, max_det), dtype=torch.bool, device=dev)
    for t0 in range(0, K + pad, tile):
        t_boxes = boxes_off[:, t0:t0 + tile].contiguous()
        t_scores, t_valid, t_idx = (x[:, t0:t0 + tile] for x in (scores, valid, idx))
        pre_sup = ((box_iou(t_boxes, b_boxes) > iou_thres) & b_valid[:, None, :]).any(dim=2)
        keep_t = greedy_nms_keep(t_boxes, (t_valid & ~pre_sup).contiguous(), iou_thres)
        all_scores = torch.cat([torch.where(b_valid, b_scores, -1.0),
                                torch.where(keep_t, t_scores, -1.0)], dim=1)
        top_s, sel = exact_top_k(all_scores, max_det)
        b_boxes = _gather_rows(torch.cat([b_boxes, t_boxes], dim=1), sel)
        b_idx = _gather_rows(torch.cat([b_idx, t_idx], dim=1), sel)
        b_scores, b_valid = top_s, top_s > -1.0
    return b_idx, b_valid


def _merge_weighted(
    out_off: torch.Tensor,
    out_boxes: torch.Tensor,
    out_valid: torch.Tensor,
    all_off: torch.Tensor,
    all_boxes: torch.Tensor,
    all_scores: torch.Tensor,
    all_valid: torch.Tensor,
    iou_thres: float,
    tile: int = 4096,
) -> torch.Tensor:
    """Merge-NMS: each kept box becomes the score-weighted mean of every
    candidate (itself and suppressed ones included) whose class-offset box
    overlaps its own above `iou_thres`, averaged over the raw boxes. For K
    beyond `tile` the weights are summed tile by tile, so no `(D, K)` matrix
    of the whole candidate set is formed."""
    w_scores = torch.where(all_valid, all_scores, 0.0)
    B, D, _ = out_off.shape
    num = torch.zeros_like(out_off)
    den = torch.zeros((B, D, 1), dtype=out_off.dtype, device=out_off.device)
    for t0 in range(0, all_off.shape[1], tile):
        sl = slice(t0, t0 + tile)
        iou = box_iou(out_off, all_off[:, sl])
        w = torch.where(iou > iou_thres, w_scores[:, None, sl], 0.0)
        num = num + w @ all_boxes[:, sl]
        den = den + w.sum(-1, keepdim=True)
    merged = num / den.clamp(min=1e-9)
    return torch.where(out_valid[..., None], merged, out_boxes)


def _select_detections(
    top_boxes: torch.Tensor,
    top_scores: torch.Tensor,
    top_classes: torch.Tensor,
    iou_thres: float,
    max_det: int,
    agnostic: bool,
    merge: bool = False,
) -> dict[str, torch.Tensor]:
    """Greedy suppression and selection over score-sorted `(B, K, ...)`
    candidates: the dense keep up to `_DENSE_NMS_MAX`, the tiled scan
    beyond; optional merge-NMS."""
    B, K = top_scores.shape
    top_valid = top_scores > 0.0
    boxes_off = top_boxes if agnostic else top_boxes + top_classes.float()[..., None] * MAX_WH
    if K <= _DENSE_NMS_MAX:
        keep = greedy_nms_keep(boxes_off.contiguous(), top_valid.contiguous(), iou_thres)
        kept_scores = torch.where(keep, top_scores, -1.0)
        k_out = min(max_det, K)
        out_scores, out_idx = exact_top_k(kept_scores, k_out)
        if max_det > k_out:
            pad = max_det - k_out
            out_scores = torch.nn.functional.pad(out_scores, (0, pad), value=-1.0)
            out_idx = torch.nn.functional.pad(out_idx, (0, pad))
    else:
        out_idx, sel_valid = _chunked_greedy_select(boxes_off, top_scores, top_valid,
                                                    iou_thres, max_det)
        out_idx = out_idx.clamp(max=K - 1)  # pad-tile indices sit in invalid slots
        out_scores = torch.where(sel_valid, torch.gather(top_scores, 1, out_idx), -1.0)
    out_boxes = _gather_rows(top_boxes, out_idx)
    out_classes = torch.gather(top_classes, 1, out_idx).int()
    out_valid = out_scores > 0.0
    if merge:
        out_off = out_boxes if agnostic else out_boxes + out_classes.float()[..., None] * MAX_WH
        out_boxes = _merge_weighted(out_off, out_boxes, out_valid, boxes_off, top_boxes,
                                    top_scores, top_valid, iou_thres)
    return {
        "boxes": out_boxes,
        "scores": out_scores.clamp(min=0.0),
        "classes": out_classes,
        "valid": out_valid,
    }


def batched_box_nms(
    prediction: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 1024,
    agnostic: bool = False,
    multi_label: bool = False,
    merge: bool = False,
) -> dict[str, torch.Tensor]:
    """Batched class-aware NMS on decoded predictions `(B, N, 5+nc)`
    `[cx, cy, w, h, obj, cls...]` (`decode_levels` of the Detect head).

    `multi_label` makes one candidate per (box, class) whose `obj * cls`
    passes the gate (with objectness over the gate too) instead of the
    argmax class only. Caps `max_nms` beyond `_DENSE_NMS_MAX` run the exact
    tiled scan, so the val protocol's 30000 candidates at conf 0.001 need no
    (30000, 30000) IoU matrix.

    Returns `boxes (B, max_det, 4)` xyxy, `scores (B, max_det)`, `classes
    (B, max_det)` int32, `valid (B, max_det)` bool and `n_candidates (B,)`
    int32, the count that passed the gate (above `max_nms`: truncated).
    """
    nc = prediction.shape[-1] - 5
    x = prediction.float()
    obj = x[..., 4]
    cls_conf = x[..., 5:] * obj[..., None]
    box = xywh2xyxy(x[..., :4])
    if multi_label and nc > 1:
        scores = torch.where(obj[..., None] > conf_thres, cls_conf, 0.0).flatten(1)
        cand = scores > conf_thres
        per_box = nc  # candidate c is box c // nc, class c % nc
    else:
        scores, _ = cls_conf.max(dim=-1)
        cls_arg = cls_conf.argmax(dim=-1)
        cand = (obj > conf_thres) & (scores > conf_thres)
        per_box = 1
    gated = torch.where(cand, scores, -1.0)
    top_scores, top_idx = exact_top_k(gated, min(max_nms, gated.shape[1]))
    top_boxes = _gather_rows(box, top_idx // per_box)
    top_classes = top_idx % nc if per_box > 1 else torch.gather(cls_arg, 1, top_idx)
    out = _select_detections(top_boxes, top_scores, top_classes, iou_thres, max_det,
                             agnostic, merge)
    out["n_candidates"] = (gated > 0.0).sum(dim=1).int()
    return out


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
    """Decode + final-confidence top-k + greedy NMS, single-label: the same
    result as `batched_box_nms` on the decoded predictions.

    Args:
      raw_levels: nl raw Detect tensors `(B, na, ny, nx, 5+nc)`, any dtype.
      anchors_ps: `(nl, na, 2)` per-stride anchors (`Detect.anchors_per_stride()`).

    Returns the dict of `batched_box_nms`.
    """
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

    sc, idx = exact_top_k(gated, min(max_nms, gated.shape[1]))
    g = _gather_rows(planes, idx)  # (B, K, 5)
    out = _select_detections(g[..., 0:4], sc, g[..., 4].int(), iou_thres, max_det,
                             agnostic, merge)
    out["n_candidates"] = (gated > 0.0).sum(dim=1).int()
    return out
