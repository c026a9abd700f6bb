"""Box format conversion, clipping, pairwise IoU and CIoU.

Counterpart of `yolopoint_tpu/ops/boxes.py` (`xyxy2xywh`, `xywh2xyxy`,
`xywhn2xyxy`, `xyxy2xywhn`, `clip_boxes`, `scale_boxes`, `box_iou`,
`bbox_iou`).
"""

from __future__ import annotations

import math

import torch


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + eps)


def xywhn2xyxy(boxes: torch.Tensor, w: float, h: float, padw: float = 0.0,
               padh: float = 0.0) -> torch.Tensor:
    """Normalized [cx, cy, w, h] -> pixel [x1, y1, x2, y2], optionally shifted."""
    cx, cy, bw, bh = boxes.unbind(-1)
    return torch.stack([w * (cx - bw / 2) + padw, h * (cy - bh / 2) + padh,
                        w * (cx + bw / 2) + padw, h * (cy + bh / 2) + padh], dim=-1)


def clip_boxes(boxes: torch.Tensor, shape_hw) -> torch.Tensor:
    """Clip xyxy boxes to `(h, w)`."""
    h, w = shape_hw[0], shape_hw[1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w), y2.clamp(0, h)], dim=-1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy boxes from the letterboxed `img1_shape` frame back to
    `img0_shape` (both `(h, w)`), then clip to it."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    shift = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=boxes.dtype, device=boxes.device)
    return clip_boxes((boxes - shift) / gain, img0_shape)


def xyxy2xywhn(boxes: torch.Tensor, w: float, h: float, clip: bool = False,
               eps: float = 0.0) -> torch.Tensor:
    """Pixel [x1, y1, x2, y2] -> normalized [cx, cy, w, h]."""
    if clip:
        boxes = clip_boxes(boxes, (h - eps, w - eps))
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([((x1 + x2) / 2) / w, ((y1 + y2) / 2) / h,
                        (x2 - x1) / w, (y2 - y1) / h], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU of aligned `(..., 4)` boxes; the
    CIoU `alpha` is a constant for the gradient, as in YOLOv5."""
    if xywh:
        b1, b2 = xywh2xyxy(box1), xywh2xyxy(box2)
        w1, h1, w2, h2 = box1[..., 2], box1[..., 3], box2[..., 2], box2[..., 3]
    else:
        b1, b2 = box1, box2
        w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
        w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    b1_x1, b1_y1, b1_x2, b1_y2 = b1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = b2.unbind(-1)
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (CIoU or DIoU or GIoU):
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if CIoU or DIoU:
        c2 = cw**2 + ch**2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if CIoU:
            v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
            alpha = (v / (v - iou + (1 + eps))).detach()
            return iou - (rho2 / c2 + v * alpha)
        return iou - rho2 / c2
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area
