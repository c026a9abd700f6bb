"""Ops of the serving path (heatmap, keypoint NMS K1, box NMS K2, descriptor
sampling K3) and of training (`geometry`, `homography`, the warp K4/K5 in
`cuda_warp`). Each kernel module holds the CUDA wrapper and its plain
PyTorch version."""

from yolopoint_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolopoint_tpu_torch.ops.heatmap import cells_to_heatmap, depth_to_space
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints, simple_nms
from yolopoint_tpu_torch.ops.nms import fused_detect_nms
from yolopoint_tpu_torch.ops.sampling import sample_descriptors
from yolopoint_tpu_torch.ops.topk import exact_top_k

__all__ = [
    "box_iou", "cells_to_heatmap", "depth_to_space", "exact_top_k",
    "extract_keypoints", "fused_detect_nms", "sample_descriptors", "simple_nms",
    "xywh2xyxy",
]
