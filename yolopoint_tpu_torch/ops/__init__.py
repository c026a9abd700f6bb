"""Ops of the serving path (heatmap, keypoint NMS K1/K6, box NMS K2,
descriptor sampling K3), of validation (decoded-prediction box NMS with the
tiled scan and merge-NMS), of training (`geometry`, `homography`, the warp
K4/K5 in `cuda_warp`), mutual nearest-neighbour matching, and OpenCV's
image resize in torch (`resize`). Each kernel module holds the CUDA wrapper
and its plain PyTorch version; `library` registers K1/K6, K2 and K3 as
`torch.library` ops, which the serving path calls."""

from yolopoint_tpu_torch.ops.boxes import box_iou, scale_boxes, xywh2xyxy, xyxy2xywh
from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_reduce
from yolopoint_tpu_torch.ops.heatmap import cells_to_heatmap, depth_to_space
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints, simple_nms
from yolopoint_tpu_torch.ops.matching import mutual_nearest_neighbor
from yolopoint_tpu_torch.ops.nms import batched_box_nms, fused_detect_nms
from yolopoint_tpu_torch.ops.sampling import sample_descriptors
from yolopoint_tpu_torch.ops.topk import exact_top_k

__all__ = [
    "batched_box_nms", "box_iou", "cells_to_heatmap", "depth_to_space", "exact_top_k",
    "extract_keypoints", "fused_detect_nms", "mutual_nearest_neighbor", "nms_tile_reduce", "sample_descriptors",
    "scale_boxes", "simple_nms", "xywh2xyxy", "xyxy2xywh",
]
