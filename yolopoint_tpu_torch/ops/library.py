"""The serving path's kernels as `torch.library` custom ops.

`yolopoint::nms_tile_keys` (K1), `yolopoint::nms_suppressed_map` (K6),
`yolopoint::greedy_nms_keep` (K2) and `yolopoint::sample_descriptors` (K3)
wrap the kernel wrappers of `cuda_nms`, `cuda_box_nms` and `cuda_gather`:
the plain PyTorch version for a CPU tensor, the kernel for a CUDA tensor
(which counts its launch in `_build.launch_counts`), an error otherwise.
Each has a fake implementation that gives its output's shape and dtype, so
`torch.export` traces through it as one node of the graph
(`export/aot.py`), and the exported program calls the kernel when it runs.
`ops/keypoints.py`, `ops/nms.py` and `ops/sampling.py` call these ops, so
eager serving and an exported program go through one code path. Importing
this module registers the ops (a loader of an exported program must import
it first).
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import cuda_box_nms, cuda_gather, cuda_nms

NAMESPACE = "yolopoint"
OPS = ("nms_tile_keys", "nms_suppressed_map", "greedy_nms_keep", "sample_descriptors")


@torch.library.custom_op(f"{NAMESPACE}::nms_tile_keys", mutates_args=())
def nms_tile_keys(heatmap: torch.Tensor, conf_thresh: float, radius: int, iterations: int,
                  border: int, tile: int) -> torch.Tensor:
    """K1: `(B, H, W)` heatmap -> `(B, H/t * W/t)` int32 tile keys."""
    return cuda_nms.nms_tile_keys(heatmap, conf_thresh, radius, iterations, border, tile)


@nms_tile_keys.register_fake
def _(heatmap, conf_thresh, radius, iterations, border, tile):
    B, H, W = heatmap.shape
    return heatmap.new_empty((B, (H // tile) * (W // tile)), dtype=torch.int32)


@torch.library.custom_op(f"{NAMESPACE}::nms_suppressed_map", mutates_args=())
def nms_suppressed_map(heatmap: torch.Tensor, conf_thresh: float, radius: int,
                       iterations: int, border: int) -> torch.Tensor:
    """K6: `(B, H, W)` heatmap -> the f32 suppressed map."""
    return cuda_nms.nms_suppressed_map(heatmap, conf_thresh, radius, iterations, border)


@nms_suppressed_map.register_fake
def _(heatmap, conf_thresh, radius, iterations, border):
    return heatmap.new_empty(heatmap.shape, dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::greedy_nms_keep", mutates_args=())
def greedy_nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """K2: the `(B, K)` greedy keep mask of score-sorted boxes."""
    return cuda_box_nms.greedy_nms_keep(boxes, valid, iou_thres)


@greedy_nms_keep.register_fake
def _(boxes, valid, iou_thres):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


@torch.library.custom_op(f"{NAMESPACE}::sample_descriptors", mutates_args=())
def sample_descriptors(desc: torch.Tensor, points: torch.Tensor, cell_size: int) -> torch.Tensor:
    """K3: `(B, Hc, Wc, D)` map, `(B, N, 2)` points -> `(B, N, D)` f32."""
    return cuda_gather.sample_descriptors_cuda(desc, points, cell_size)


@sample_descriptors.register_fake
def _(desc, points, cell_size):
    return desc.new_empty((desc.shape[0], points.shape[1], desc.shape[3]), dtype=torch.float32)
