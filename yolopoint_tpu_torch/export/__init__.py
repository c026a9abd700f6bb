"""Pseudo-label export by homographic adaptation (the warps K4 and the
keypoint NMS K1 on the GPU)."""

from yolopoint_tpu_torch.export.homography_adaptation import (
    aggregate_heatmap,
    draw_homographies,
    export_pseudo_labels,
    homography_adaptation_batch,
    image_generator,
)

__all__ = ["aggregate_heatmap", "draw_homographies", "export_pseudo_labels",
           "homography_adaptation_batch", "image_generator"]
