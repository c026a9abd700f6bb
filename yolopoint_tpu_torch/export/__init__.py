"""Pseudo-label export by homographic adaptation (on the GPU the warps K4 and
the keypoint NMS K1; off the card the warps on the host), and the serving
artifact (`aot`, `aot_cli`: a `torch.export` program of the pipeline)."""

from yolopoint_tpu_torch.export.homography_adaptation import (
    aggregate_heatmap,
    aggregate_heatmap_host,
    draw_homographies,
    export_pseudo_labels,
    homography_adaptation_batch,
    homography_adaptation_host,
    host_homographies,
    image_generator,
)

__all__ = ["aggregate_heatmap", "aggregate_heatmap_host", "draw_homographies",
           "export_pseudo_labels", "homography_adaptation_batch", "homography_adaptation_host",
           "host_homographies", "image_generator"]
