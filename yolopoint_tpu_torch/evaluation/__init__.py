"""Validation metrics, host-side numpy: keypoint repeatability and
precision/recall, homography correctness from descriptor matches, and the
YOLO mAP stack. Copies of `yolopoint_tpu/evaluation/` (the port imports
nothing of the JAX package); the forward passes and the decode run on the
device, only the per-image metric math is here. `hpatches_runner` runs the
HPatches protocol through the port's pipeline."""

from yolopoint_tpu_torch.evaluation.descriptor_eval import compute_homography_correctness
from yolopoint_tpu_torch.evaluation.detector_eval import (
    batch_precision_recall,
    compute_repeatability,
    warp_keypoints_np,
)
from yolopoint_tpu_torch.evaluation.yolo_eval import (
    ConfusionMatrix,
    ap_per_class,
    combined_fitness,
    compute_ap,
    fitness_yolo,
    process_batch,
)

__all__ = [
    "ConfusionMatrix", "ap_per_class", "batch_precision_recall", "combined_fitness",
    "compute_ap", "compute_homography_correctness", "compute_repeatability", "fitness_yolo",
    "process_batch", "warp_keypoints_np",
]
