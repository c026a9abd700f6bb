"""Training losses: keypoint detector, YOLOv5 objects, descriptors."""

from yolopoint_tpu_torch.losses.descriptor import (
    descriptor_loss_dense,
    descriptor_loss_sparse,
    draw_descriptor_samples,
    infonce_loss,
)
from yolopoint_tpu_torch.losses.detector import detector_loss, detector_loss_ce
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig, object_loss

__all__ = [
    "ObjectLossConfig", "descriptor_loss_dense", "descriptor_loss_sparse", "detector_loss", "detector_loss_ce",
    "draw_descriptor_samples", "infonce_loss", "object_loss",
]
