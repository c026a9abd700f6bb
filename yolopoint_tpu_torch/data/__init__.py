"""On-device augmentation of training batches (photometric ops and the
homographic warped pair), and image reading and the HPatches sequences."""

from yolopoint_tpu_torch.data.augmentation import (
    AugmentedView,
    build_training_views,
    draw_training_views,
    homographic_augment,
)
from yolopoint_tpu_torch.data.datasets import HPatches
from yolopoint_tpu_torch.data.photometric import draw_photometric, photometric_augment

__all__ = [
    "AugmentedView", "HPatches", "build_training_views", "draw_photometric", "draw_training_views",
    "homographic_augment", "photometric_augment",
]
