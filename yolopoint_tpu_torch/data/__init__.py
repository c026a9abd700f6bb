"""On-device augmentation of training batches (photometric ops, the
homographic warped pair, crops and mosaics), image reading (PNG, JPEG, BMP,
PPM) and writing (PNG, JPEG), OpenCV's drawing in numpy (`raster`), the
datasets' resize, the image-file and synthetic datasets, the loaders, the
HPatches sequences and the dataset sanity checks."""

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
