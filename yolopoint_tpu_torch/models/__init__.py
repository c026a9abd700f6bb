"""YOLOPoint in PyTorch (NCHW inside), with the weight bridge from the JAX
package's variable trees."""

from yolopoint_tpu_torch.models.blocks import (
    C3,
    SPPF,
    Bottleneck,
    ConvBnAct,
    autopad,
    make_divisible,
    upsample2x,
)
from yolopoint_tpu_torch.models.convert import (
    fold_batch_norm,
    is_folded,
    jax_variables_to_state_dict,
    load_weights,
    reference_to_state_dict,
    state_dict_to_reference,
)
from yolopoint_tpu_torch.models.detect import ANCHORS_DEFAULT, Detect, check_anchor_order
from yolopoint_tpu_torch.models.yolopoint import VERSION_MULTIPLIERS, YOLOPoint, build_model

__all__ = [
    "ANCHORS_DEFAULT", "C3", "SPPF", "VERSION_MULTIPLIERS", "Bottleneck",
    "ConvBnAct", "Detect", "YOLOPoint", "autopad", "build_model",
    "check_anchor_order", "fold_batch_norm", "is_folded", "jax_variables_to_state_dict",
    "load_weights", "make_divisible", "reference_to_state_dict", "state_dict_to_reference",
    "upsample2x",
]
