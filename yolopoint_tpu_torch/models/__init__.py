"""The YOLOPoint model family in PyTorch (NCHW inside), with the weight bridge
from the JAX package's variable trees."""

from yolopoint_tpu_torch.models.blocks import (
    C3,
    C3MP,
    C3SPP,
    C3TR,
    SPP,
    SPPF,
    Bottleneck,
    BottleneckCSP,
    BottleneckV8,
    C2f,
    C3Ghost,
    ConvBnAct,
    DWConv,
    Focus,
    GhostBottleneck,
    GhostConv,
    TransformerBlock,
    TransformerLayer,
    autopad,
    contract,
    expand,
    make_divisible,
    max_pool_2x2,
    upsample2x,
)
from yolopoint_tpu_torch.models.convert import (
    fold_batch_norm,
    is_folded,
    jax_variables_to_state_dict,
    load_weights,
    reference_to_state_dict,
    state_dict_to_reference,
    transplant_yolo_backbone,
)
from yolopoint_tpu_torch.models.detect import ANCHORS_DEFAULT, Detect, check_anchor_order
from yolopoint_tpu_torch.models.yolopoint import (
    MODEL_REGISTRY,
    VERSION_MULTIPLIERS,
    SuperPointNet,
    YOLOPoint,
    YOLOPointDet,
    YOLOPointv52,
    YOLOv8Point,
    build_model,
)

__all__ = [
    "ANCHORS_DEFAULT", "C2f", "C3", "C3Ghost", "C3MP", "C3SPP", "C3TR", "MODEL_REGISTRY",
    "SPP", "SPPF", "VERSION_MULTIPLIERS", "Bottleneck",
    "BottleneckCSP", "BottleneckV8", "ConvBnAct", "DWConv", "Detect", "Focus",
    "GhostBottleneck", "GhostConv", "SuperPointNet", "TransformerBlock", "TransformerLayer",
    "YOLOPoint", "YOLOPointDet", "YOLOPointv52", "YOLOv8Point", "autopad", "build_model",
    "check_anchor_order", "contract", "expand", "fold_batch_norm", "is_folded",
    "jax_variables_to_state_dict", "load_weights", "make_divisible", "max_pool_2x2",
    "reference_to_state_dict", "state_dict_to_reference", "transplant_yolo_backbone",
    "upsample2x",
]
