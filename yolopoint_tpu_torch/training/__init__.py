"""Training on one GPU: state and optimizer, the train and val steps, TrainAgent."""

from yolopoint_tpu_torch.training.agent import TrainAgent
from yolopoint_tpu_torch.training.state import TrainState, create_train_state, make_optimizer
from yolopoint_tpu_torch.training.step import (
    LossWeights,
    draw_step,
    make_train_step,
    make_val_step,
    rescale_yolo_gains,
)

__all__ = [
    "LossWeights", "TrainAgent", "TrainState", "create_train_state", "draw_step",
    "make_optimizer", "make_train_step", "make_val_step", "rescale_yolo_gains",
]
