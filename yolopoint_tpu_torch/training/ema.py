"""Model EMA and early stopping.

Counterpart of `ema_update` and `EarlyStopping` in
`yolopoint_tpu/training/ema.py`: the EMA decay ramps as
`d * (1 - exp(-step / tau))`, `step` counting optimizer updates.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               step: int, decay: float = 0.9999, tau: float = 2000.0) -> None:
    """`e <- e d + p (1 - d)` in place, with `d` ramped by `step` (f32)."""
    f32 = np.float32
    d = f32(decay) * (f32(1.0) - np.exp(-f32(step) / f32(tau), dtype=f32))
    names = list(ema_params)
    shadow = [ema_params[n] for n in names]
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, torch._foreach_mul([params[n].detach() for n in names],
                                                   float(f32(1.0) - d)))


class EarlyStopping:
    """Stop when fitness has not improved for `patience` epochs."""

    def __init__(self, patience: int = 30):
        self.best_fitness = -math.inf
        self.best_epoch = 0
        self.patience = patience or math.inf

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience
