"""Train state, optimizer, learning-rate schedule and layer freezing.

Counterpart of `yolopoint_tpu/training/state.py`, whose optimizer is the optax
chain

    clip by global norm -> Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
    -> decoupled weight decay on weight tensors (rank >= 2) -> * -lr(count)

wrapped, as `optax.MultiSteps`, in gradient accumulation. Here the chain is
`clip_grad_norm_` and `torch.optim.AdamW` with two parameter groups (decay on
the rank >= 2 tensors only) and the learning rate set from the schedule before
each update; the same function to f32 rounding. The micro-step gradients are
averaged (`acc + (g - acc) / (n + 1)`) and the chain runs once every `accum`
calls; the other calls leave the parameters as they are. A trainable mask
freezes parameters (left out of AdamW: zero update; the clip sees the
trainable ones only). Parameters are updated in place.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

F32 = np.float32


def parse_str_slice(spec: str) -> list[int]:
    """`'0-62, 100'` -> [0..62, 100]."""
    out: list[int] = []
    for part in spec.replace(" ", "").split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


# The reference freezes by torch `named_parameters()` index; the JAX package
# enumerates its (alphabetical) Flax tree in that order: top-level modules in
# the reference's declaration order, children natural-sorted with `conv`
# before `bn`, leaves weight before bias. The same walk over this package's
# names gives the same indices. The module order of every family is the JAX
# package's table (`yolopoint_tpu/models/yolopoint.py`).
REFERENCE_MODULE_ORDER = {
    "YOLOPoint": [
        "Conv1", "Conv2", "Bottleneck1", "Conv3", "Bottleneck2",
        "Conv4", "Bottleneck3", "Conv5", "Bottleneck4", "SPPooling",
        "Conv6", "Bottleneck5", "Conv7", "Bottleneck6", "Conv8",
        "Bottleneck7", "Conv9", "Bottleneck8", "Detect",
        "BottleneckDet", "ConvDet", "ConvDescB", "ConvDescA",
        "BottleneckDesc", "ConvDesc",
    ],
    "YOLOPointv52": [
        "Conv1", "Conv2", "Bottleneck1", "Conv3", "Bottleneck2",
        "Conv4", "Bottleneck3", "Conv5", "Bottleneck4", "SPPooling",
        "Bottleneck5", "Bottleneck6", "Conv8", "Bottleneck7", "Conv9",
        "Bottleneck8", "Detect", "BottleneckDet", "ConvDescB",
        "BottleneckDesc",
    ],
    "YOLOPointDet": [
        "Conv1", "Conv2", "Bottleneck1", "Conv3", "Bottleneck2",
        "BottleneckDet", "ConvDet", "ConvDescB", "ConvDescA",
        "BottleneckDesc", "ConvDesc",
    ],
    "SuperPointNet": [
        "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
        "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb",
    ],
    "YOLOv8Point": [
        "Conv0", "Conv1", "Bottleneck2", "Conv3", "Bottleneck4", "Conv5",
        "Bottleneck6", "Conv7", "Bottleneck8", "SPPooling9", "Bottleneck12",
        "Bottleneck15", "Conv16", "Bottleneck18", "Conv19", "Bottleneck21",
        "Detect", "Conv22", "Conv25", "BottleneckDet", "BottleneckDesc",
        "ConvDesc",
    ],
}


_LEAF_ORDER = {"weight": 0, "bias": 2}


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _child_sort_key(name: str, is_leaf: bool):
    if is_leaf:
        return (0, _LEAF_ORDER.get(name, 9), _natural_key(name))
    if name == "conv":
        return (1, 0, [])
    if name == "bn":
        return (1, 1, [])
    return (2, 0, _natural_key(name))


def iter_params_reference_order(names: Sequence[str],
                                module_order: Optional[Sequence[str]] = None) -> list[str]:
    """Dotted parameter names in the reference's `named_parameters()` order."""
    tree: dict = {}
    for name in names:
        node = tree
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = name

    def walk(node):
        if isinstance(node, str):
            yield node
            return
        for k in sorted(node, key=lambda k: _child_sort_key(k, isinstance(node[k], str))):
            yield from walk(node[k])

    top = list(tree)
    if module_order:
        known = [m for m in module_order if m in tree]
        top = known + sorted((m for m in top if m not in set(module_order)), key=_natural_key)
    else:
        top = sorted(top, key=_natural_key)
    return [leaf for m in top for leaf in walk(tree[m])]


def freeze_mask_from_indices(names: Sequence[str], frozen_indices: Sequence[int]) -> dict:
    """`{name: trainable}` with parameters enumerated in `names` order."""
    frozen = set(frozen_indices)
    return {n: i not in frozen for i, n in enumerate(names)}


def freeze_mask_from_spec(names: Sequence[str], spec: str,
                          module_order: Optional[Sequence[str]] = None) -> dict:
    """`freeze_layers: '0-62'` -> `{name: trainable}`, indices counted in the
    reference order (`iter_params_reference_order`)."""
    return freeze_mask_from_indices(iter_params_reference_order(names, module_order),
                                    parse_str_slice(spec))


def linear_lr_schedule(base_lr: float, lrf: float, total_epochs: int, steps_per_epoch: int):
    """`lr(count) = base (1 - e / E (1 - lrf))`, `e` the epoch of optimizer
    update `count`, stepped per epoch; f32 as in the JAX package."""

    def schedule(count: int) -> float:
        epoch = min(count // max(steps_per_epoch, 1), total_epochs)
        frac = F32(epoch) / F32(max(total_epochs, 1))
        return float(F32(base_lr) * (F32(1.0) - frac * F32(1.0 - lrf)))

    return schedule


class Optimizer:
    """The JAX package's `make_optimizer` chain over named parameters (see
    the module docstring). `update(grads)` takes one micro-step's gradients
    and returns True when it applied an update."""

    def __init__(
        self,
        named_params: Mapping[str, torch.Tensor],
        learning_rate: float = 1e-3,
        lrf: float = 0.1,
        total_epochs: int = 100,
        steps_per_epoch: int = 1000,
        grad_clip: Optional[float] = None,
        accumulate_steps: int = 1,
        trainable_mask: Optional[Mapping[str, bool]] = None,
        betas: tuple[float, float] = (0.9, 0.999),
        weight_decay: float = 0.0,
        eps: float = 1e-8,
    ):
        self.names = list(named_params)
        self.params = [named_params[n] for n in self.names]
        mask = trainable_mask or {}
        self.trainable = [bool(mask.get(n, True)) for n in self.names]
        self.schedule = linear_lr_schedule(learning_rate, lrf, total_epochs, steps_per_epoch)
        self.grad_clip = grad_clip
        self.accum = max(int(accumulate_steps), 1)
        self.mini_step = 0
        self.count = 0  # applied updates (the chain's count)
        self.acc = [torch.zeros_like(p) for p in self.params]
        train = [p for p, t in zip(self.params, self.trainable) if t]
        groups = [{"params": [p for p in train if p.dim() >= 2], "weight_decay": weight_decay},
                  {"params": [p for p in train if p.dim() < 2], "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=learning_rate,
                                       betas=betas, eps=eps)

    @property
    def mu(self) -> list[torch.Tensor]:
        """Adam's first moment of each trainable parameter (zeros before the
        first update)."""
        return [self.adamw.state[p]["exp_avg"] if p in self.adamw.state else torch.zeros_like(p)
                for p, t in zip(self.params, self.trainable) if t]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        n = self.mini_step
        # Welford mean of the micro-step gradients
        torch._foreach_add_(self.acc, torch._foreach_div(torch._foreach_sub(list(grads), self.acc),
                                                         float(n + 1)))
        self.mini_step = (n + 1) % self.accum
        if n != self.accum - 1:
            return False
        train = [(p, a) for p, a, t in zip(self.params, self.acc, self.trainable) if t]
        for p, a in train:
            p.grad = a
        if self.grad_clip:
            torch.nn.utils.clip_grad_norm_([p for p, _ in train], self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        for p, _ in train:
            p.grad = None
        self.count += 1
        for a in self.acc:
            a.zero_()
        return True


def make_optimizer(model: torch.nn.Module, **kwargs) -> Optimizer:
    """`Optimizer` over `model.named_parameters()` (keyword arguments as the
    JAX package's `make_optimizer`)."""
    return Optimizer(dict(model.named_parameters()), **kwargs)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer, the
    count of finite micro-steps, and the EMA shadow of the parameters
    (`None` when EMA is off)."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    ema_params: Optional[dict] = None


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       ema: bool = False) -> TrainState:
    """A fresh state; `ema=True` starts the shadow as a copy of the parameters."""
    shadow = {n: p.detach().clone() for n, p in model.named_parameters()} if ema else None
    return TrainState(model=model, optimizer=optimizer, step=0, ema_params=shadow)


@torch.no_grad()
def shrink_perturb(params: Mapping[str, torch.Tensor], generator: torch.Generator,
                   lam: float = 0.5, sigma: float = 0.01) -> dict[str, torch.Tensor]:
    """Warm-start trick: every weight tensor (rank >= 2) becomes
    `lam * w + sigma * N(0, 1)`, the noise drawn from `generator` (on the
    tensors' device); biases and BatchNorm scales are returned as they are.
    Returns a new name -> tensor dict in the order of `params`."""
    return {n: lam * p + sigma * torch.randn(p.shape, generator=generator, device=p.device,
                                             dtype=p.dtype)
            if p.dim() >= 2 else p for n, p in params.items()}
