"""CSPDarknet building blocks in PyTorch (NCHW).

Counterpart of `yolopoint_tpu/models/blocks.py` for the blocks `YOLOPoint`
uses: `ConvBnAct`, `Bottleneck`, `C3`, `SPPF`, `upsample2x`. Submodule names
mirror the JAX package's (`conv`, `bn`, `cv1`, `m.0`, ...), so its variable
trees convert mechanically (`models/convert.py`). Unlike Flax modules, torch
modules take their input width `c1` at construction.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.03  # torch convention (Flax 0.97)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm in f32 with the JAX package's (Flax) semantics in training.

    `nn.BatchNorm2d` updates `running_var` with the unbiased batch variance;
    Flax uses the biased one. In training this module normalizes with the
    f32 batch statistics and updates the running statistics itself,
    `r <- (1 - m) r + m s` with `m = 0.03` and the biased variance. The input
    is taken to f32 (a bf16 conv output under autocast), and so is the output.
    `num_batches_tracked` is not counted (the momentum is fixed). In eval
    mode it is `nn.BatchNorm2d`.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def make_divisible(x: float, divisor: int) -> int:
    """Round a channel count up to a multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


def autopad(k: int, p: int | None = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


class ConvBnAct(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, f32) + SiLU.

    `fused=True` drops the BN (its statistics folded into the conv by
    `fold_batch_norm`), and the conv then has a bias.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: bool = True, fused: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=fused)
        self.bn = None if fused else BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with a residual when shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_, c2, 3, 1, g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0, fused=fused) for _ in range(n))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three cascaded k x k max pools."""

    def __init__(self, c1: int, c2: int, k: int = 5, fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(4 * c_, c2, 1, 1, fused=fused)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
