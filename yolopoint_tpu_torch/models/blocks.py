"""CSPDarknet building blocks in PyTorch (NCHW).

Counterpart of `yolopoint_tpu/models/blocks.py`, every block of it: the ones
the five model families use (`ConvBnAct`, `Bottleneck`, `BottleneckV8`, `C3`,
`C2f`, `SPPF`, `upsample2x`, `max_pool_2x2`) and the rest of the module
(`DWConv`, `BottleneckCSP`, `SPP`, `Focus`, `GhostConv`, `GhostBottleneck`,
`TransformerLayer`, `TransformerBlock`, `C3TR`, `C3SPP`, `C3Ghost`, `C3MP`,
`contract`, `expand`). Submodule names mirror the JAX package's (`conv`,
`bn`, `cv1`, `m.0`, ...), so its variable trees convert mechanically
(`models/convert.py`). Unlike Flax modules, torch modules take their input
width `c1` at construction.
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
    `num_batches_tracked` is not counted (the momentum is fixed). One value
    per channel (a batch of 1 at a 1x1 map) normalizes to the bias, as in
    Flax: `F.batch_norm`'s refusal of it is skipped by calling the same
    operator directly. In eval mode it is `nn.BatchNorm2d`.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x = x.float()
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return torch.batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps,
                                torch.backends.cudnn.enabled)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose bias, on a bf16 input, is added to the convolution
    already rounded to bf16, as the JAX package's bf16 `nn.Conv` adds it (and
    as cuDNN's path in PyTorch does; oneDNN on the CPU adds it before the
    rounding)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or x.dtype != torch.bfloat16:
            return super().forward(x)
        return self._conv_forward(x, self.weight, None) + self.bias[:, None, None]


def make_divisible(x: float, divisor: int) -> int:
    """Round a channel count up to a multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


def autopad(k: int, p: int | None = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


class ConvBnAct(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, f32) + SiLU.

    `fused=True` drops the BN (its statistics folded into the conv by
    `fold_batch_norm`), and the conv then has a bias (`Conv2d`: in bf16 it
    is added as the JAX package adds it). The SiLU of a bf16 tensor rounds
    once, where the JAX program rounds each of its steps (`exp`, `1 +`,
    `1 /`, `x *`) to bf16: within 2 bf16 steps of each other
    (`tests/test_torch_bf16_forward.py`).
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: bool = True, fused: bool = False):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, autopad(k, p), groups=g, bias=fused)
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


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool with stride 2 (torch `MaxPool2d(2, 2)`)."""
    return F.max_pool2d(x, 2, 2)


class DWConv(ConvBnAct):
    """Depth-wise `ConvBnAct`: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: bool = True,
                 fused: bool = False):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act, fused=fused)


class BottleneckV8(nn.Module):
    """YOLOv8 bottleneck: `k[0]` then `k[1]` convolutions, a residual when
    shapes allow."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, k[0], 1, fused=fused)
        self.cv2 = ConvBnAct(c_, c2, k[1], 1, g=g, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """YOLOv8 CSP block: `cv1` to `2c` channels split in halves, `n`
    bottlenecks cascaded on the last part, every part concatenated into
    `cv2`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBnAct(c1, 2 * c, 1, 1, fused=fused)
        self.cv2 = ConvBnAct((2 + n) * c, c2, 1, fused=fused)
        self.m = nn.ModuleList(
            BottleneckV8(c, c, shortcut, g, k=(3, 3), e=1.0, fused=fused) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class BottleneckCSP(nn.Module):
    """CSP bottleneck: `cv1` and the bottlenecks then the plain `cv3`, beside
    the plain `cv2`, through a BatchNorm (`bn`, kept when `fused`: it has no
    convolution of its own to fold into) and SiLU into `cv4`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, e=1.0, fused=fused) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], dim=1)
        return self.cv4(F.silu(self.bn(y)))


class SPP(nn.Module):
    """Spatial pyramid pooling: k x k max pools (stride 1, same size) side by
    side."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13), fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem: the four pixel phases concatenated, then `conv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: bool = True, fused: bool = False):
        super().__init__()
        self.conv = ConvBnAct(4 * c1, c2, k, s, p, g, act, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], dim=1))


class GhostConv(nn.Module):
    """Ghost convolution: `cv1` to half the channels, a 5x5 depth-wise `cv2`
    on it, both concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act: bool = True,
                 fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, None, g, act, fused=fused)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, None, c_, act, fused=fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: `conv.0` (ghost), `conv.1` (depth-wise, stride 2
    only), `conv.2` (ghost, no activation), plus the input or, at stride 2,
    `shortcut.0` (depth-wise) and `shortcut.1`."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1, fused=fused),
            ConvBnAct(c_, c_, k, s, g=c_, act=False, fused=fused) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False, fused=fused))
        self.shortcut = nn.Sequential(
            ConvBnAct(c1, c1, k, s, g=c1, act=False, fused=fused),
            ConvBnAct(c1, c2, 1, 1, act=False, fused=fused)) if s == 2 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + self.shortcut(x)


class MultiHeadAttention(nn.Module):
    """Flax's `MultiHeadDotProductAttention` in plain torch ops: `query`,
    `key`, `value` projections (with bias) into `num_heads` heads, softmax of
    the scaled dot products over the keys, and the `out` projection. Inputs
    are `(B, L, C)`."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.out = nn.Linear(c, c)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, L, C = q.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(B, -1, h, C // h).transpose(1, 2)  # (B, h, L, C/h)

        q, k, v = heads(self.query(q)), heads(self.key(k)), heads(self.value(v))
        w = torch.softmax((q / math.sqrt(C // h)) @ k.transpose(-2, -1), dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(B, L, C))


class TransformerLayer(nn.Module):
    """One transformer layer without LayerNorm: `q`, `k`, `v` projections
    (no bias) into the attention `ma`, then the 2-layer MLP `fc1`, `fc2`,
    both residual. Tokens are `(L, B, C)`."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = MultiHeadAttention(c, num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (t.transpose(0, 1) for t in (self.q(x), self.k(x), self.v(x)))
        x = self.ma(q, k, v).transpose(0, 1) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """Transformer over the flattened pixels: an input `conv` when the width
    changes, a learned position term (`linear`, added), `num_layers`
    `TransformerLayer`s (`tr.<i>`)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int, fused: bool = False):
        super().__init__()
        self.conv = ConvBnAct(c1, c2, fused=fused) if c1 != c2 else None
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*(TransformerLayer(c2, num_heads) for _ in range(num_layers)))
        self.c2 = c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            x = self.conv(x)
        B, C, H, W = x.shape
        p = x.flatten(2).permute(2, 0, 1)  # (HW, B, C)
        p = self.tr(p + self.linear(p))
        return p.permute(1, 2, 0).reshape(B, self.c2, H, W)


class C3TR(C3):
    """`C3` with a `TransformerBlock` (4 heads, `n` layers) as its inner
    branch `m`."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__(c1, c2, 0, e=e, fused=fused)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n, fused=fused)


class C3SPP(C3):
    """`C3` with an `SPP` as its inner branch `m`."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13), e: float = 0.5, fused: bool = False):
        super().__init__(c1, c2, 0, e=e, fused=fused)
        c_ = int(c2 * e)
        self.m = SPP(c_, c_, k, fused=fused)


class C3Ghost(C3):
    """`C3` with `GhostBottleneck`s as its inner blocks `m.<i>`."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__(c1, c2, 0, e=e, fused=fused)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_, fused=fused) for _ in range(n)))


class C3MP(nn.Module):
    """`C3` variant whose second branch is a stride-1 2x2 max pool of the
    input (padded at the bottom and right to keep the size), with no `cv2`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(c_ + c1, c2, 1, fused=fused)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, e=1.0, fused=fused) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y2 = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
        return self.cv3(torch.cat([self.m(self.cv1(x)), y2], dim=1))


def contract(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Width and height into channels: `(B, C, H, W)` -> `(B, C g^2, H/g,
    W/g)`, in torch `Contract`'s channel order."""
    B, C, H, W = x.shape
    g = gain
    x = x.reshape(B, C, H // g, g, W // g, g).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, C * g * g, H // g, W // g)


def expand(x: torch.Tensor, gain: int = 2) -> torch.Tensor:
    """Channels into width and height, the inverse order of `contract`:
    `(B, C, H, W)` -> `(B, C/g^2, H g, W g)`."""
    B, C, H, W = x.shape
    g = gain
    x = x.reshape(B, g, g, C // g**2, H, W).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(B, C // g**2, H * g, W * g)
