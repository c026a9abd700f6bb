"""YOLOv5 anchor-based Detect head in PyTorch.

Counterpart of `yolopoint_tpu/models/detect.py`: a 1x1 conv per level to
`na * (5 + nc)` channels, returned raw as `(B, na, ny, nx, 5 + nc)` levels
(the serving path decodes them in `ops/nms.py`); `decode_levels` gives the
decoded `(B, sum N, 5 + nc)` predictions of `Detect.__call__(decode=True)`.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from yolopoint_tpu_torch.models.blocks import Conv2d

# default anchors in pixels, one row per level
ANCHORS_DEFAULT = (
    (10, 13, 16, 30, 33, 23),
    (30, 61, 62, 45, 59, 119),
    (116, 90, 156, 198, 373, 326),
)


def check_anchor_order(anchors: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """Flip `(nl, na, 2)` per-stride anchors if their area order disagrees
    with the stride order."""
    a = anchors.prod(-1).reshape(-1)
    if np.sign(a[-1] - a[0]) != np.sign(strides[-1] - strides[0]):
        anchors = anchors[::-1].copy()
    return anchors


class Detect(nn.Module):
    """Multi-level detection head; `ch` are the input widths per level."""

    def __init__(self, nc: int = 80, anchors=ANCHORS_DEFAULT, strides=(8, 16, 32),
                 ch: Sequence[int] = (128, 256, 512)):
        super().__init__()
        self.nc = nc
        self.anchors = tuple(tuple(a) for a in anchors)
        self.strides = tuple(strides)
        self.nl = len(self.anchors)
        self.na = len(self.anchors[0]) // 2
        self.no = nc + 5
        self.m = nn.ModuleList(Conv2d(c, self.no * self.na, 1) for c in ch)
        self.init_prior_bias()

    def anchors_per_stride(self) -> np.ndarray:
        """`(nl, na, 2)` anchors divided by their stride, order-checked."""
        a = np.asarray(self.anchors, np.float32).reshape(self.nl, -1, 2)
        a = a / np.asarray(self.strides, np.float32)[:, None, None]
        return check_anchor_order(a, self.strides)

    @torch.no_grad()
    def init_prior_bias(self) -> None:
        """Prior biases: objectness for ~8 objects per 640 px image at each
        stride, class scores at 0.6 / (nc - 1)."""
        for conv, stride in zip(self.m, self.strides):
            b = torch.zeros(self.na, self.no)
            b[:, 4] += math.log(8.0 / (640.0 / stride) ** 2)
            if self.nc > 1:
                b[:, 5:] += math.log(0.6 / (self.nc - 0.999999))
            conv.bias.copy_(b.reshape(-1))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        raw = []
        for conv, x in zip(self.m, feats):
            y = conv(x)
            B, _, ny, nx = y.shape
            raw.append(y.reshape(B, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2))
        return raw


def decode_levels(raw_levels: Sequence[torch.Tensor], anchors_ps, strides: Sequence[int]
                  ) -> torch.Tensor:
    """Raw levels `(B, na, ny, nx, 5 + nc)` -> f32 predictions `(B, sum N, 5 + nc)`:
    pixel `[cx, cy, w, h]`, then the sigmoids of objectness and class logits."""
    out = []
    for li, y in enumerate(raw_levels):
        B, na, ny, nx, no = y.shape
        stride = float(strides[li])
        sig = torch.sigmoid(y.float())
        gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=y.device),
                                torch.arange(nx, dtype=torch.float32, device=y.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)[None, None]
        anchor_grid = (torch.as_tensor(anchors_ps[li], dtype=torch.float32, device=y.device)
                       * stride).reshape(1, na, 1, 1, 2)
        xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * stride
        wh = (sig[..., 2:4] * 2.0) ** 2 * anchor_grid
        out.append(torch.cat([xy, wh, sig[..., 4:]], dim=-1).reshape(B, -1, no))
    return torch.cat(out, dim=1)
