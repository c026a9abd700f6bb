"""YOLOPoint (v5-style) in PyTorch, NCHW.

Counterpart of `YOLOPoint`, `_l2_normalize` and `build_model` in
`yolopoint_tpu/models/yolopoint.py`: a shared CSP backbone, a 65-channel
keypoint head at stride 8, a fused stride-4/16 descriptor head (unit
L2 norm), and a PANet neck into an anchor Detect head on P3/4/5.

`forward` takes `(B, 3, H, W)` and returns `{"semi": (B, 65, Hc, Wc),
"desc": (B, D, Hc, Wc), "objects": [raw levels (B, na, ny, nx, 5+nc)]}`.
The other architectures of the JAX package are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from yolopoint_tpu_torch.models.blocks import C3, SPPF, ConvBnAct, make_divisible, upsample2x
from yolopoint_tpu_torch.models.detect import ANCHORS_DEFAULT, Detect
from yolopoint_tpu_torch.utils.device import resolve_device

# version -> (depth multiple, width multiple)
VERSION_MULTIPLIERS = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.5),
    "m": (0.67, 0.75),
    "l": (1.0, 1.0),
    "x": (1.33, 1.25),
}


def _l2_normalize(desc: torch.Tensor) -> torch.Tensor:
    """Channel (dim 1) L2 normalization; the norm is taken in f32."""
    dn = torch.linalg.vector_norm(desc.float(), dim=1, keepdim=True)
    return desc / dn.clamp(min=1e-12)


class YOLOPoint(nn.Module):
    def __init__(self, width_multiple: float = 1.0, depth_multiple: float = 1.0, nc: int = 80,
                 anchors=ANCHORS_DEFAULT, fused: bool = False):
        super().__init__()
        c1, c2, c3, c4, c5 = (make_divisible(2**k * width_multiple, 8) for k in range(6, 11))
        n1, n2, n3 = (max(round(k * depth_multiple), 1) for k in (3, 6, 9))
        kw = dict(fused=fused)
        self.nc = nc
        # CSP shared backbone
        self.Conv1 = ConvBnAct(3, c1, 6, 2, 2, **kw)
        self.Conv2 = ConvBnAct(c1, c2, 3, 2, **kw)
        self.Bottleneck1 = C3(c2, c2, n1, **kw)
        self.Conv3 = ConvBnAct(c2, c3, 3, 2, **kw)
        # keypoint detector head
        self.BottleneckDet = C3(c3, c3, n1, **kw)
        self.ConvDet = nn.Conv2d(c3, 65, 1, bias=False)
        # descriptor + YOLO encoder
        self.Bottleneck2 = C3(c3, c3, n2, **kw)
        # descriptor head
        self.ConvDescA = ConvBnAct(c2, c2, 3, 2, 1, **kw)
        self.ConvDescB = ConvBnAct(c3, c2, 3, 2, 1, **kw)
        self.BottleneckDesc = C3(2 * c2, c3, n1, **kw)
        self.ConvDesc = nn.Conv2d(c3, c3, 3, padding=1, bias=False)
        # YOLO-exclusive encoder
        self.Conv4 = ConvBnAct(c3, c4, 3, 2, **kw)
        self.Bottleneck3 = C3(c4, c4, n3, **kw)
        self.Conv5 = ConvBnAct(c4, c5, 3, 2, **kw)
        self.Bottleneck4 = C3(c5, c5, n1, **kw)
        self.SPPooling = SPPF(c5, c5, 5, **kw)
        # PANet neck
        self.Conv6 = ConvBnAct(c5, c4, 1, 1, 0, **kw)
        self.Bottleneck5 = C3(2 * c4, c4, n1, **kw)
        self.Conv7 = ConvBnAct(c4, c3, 1, 1, 0, **kw)
        self.Bottleneck6 = C3(2 * c3, c3, n1, **kw)
        self.Conv8 = ConvBnAct(c3, c3, 3, 2, 1, **kw)
        self.Bottleneck7 = C3(2 * c3, c4, n1, **kw)
        self.Conv9 = ConvBnAct(c4, c4, 3, 2, 1, **kw)
        self.Bottleneck8 = C3(2 * c4, c5, n1, **kw)
        self.Detect = Detect(nc, anchors, (8, 16, 32), ch=(c3, c4, c5))

    def forward(self, x: torch.Tensor) -> dict:
        x = self.Conv2(self.Conv1(x))
        xa = self.Bottleneck1(x)
        x = self.Conv3(xa)

        semi = self.ConvDet(self.BottleneckDet(x))

        xb = self.Bottleneck2(x)
        desc = torch.cat([self.ConvDescA(xa), upsample2x(self.ConvDescB(xb))], dim=1)
        desc = _l2_normalize(self.ConvDesc(self.BottleneckDesc(desc)))

        xc = self.Bottleneck3(self.Conv4(xb))
        x = self.SPPooling(self.Bottleneck4(self.Conv5(xc)))

        xd = self.Conv6(x)
        x = self.Bottleneck5(torch.cat([upsample2x(xd), xc], dim=1))
        xe = self.Conv7(x)
        xf = self.Bottleneck6(torch.cat([upsample2x(xe), xb], dim=1))
        xg = self.Bottleneck7(torch.cat([self.Conv8(xf), xe], dim=1))
        x = self.Bottleneck8(torch.cat([self.Conv9(xg), xd], dim=1))
        return {"semi": semi, "desc": desc, "objects": self.Detect([xf, xg, x])}


def build_model(
    model_name: str = "YOLOPoint",
    version: str = "s",
    nc: int = 80,
    dtype: torch.dtype = torch.float32,
    fused: bool = False,
    device: str | torch.device | None = None,
) -> YOLOPoint:
    """Build an architecture by name and version letter, in eval mode, on
    `device` (default: the GPU) in `dtype`."""
    if model_name != "YOLOPoint":
        raise NotImplementedError(f"{model_name!r} is not ported; only 'YOLOPoint' is")
    v = version.lower()
    if v not in VERSION_MULTIPLIERS:
        raise ValueError(f"version {version!r} not in {sorted(VERSION_MULTIPLIERS)}")
    dm, wm = VERSION_MULTIPLIERS[v]
    model = YOLOPoint(wm, dm, nc, ANCHORS_DEFAULT, fused)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
