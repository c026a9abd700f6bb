"""The YOLOPoint model family in PyTorch, NCHW.

Counterpart of `yolopoint_tpu/models/yolopoint.py`, all five architectures:

* `YOLOPoint`     shared CSP backbone, 65-channel keypoint head at stride 8,
                  fused stride-4/16 descriptor head (unit L2 norm), PANet
                  neck into an anchor Detect head on P3/4/5;
* `YOLOPointv52`  the same layout with C2f blocks; its `semi` is the C2f(65)
                  output (after its SiLU, no `ConvDet`), its stride-4
                  descriptor branch a 2x2 max pool;
* `YOLOPointDet`  points and descriptors only (no Detect);
* `SuperPointNet` the VGG SuperPoint: biased convolutions with ReLU, no
                  BatchNorm, 256-channel descriptors;
* `YOLOv8Point`   a v8 backbone with late point heads (its `Conv5` is fed
                  from the `Conv3` output, not from `Bottleneck4`, as in the
                  JAX package).

`forward` takes `(B, 3, H, W)` and returns `{"semi": (B, 65, Hc, Wc),
"desc": (B, D, Hc, Wc)}` plus, for the families with a Detect head,
`"objects": [raw levels (B, na, ny, nx, 5+nc)]`. `build_model` mirrors the
JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from yolopoint_tpu_torch.models.blocks import (
    C3,
    SPPF,
    C2f,
    Conv2d,
    ConvBnAct,
    make_divisible,
    max_pool_2x2,
    upsample2x,
)
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


def _widths(width_multiple: float) -> tuple[int, int, int, int, int]:
    return tuple(make_divisible(2**k * width_multiple, 8) for k in range(6, 11))


def _depths(depth_multiple: float) -> tuple[int, int, int]:
    return tuple(max(round(k * depth_multiple), 1) for k in (3, 6, 9))


class YOLOPoint(nn.Module):
    def __init__(self, width_multiple: float = 1.0, depth_multiple: float = 1.0, nc: int = 80,
                 anchors=ANCHORS_DEFAULT, fused: bool = False):
        super().__init__()
        c1, c2, c3, c4, c5 = _widths(width_multiple)
        n1, n2, n3 = _depths(depth_multiple)
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


class YOLOPointv52(nn.Module):
    def __init__(self, width_multiple: float = 1.0, depth_multiple: float = 1.0, nc: int = 80,
                 anchors=ANCHORS_DEFAULT, fused: bool = False):
        super().__init__()
        c1, c2, c3, c4, c5 = _widths(width_multiple)
        n1, n2, n3 = _depths(depth_multiple)
        kw = dict(fused=fused)
        self.nc = nc
        self.Conv1 = ConvBnAct(3, c1, 6, 2, 2, **kw)
        self.Conv2 = ConvBnAct(c1, c2, 3, 2, **kw)
        self.Bottleneck1 = C2f(c2, c2, n1, **kw)
        self.Conv3 = ConvBnAct(c2, c3, 3, 2, **kw)
        self.BottleneckDet = C2f(c3, 65, n1, **kw)
        self.Bottleneck2 = C2f(c3, c3, n2, **kw)
        self.ConvDescB = ConvBnAct(c3, c2, 3, 2, 1, **kw)
        self.BottleneckDesc = C2f(2 * c2, c3, n1, **kw)
        self.Conv4 = ConvBnAct(c3, c4, 3, 2, **kw)
        self.Bottleneck3 = C2f(c4, c4, n3, **kw)
        self.Conv5 = ConvBnAct(c4, c4, 3, 2, **kw)
        self.Bottleneck4 = C2f(c4, c4, n1, **kw)
        self.SPPooling = SPPF(c4, c4, 5, **kw)
        self.Bottleneck5 = C2f(2 * c4, c4, n1, **kw)
        self.Bottleneck6 = C2f(c4 + c3, c3, n1, **kw)
        self.Conv8 = ConvBnAct(c3, c3, 3, 2, 1, **kw)
        self.Bottleneck7 = C2f(c3 + c4, c4, n1, **kw)
        self.Conv9 = ConvBnAct(c4, c4, 3, 2, 1, **kw)
        self.Bottleneck8 = C2f(2 * c4, c4, n1, **kw)
        self.Detect = Detect(nc, anchors, (8, 16, 32), ch=(c3, c4, c4))

    def forward(self, x: torch.Tensor) -> dict:
        x = self.Conv2(self.Conv1(x))
        xa = self.Bottleneck1(x)
        x = self.Conv3(xa)

        semi = self.BottleneckDet(x)

        xb = self.Bottleneck2(x)
        desc = torch.cat([max_pool_2x2(xa), upsample2x(self.ConvDescB(xb))], dim=1)
        desc = _l2_normalize(self.BottleneckDesc(desc))

        xc = self.Bottleneck3(self.Conv4(xb))
        xd = self.SPPooling(self.Bottleneck4(self.Conv5(xc)))

        xe = self.Bottleneck5(torch.cat([upsample2x(xd), xc], dim=1))
        xf = self.Bottleneck6(torch.cat([upsample2x(xe), xb], dim=1))
        xg = self.Bottleneck7(torch.cat([self.Conv8(xf), xe], dim=1))
        x = self.Bottleneck8(torch.cat([self.Conv9(xg), xd], dim=1))
        return {"semi": semi, "desc": desc, "objects": self.Detect([xf, xg, x])}


class YOLOPointDet(nn.Module):
    def __init__(self, width_multiple: float = 1.0, depth_multiple: float = 1.0,
                 fused: bool = False):
        super().__init__()
        c1, c2, c3, c4, c5 = _widths(width_multiple)
        n1, n2, n3 = _depths(depth_multiple)
        kw = dict(fused=fused)
        self.Conv1 = ConvBnAct(3, c1, 6, 2, 2, **kw)
        self.Conv2 = ConvBnAct(c1, c2, 3, 2, **kw)
        self.Bottleneck1 = C3(c2, c2, n1, **kw)
        self.Conv3 = ConvBnAct(c2, c3, 3, 2, **kw)
        self.BottleneckDet = C3(c3, c3, n1, **kw)
        self.ConvDet = nn.Conv2d(c3, 65, 1, bias=False)
        self.Bottleneck2 = C3(c3, c3, n2, **kw)
        self.ConvDescA = ConvBnAct(c2, c2, 3, 2, 1, **kw)
        self.ConvDescB = ConvBnAct(c3, c2, 3, 2, 1, **kw)
        self.BottleneckDesc = C3(2 * c2, c3, n1, **kw)
        self.ConvDesc = nn.Conv2d(c3, c3, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> dict:
        x = self.Conv2(self.Conv1(x))
        xa = self.Bottleneck1(x)
        x = self.Conv3(xa)
        semi = self.ConvDet(self.BottleneckDet(x))
        xb = self.Bottleneck2(x)
        desc = torch.cat([self.ConvDescA(xa), upsample2x(self.ConvDescB(xb))], dim=1)
        desc = _l2_normalize(self.ConvDesc(self.BottleneckDesc(desc)))
        return {"semi": semi, "desc": desc}


class SuperPointNet(nn.Module):
    def __init__(self):
        super().__init__()
        c1, c2, c3, c4, c5, d1 = 64, 64, 128, 128, 256, 256
        widths = (("conv1a", 3, c1), ("conv1b", c1, c1), ("conv2a", c1, c2),
                  ("conv2b", c2, c2), ("conv3a", c2, c3), ("conv3b", c3, c3),
                  ("conv4a", c3, c4), ("conv4b", c4, c4), ("convPa", c4, c5),
                  ("convDa", c4, c5))
        for name, ci, co in widths:
            setattr(self, name, Conv2d(ci, co, 3, padding=1))
        self.convPb = Conv2d(c5, 65, 1)
        self.convDb = Conv2d(c5, d1, 1)

    def forward(self, x: torch.Tensor) -> dict:
        for i, stage in enumerate(("1", "2", "3", "4")):
            if i:
                x = max_pool_2x2(x)
            x = F.relu(getattr(self, f"conv{stage}a")(x))
            x = F.relu(getattr(self, f"conv{stage}b")(x))
        semi = self.convPb(F.relu(self.convPa(x)))
        desc = _l2_normalize(self.convDb(F.relu(self.convDa(x))))
        return {"semi": semi, "desc": desc}


class YOLOv8Point(nn.Module):
    def __init__(self, width_multiple: float = 1.0, depth_multiple: float = 1.0, nc: int = 80,
                 anchors=ANCHORS_DEFAULT, fused: bool = False):
        super().__init__()
        c1, c2, c3, c4, c5 = _widths(width_multiple)
        n1, n2, n3 = _depths(depth_multiple)
        kw = dict(fused=fused)
        self.nc = nc
        self.Conv0 = ConvBnAct(3, c1, 3, 2, 1, **kw)
        self.Conv1 = ConvBnAct(c1, c2, 3, 2, 1, **kw)
        self.Bottleneck2 = C2f(c2, c2, n1, shortcut=True, **kw)
        self.Conv3 = ConvBnAct(c2, c3, 3, 2, 1, **kw)
        self.Bottleneck4 = C2f(c3, c3, n2, shortcut=True, **kw)
        self.Conv5 = ConvBnAct(c3, c4, 3, 2, 1, **kw)
        self.Bottleneck6 = C2f(c4, c4, n2, shortcut=True, **kw)
        self.Conv7 = ConvBnAct(c4, c4, 3, 2, 1, **kw)
        self.Bottleneck8 = C2f(c4, c4, n1, shortcut=True, **kw)
        self.SPPooling9 = SPPF(c4, c4, 5, **kw)
        self.Bottleneck12 = C2f(2 * c4, c4, n1, **kw)
        self.Bottleneck15 = C2f(c4 + c3, c3, n1, **kw)
        self.Conv16 = ConvBnAct(c3, c3, 3, 2, 1, **kw)
        self.Bottleneck18 = C2f(c3 + c4, c4, n1, **kw)
        self.Conv19 = ConvBnAct(c4, c4, 3, 2, 1, **kw)
        self.Bottleneck21 = C2f(2 * c4, c4, n1, **kw)
        self.Detect = Detect(nc, anchors, (8, 16, 32), ch=(c3, c4, c4))
        self.Conv22 = ConvBnAct(c4, c3, 3, 1, 1, **kw)
        self.Conv25 = ConvBnAct(2 * c3, c3, 3, 1, 1, **kw)
        self.BottleneckDet = C2f(c2 + c3, 65, n1, **kw)
        self.BottleneckDesc = C2f(c2 + c3, c3, n1, **kw)
        self.ConvDesc = nn.Conv2d(c3, c3, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> dict:
        x = self.Conv1(self.Conv0(x))
        xa = self.Bottleneck2(x)
        x = self.Conv3(xa)
        xb = self.Bottleneck4(x)
        # the JAX package feeds Conv5 from the Conv3 output, not from xb
        xc = self.Bottleneck6(self.Conv5(x))
        xd = self.SPPooling9(self.Bottleneck8(self.Conv7(xc)))

        xe = self.Bottleneck12(torch.cat([upsample2x(xd), xc], dim=1))
        xf = self.Bottleneck15(torch.cat([upsample2x(xe), xb], dim=1))
        xg = self.Bottleneck18(torch.cat([self.Conv16(xf), xe], dim=1))
        x = self.Bottleneck21(torch.cat([self.Conv19(xg), xd], dim=1))
        objects = self.Detect([xf, xg, x])

        xc2 = self.Conv25(torch.cat([upsample2x(self.Conv22(xc)), xb], dim=1))
        xa2 = torch.cat([max_pool_2x2(xa), xc2], dim=1)
        semi = self.BottleneckDet(xa2)
        desc = _l2_normalize(self.ConvDesc(self.BottleneckDesc(xa2)))
        return {"semi": semi, "desc": desc, "objects": objects}


MODEL_REGISTRY = {
    "YOLOPoint": YOLOPoint,
    "YOLOPointv52": YOLOPointv52,
    "YOLOPointDet": YOLOPointDet,
    "SuperPointNet": SuperPointNet,
    "YOLOv8Point": YOLOv8Point,
}

def build_model(
    model_name: str = "YOLOPoint",
    version: str | None = "s",
    nc: int = 80,
    anchors=None,
    dtype: torch.dtype = torch.float32,
    fused: bool = False,
    device: str | torch.device | None = None,
) -> nn.Module:
    """Build an architecture by name and version letter, in eval mode, on
    `device` (default: the GPU) in `dtype`. `version=None` means multipliers
    1.0/1.0; `SuperPointNet` ignores `version`, `nc`, `anchors` and `fused`
    (it has no BatchNorm), `YOLOPointDet` `nc` and `anchors`. An unknown
    name raises `ValueError`."""
    if model_name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {model_name!r}; choose from {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[model_name]
    if cls is SuperPointNet:
        model = cls()
    else:
        if version is None:
            dm, wm = 1.0, 1.0
        else:
            v = version.lower()
            if v not in VERSION_MULTIPLIERS:
                raise ValueError(f"version {version!r} not in {sorted(VERSION_MULTIPLIERS)}")
            dm, wm = VERSION_MULTIPLIERS[v]
        if cls is YOLOPointDet:
            model = cls(wm, dm, fused=fused)
        else:
            anchors = tuple(tuple(a) for a in anchors) if anchors else ANCHORS_DEFAULT
            model = cls(wm, dm, nc, anchors, fused)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
