"""Spatial sharding: the image rows of a forward split over ranks.

Counterpart of `yolopoint_tpu/parallel/spatial.py`. There, the images are
sharded over a `(data, spatial)` mesh and XLA's partitioner inserts the halo
exchanges each convolution needs. Here they are written by hand: the model
runs unchanged inside a `TorchFunctionMode` that intercepts every
convolution and max pool. Before a window that crosses a shard edge, each
rank all-gathers the edge rows of the others and builds its input with the
halo rows of its neighbours above and below (`_halo`); at the image's outer
edges the model's own padding stays (zeros for a convolution, -inf for a max
pool). A window of kernel `k`, stride `s` and padding `p` needs `p` rows
above and `k - s - p` below: the YOLOPoint stem (6x6, stride 2, pad 2) 2 and
2, a 3x3 stride-2 convolution 1 and 0, a 3x3 stride-1 one 1 and 1, SPPF's
5x5 max pool 2 and 2. Nearest 2x upsampling, concatenation, 1x1
convolutions, eval-mode BatchNorm and the heads' channel-wise operations
are local. A `F.pad` of the rows (the `C3MP` block's 2x2 pool) or any
other window (average pooling, `grid_sample`, ...) raises, rather than be
computed wrong.

Layout: rank `r` of a `(data, spatial)` layout holds batch shard
`r // spatial` and row shard `r % spatial`. Every shard's rows must be a
multiple of the model's largest stride (32), so that every map splits on a
row boundary. The outputs are the row-sharded maps (`semi`, `desc` and the
raw Detect levels, rows on dim 2); `gather_spatial` assembles them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from yolopoint_tpu_torch.parallel.mesh import Mesh, all_gather

ROW_MULTIPLE = 32  # the models' largest stride
UNSHARDABLE = (F.avg_pool2d, F.conv_transpose2d, F.grid_sample, F.unfold, F.fold,
               F.adaptive_avg_pool2d, F.adaptive_max_pool2d, F.max_pool2d_with_indices)


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A `(data, spatial)` layout of the world's ranks."""

    mesh: Mesh
    data: int
    spatial: int

    @property
    def data_index(self) -> int:
        return self.mesh.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.mesh.rank % self.spatial


def make_spatial_mesh(mesh: Mesh, data: int = 1, spatial: int | None = None) -> SpatialMesh:
    """The `(data, spatial)` layout; `spatial` defaults to world size / data."""
    spatial = spatial or mesh.size // data
    if data * spatial != mesh.size:
        raise ValueError(f"data {data} x spatial {spatial} must cover the {mesh.size} ranks")
    return SpatialMesh(mesh, data, spatial)


def shard_images(images: torch.Tensor, sp: SpatialMesh) -> torch.Tensor:
    """This rank's batch rows and image rows of an NCHW batch."""
    B, _, H, _ = images.shape
    if B % sp.data or H % (sp.spatial * ROW_MULTIPLE):
        raise ValueError(f"batch {B} must split over {sp.data} and rows {H} over {sp.spatial} "
                         f"shards of a multiple of {ROW_MULTIPLE}")
    b, h = B // sp.data, H // sp.spatial
    return images[b * sp.data_index:b * (sp.data_index + 1),
                  :, h * sp.spatial_index:h * (sp.spatial_index + 1)]


def _halo(x: torch.Tensor, top: int, bottom: int, fill: float, sp: SpatialMesh) -> torch.Tensor:
    """`x` (`(B, C, h, W)`, this rank's rows) with `top` rows above and
    `bottom` below: the neighbouring shards' rows, or `fill` past the
    image's edge. Every rank of the world takes part in one all-gather."""
    B, C, h, W = x.shape
    i, n = sp.spatial_index, sp.spatial
    above = below = x[:, :, :0]
    if n > 1 and (top or bottom):
        a, b = min(top, h), min(bottom, h)
        parts = all_gather(torch.cat([x[:, :, :b], x[:, :, h - a:]], dim=2), sp.mesh)
        row = parts[sp.data_index * n:(sp.data_index + 1) * n]
        above = torch.cat([p[:, :, b:] for p in row[:i]] + [above], dim=2)[:, :, -top:] \
            if top and i else above
        below = torch.cat([p[:, :, :b] for p in row[i + 1:]] + [below], dim=2)[:, :, :bottom] \
            if bottom and i < n - 1 else below
    pad_top = x.new_full((B, C, top - above.shape[2], W), fill)
    pad_bottom = x.new_full((B, C, bottom - below.shape[2], W), fill)
    return torch.cat([pad_top, above, x, below, pad_bottom], dim=2)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _window(x: torch.Tensor, k: int, s: int, p: int) -> tuple[int, int]:
    """The halo rows (above, below) a window of kernel `k`, stride `s` and
    padding `p` needs on this rank's `x`."""
    if x.shape[2] % s:
        raise ValueError(f"a shard of {x.shape[2]} rows does not split at stride {s}")
    return p, max(k - s - p, 0)


class _HaloMode(TorchFunctionMode):
    def __init__(self, sp: SpatialMesh):
        super().__init__()
        self.sp = sp

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d:
            return self._conv(*args, **kwargs)
        if func is F.max_pool2d:
            return self._max_pool(*args, **kwargs)
        if func is F.interpolate:
            mode = kwargs.get("mode", args[3] if len(args) > 3 else "nearest")
            scale = kwargs.get("scale_factor", args[2] if len(args) > 2 else None)
            if mode != "nearest" or scale is None or float(scale) != int(scale):
                raise NotImplementedError("spatial sharding: only nearest integer upsampling")
        if func is F.pad:
            pad = kwargs.get("pad", args[1] if len(args) > 1 else ())
            if len(pad) > 2 and any(pad[2:4]):
                raise NotImplementedError("spatial sharding: F.pad of the rows")
        if func in UNSHARDABLE:
            raise NotImplementedError(f"spatial sharding: {func.__name__} is not sharded")
        return func(*args, **kwargs)

    def _conv(self, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        (sh, sw), (dh, _) = _pair(stride), _pair(dilation)
        if isinstance(padding, str):
            raise NotImplementedError("spatial sharding: string padding")
        ph, pw = _pair(padding)
        if dh != 1:
            raise NotImplementedError("spatial sharding: dilated rows")
        top, bottom = _window(x, weight.shape[2], sh, ph)
        x = _halo(x, top, bottom, 0.0, self.sp)
        return F.conv2d(x, weight, bias, stride, (0, pw), dilation, groups)

    def _max_pool(self, x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                  return_indices=False):
        (kh, kw), (ph, pw) = _pair(kernel_size), _pair(padding)
        sh, sw = _pair(stride) if stride else (kh, kw)
        if ceil_mode or return_indices or _pair(dilation)[0] != 1:
            raise NotImplementedError("spatial sharding: max pool with ceil_mode, indices or "
                                      "dilation")
        top, bottom = _window(x, kh, sh, ph)
        x = _halo(x, top, bottom, float("-inf"), self.sp)
        return F.max_pool2d(x, (kh, kw), (sh, sw), (0, pw), dilation)


def spatial_sharded_forward(model: torch.nn.Module, sp: SpatialMesh):
    """`fwd(images)`: the eval-mode forward of this rank's shard
    (`shard_images` of an NCHW batch), the halo rows exchanged with the
    other ranks. Every rank calls `fwd` together. Returns the model's
    outputs for the shard, rows sharded (`gather_spatial` assembles them).

    Usage, on every rank:
        sp = make_spatial_mesh(mesh, data=1)
        out = spatial_sharded_forward(model, sp)(shard_images(images, sp))
        full = gather_spatial(out, sp)
    """
    model.eval()

    @torch.no_grad()
    def fwd(images: torch.Tensor) -> dict:
        if images.shape[2] % ROW_MULTIPLE:
            raise ValueError(f"a shard's rows ({images.shape[2]}) must be a multiple of "
                             f"{ROW_MULTIPLE}")
        with _HaloMode(sp):
            return model(images)

    return fwd


def gather_spatial(out: Any, sp: SpatialMesh) -> Any:
    """The global outputs from every rank's row-sharded ones: each tensor
    (rows on dim 2) gathered from all ranks, its row shards joined on dim 2
    and its batch shards on dim 0. Lists and dicts are walked."""
    if isinstance(out, Mapping):
        return {k: gather_spatial(v, sp) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(gather_spatial(v, sp) for v in out)
    if sp.mesh.size == 1:
        return out
    parts = all_gather(out, sp.mesh)
    n = sp.spatial
    return torch.cat([torch.cat(parts[d * n:(d + 1) * n], dim=2) for d in range(sp.data)], dim=0)
