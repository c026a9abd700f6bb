"""Image sampling at pixel coordinates, and descriptor sampling at keypoints.

Counterpart of `yolopoint_tpu/ops/sampling.py`:

* `grid_sample(img, coords, mode)`: the plain NHWC gather, bilinear or
  nearest (`floor(x + 0.5)`), zero padding outside the image,
  differentiable in `img` (its backward is a scatter-add). The warp's plain
  version (`ops/geometry.py`) and the descriptor loss use it.
* `sample_descriptors(desc, points, cell_size=8)`: the serving path's
  descriptor sampling, K3 (the op `yolopoint::sample_descriptors` over
  `cuda_gather`), exact in f32 on every device;
  `(B, Hc, Wc, D)` coarse map and `(B, N, 2)` full-resolution `(x, y)`
  points -> `(B, N, D)` unit descriptors.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import library


def _gather_pixels(flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """`flat[b, y * W + x, :]` for float integer-valued `x, y` of shape
    `(B, P)`, zero where the pixel lies outside the image (NaN included)."""
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    lin = torch.where(inside, y * W + x, 0.0).long()
    vals = torch.gather(flat, 1, lin[..., None].expand(-1, -1, flat.shape[-1]))
    return torch.where(inside[..., None], vals, 0.0)


def grid_sample(img: torch.Tensor, coords: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Sample `(B, H, W, C)` images at `(B, ..., 2)` pixel coords `(x, y)`
    (not normalized) with zero padding; returns `(B, ..., C)`.

    Bilinear blends the four taps in the JAX package's order,
    `top = v00 (1 - wx) + v01 wx`, then `top (1 - wy) + bot wy`.
    """
    B, H, W, C = img.shape
    out_shape = coords.shape[:-1] + (C,)
    flat = img.reshape(B, H * W, C)
    x = coords[..., 0].reshape(B, -1)
    y = coords[..., 1].reshape(B, -1)
    if mode == "nearest":
        out = _gather_pixels(flat, torch.floor(x + 0.5), torch.floor(y + 0.5), H, W)
        return out.reshape(out_shape)
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode}")
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    v00 = _gather_pixels(flat, x0, y0, H, W)
    v01 = _gather_pixels(flat, x0 + 1, y0, H, W)
    v10 = _gather_pixels(flat, x0, y0 + 1, H, W)
    v11 = _gather_pixels(flat, x0 + 1, y0 + 1, H, W)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).reshape(out_shape)


def sample_descriptors(desc: torch.Tensor, points: torch.Tensor, cell_size: int = 8) -> torch.Tensor:
    """K3: `(B, Hc, Wc, D)` f32/bf16 map, `(B, N, 2)` f32 points -> `(B, N, D)`
    unit f32 descriptors."""
    return library.sample_descriptors(desc, points, cell_size)


__all__ = ["grid_sample", "sample_descriptors"]
