"""K3: bilinear descriptor sampling + L2 renorm (CUDA kernel `csrc/gather.cu`).

Counterpart of `sample_descriptors_pallas` in
`yolopoint_tpu/ops/pallas_gather.py` (the Pallas kernel `_kernel`), computed
exactly in f32 as `sample_descriptors` of `yolopoint_tpu/ops/sampling.py`:
full-resolution points `(x, y)` map onto the `(B, Hc, Wc, D)` coarse map with
align-corners, taps outside the map weigh 0, and each sampled vector is
renormalized with `rsqrt(max(|v|^2, 1e-16))`.

`sample_descriptors_torch` is the plain PyTorch version: the CPU path and
the kernel's reference on the card.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import _build

MAX_D = 512  # `kMaxWidth` in `csrc/gather.cu`


def _check(desc: torch.Tensor, points: torch.Tensor) -> None:
    if desc.dim() != 4:
        raise ValueError(f"desc must be (B, Hc, Wc, D), got {tuple(desc.shape)}")
    if points.dim() != 3 or points.shape[-1] != 2 or points.shape[0] != desc.shape[0]:
        raise ValueError(f"points must be (B, N, 2), got {tuple(points.shape)}")


def sample_descriptors_torch(
    desc: torch.Tensor, points: torch.Tensor, cell_size: int = 8
) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device), f32."""
    _check(desc, points)
    B, Hc, Wc, D = desc.shape
    W, H = Wc * cell_size, Hc * cell_size
    pts = points.float()
    xn = pts[..., 0] / (W / 2.0) - 1.0
    yn = pts[..., 1] / (H / 2.0) - 1.0
    cx = (xn + 1.0) * 0.5 * (Wc - 1)
    cy = (yn + 1.0) * 0.5 * (Hc - 1)
    x0, y0 = torch.floor(cx), torch.floor(cy)
    wx, wy = (cx - x0)[..., None], (cy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = desc.reshape(B, Hc * Wc, D).float()

    def tap(xi: torch.Tensor, yi: torch.Tensor) -> torch.Tensor:
        inside = (xi >= 0) & (xi <= Wc - 1) & (yi >= 0) & (yi <= Hc - 1)
        lin = yi.clamp(0, Hc - 1) * Wc + xi.clamp(0, Wc - 1)
        vals = torch.gather(flat, 1, lin[..., None].expand(-1, -1, D))
        return torch.where(inside[..., None], vals, 0.0)

    top = tap(x0i, y0i) * (1 - wx) + tap(x0i + 1, y0i) * wx
    bot = tap(x0i, y0i + 1) * (1 - wx) + tap(x0i + 1, y0i + 1) * wx
    sampled = top * (1 - wy) + bot * wy
    n2 = (sampled * sampled).sum(dim=-1, keepdim=True)
    return sampled * torch.rsqrt(n2.clamp(min=1e-16))


def sample_descriptors_cuda(
    desc: torch.Tensor, points: torch.Tensor, cell_size: int = 8
) -> torch.Tensor:
    """K3: `(B, Hc, Wc, D)` f32/bf16 map, `(B, N, 2)` f32 points -> `(B, N, D)` f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    Both refuse a width D outside 1..`MAX_D`.
    """
    _check(desc, points)
    D = desc.shape[3]
    if not 0 < D <= MAX_D:
        raise ValueError(f"descriptor width {D} must be in 1..{MAX_D}")
    if desc.device.type == "cpu":
        return sample_descriptors_torch(desc, points, cell_size)
    _build.require_cuda(desc, "desc", (torch.float32, torch.bfloat16), 4)
    _build.require_cuda(points, "points", (torch.float32,), 3)
    B, Hc, Wc, _ = desc.shape
    N = points.shape[1]
    out = torch.empty((B, N, D), dtype=torch.float32, device=desc.device)
    if N == 0:
        return out
    code = _build.library().yp_sample_descriptors(
        desc.data_ptr(), int(desc.dtype == torch.bfloat16), points.data_ptr(),
        out.data_ptr(), B, Hc, Wc, D, N, int(cell_size), _build.stream_ptr(desc),
    )
    _build.check(code, "sample_descriptors")
    _build.launch_counts["sample_descriptors"] += 1
    return out
