"""K1: fused keypoint NMS + tile keys (CUDA kernel `csrc/nms_keys.cu`).

Counterpart of `nms_tile_keys` in `yolopoint_tpu/ops/pallas_nms.py` (the
Pallas kernel `_kernel_keys`). For a `(B, H, W)` heatmap it computes
threshold -> iterative `simple_nms` -> border zeroing -> per survivor an
order-preserving int32 key `(f32 bits & ~pos_mask) | (dy*t + dx)` -> the
max key of each t x t tile, returning `(B, H/t * W/t)` int32 keys (0 marks
an empty tile). Top-k over the keys yields scores and positions at once.

`nms_tile_keys_torch` is the plain PyTorch version: the CPU path and the
kernel's reference on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops import _build


def pos_bits_for(t: int) -> int:
    """Low mantissa bits that carry the in-tile position dy*t + dx."""
    return max((t * t - 1).bit_length(), 1)


def _maxpool2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window max with -inf padding (`max_pool2d` pads with -inf)."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 3) -> torch.Tensor:
    """Iterative non-maximum suppression of a `(B, H, W)` score map.

    Round 1 keeps strict window maxima; each later round re-admits maxima of
    the map with every kept point's window zeroed. Counterpart of
    `yolopoint_tpu/ops/keypoints.py:simple_nms`.
    """
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool2d(scores, radius)
    for _ in range(iterations - 1):
        supp_mask = _maxpool2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _check_shape(heatmap: torch.Tensor, t: int) -> None:
    if heatmap.dim() != 3:
        raise ValueError(f"heatmap must be (B, H, W), got {tuple(heatmap.shape)}")
    _, H, W = heatmap.shape
    if H % t or W % t:
        raise ValueError(f"H and W must be multiples of the tile {t}, got {H}x{W}")


def nms_tile_keys_torch(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
    tile: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device). Math in f32."""
    t = tile or max(int(radius), 1)
    _check_shape(heatmap, t)
    B, H, W = heatmap.shape
    s = heatmap.float()
    s = torch.where(s >= conf_thresh, s, torch.zeros_like(s))
    s = simple_nms(s, radius, iterations)
    ys = torch.arange(H, dtype=torch.int32, device=s.device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=s.device)[None, :]
    ok = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    s = torch.where(ok, s, torch.zeros_like(s))
    pos_mask = (1 << pos_bits_for(t)) - 1
    pos = (ys % t) * t + xs % t
    key = torch.where(s > 0.0, (s.view(torch.int32) & ~pos_mask) | pos, 0)
    key = key.reshape(B, H // t, t, W // t, t).amax(dim=(2, 4))
    return key.reshape(B, (H // t) * (W // t))


def nms_tile_keys(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
    tile: int | None = None,
) -> torch.Tensor:
    """K1: `(B, H, W)` f32/bf16 heatmap -> `(B, H/t * W/t)` int32 tile keys.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    t = tile or max(int(radius), 1)
    if heatmap.device.type == "cpu":
        return nms_tile_keys_torch(heatmap, conf_thresh, radius, iterations, border, t)
    _build.require_cuda(heatmap, "heatmap", (torch.float32, torch.bfloat16), 3)
    _check_shape(heatmap, t)
    if iterations < 1 or radius < 0:
        raise ValueError(f"need iterations >= 1 and radius >= 0, got {iterations}, {radius}")
    B, H, W = heatmap.shape
    keys = torch.empty((B, (H // t) * (W // t)), dtype=torch.int32, device=heatmap.device)
    code = _build.library().yp_nms_tile_keys(
        heatmap.data_ptr(), int(heatmap.dtype == torch.bfloat16), keys.data_ptr(),
        B, H, W, float(conf_thresh), int(radius), int(iterations), int(border), t,
        _build.stream_ptr(heatmap),
    )
    _build.check(code, "nms_tile_keys")
    _build.launch_counts["nms_tile_keys"] += 1
    return keys
