"""Keypoint extraction: threshold -> NMS -> border -> tile keys -> top-k.

Counterpart of `yolopoint_tpu/ops/keypoints.py` (`simple_nms`,
`extract_keypoints`). Unlike the JAX package, which packs keys only on the
TPU, this always goes through the int32 tile keys of K1 (`cuda_nms`), on the
CPU too, so both devices compute one function: scores carry the key's
2^(pos_bits-23) relative quantization (2^-19 at radius 4).
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_keys, pos_bits_for, simple_nms
from yolopoint_tpu_torch.ops.topk import exact_top_k

__all__ = ["extract_keypoints", "simple_nms"]


def extract_keypoints(
    heatmap: torch.Tensor,
    conf_thresh: float,
    nms_radius: int,
    max_k: int,
    border: int = 4,
    nms_iterations: int = 3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size keypoints from a `(B, H, W)` probability heatmap.

    Returns:
      points: `(B, max_k, 2)` f32 `(x, y)` pixels, score-descending.
      scores: `(B, max_k)` f32 (0 for padding).
      valid: `(B, max_k)` bool.

    Raises if H or W is not a multiple of the tile edge `max(nms_radius, 1)`.
    """
    B, H, W = heatmap.shape
    t = max(int(nms_radius), 1)
    if H % t or W % t:
        raise ValueError(f"heatmap {H}x{W} is not a multiple of the NMS tile {t}")
    keys = nms_tile_keys(heatmap, conf_thresh, nms_radius, nms_iterations, border, t)
    k = min(max_k, keys.shape[1])
    key_k, tidx = exact_top_k(keys, k)
    pos_mask = (1 << pos_bits_for(t)) - 1
    hit = key_k > 0
    scores = torch.where(hit, (key_k & ~pos_mask).view(torch.float32), 0.0)
    sub = torch.where(hit, key_k & pos_mask, 0)
    ntw = W // t
    x = ((tidx % ntw) * t + sub % t).float()
    y = ((tidx // ntw) * t + sub // t).float()
    points = torch.stack([x, y], dim=-1)
    if k < max_k:
        points = torch.nn.functional.pad(points, (0, 0, 0, max_k - k))
        scores = torch.nn.functional.pad(scores, (0, max_k - k))
    return points, scores, scores > 0.0
