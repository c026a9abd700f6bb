"""Keypoint extraction: threshold -> NMS -> border -> per-tile reduction -> top-k.

Counterpart of `yolopoint_tpu/ops/keypoints.py` (`simple_nms`,
`extract_keypoints`). Where H and W are multiples of the tile edge
`max(nms_radius, 1)`, this goes through the int32 tile keys of K1
(`cuda_nms.nms_tile_keys`), on the CPU too, so both devices compute one
function: scores carry the key's 2^(pos_bits-23) relative quantization
(2^-19 at radius 4). Other shapes take the JAX package's XLA path step for
step: K6's suppressed map of the unpadded heatmap, zero-padded to tile
multiples, then each tile's exact f32 max and its first argmax; scores
there are exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops.cuda_nms import (
    nms_suppressed_map,
    nms_tile_keys,
    pos_bits_for,
    simple_nms,
)
from yolopoint_tpu_torch.ops.topk import exact_top_k

__all__ = ["extract_keypoints", "simple_nms"]


def _keyed_tiles(heatmap, conf_thresh, nms_radius, nms_iterations, border, max_k, t):
    """Tile-aligned shapes: top-k over K1's keys -> scores, tile ids, in-tile offsets."""
    keys = nms_tile_keys(heatmap, conf_thresh, nms_radius, nms_iterations, border, t)
    key_k, tidx = exact_top_k(keys, min(max_k, keys.shape[1]))
    pos_mask = (1 << pos_bits_for(t)) - 1
    hit = key_k > 0
    scores = torch.where(hit, (key_k & ~pos_mask).view(torch.float32), 0.0)
    return scores, tidx, torch.where(hit, key_k & pos_mask, 0)


def _exact_tiles(heatmap, conf_thresh, nms_radius, nms_iterations, border, max_k, t):
    """Any shape: K6's map of the unpadded heatmap (its edges act as -inf),
    zero-padded to tile multiples -> per tile the exact max and first argmax
    -> top-k over the tile maxima."""
    B, H, W = heatmap.shape
    nmsed = nms_suppressed_map(heatmap, conf_thresh, nms_radius, nms_iterations, border)
    Hp, Wp = -(-H // t) * t, -(-W // t) * t
    padded = F.pad(nmsed, (0, Wp - W, 0, Hp - H))
    tiles = padded.reshape(B, Hp // t, t, Wp // t, t).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(B, (Hp // t) * (Wp // t), t * t)
    tile_max = tiles.amax(dim=-1)
    tile_arg = tiles.argmax(dim=-1)
    scores, tidx = exact_top_k(tile_max, min(max_k, tile_max.shape[1]))
    return scores, tidx, torch.gather(tile_arg, 1, tidx)


def extract_keypoints(
    heatmap: torch.Tensor,
    conf_thresh: float,
    nms_radius: int,
    max_k: int,
    border: int = 4,
    nms_iterations: int = 3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-size keypoints from a `(B, H, W)` probability heatmap, any H and W.

    Returns:
      points: `(B, max_k, 2)` f32 `(x, y)` pixels, score-descending.
      scores: `(B, max_k)` f32 (0 for padding).
      valid: `(B, max_k)` bool.
    """
    B, H, W = heatmap.shape
    t = max(int(nms_radius), 1)
    tiles = _keyed_tiles if H % t == 0 and W % t == 0 else _exact_tiles
    scores, tidx, sub = tiles(heatmap, conf_thresh, nms_radius, nms_iterations, border, max_k, t)
    ntw = -(-W // t)
    x = ((tidx % ntw) * t + sub % t).float()
    y = ((tidx // ntw) * t + sub // t).float()
    points = torch.stack([x, y], dim=-1)
    k = scores.shape[1]
    if k < max_k:
        points = F.pad(points, (0, 0, 0, max_k - k))
        scores = F.pad(scores, (0, max_k - k))
    return points, scores, scores > 0.0
