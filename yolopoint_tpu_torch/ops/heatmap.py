"""Keypoint heatmap from the 65-channel cell logits.

Counterpart of `yolopoint_tpu/ops/heatmap.py` (`depth_to_space`,
`cells_to_heatmap`). Layout as in the JAX package: cell tensors are NHWC
`(B, Hc, Wc, 65)`, heatmaps `(B, H, W)`.
"""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, cell: int) -> torch.Tensor:
    """(B, Hc, Wc, cell*cell) -> (B, Hc*cell, Wc*cell); channel i*cell + j
    lands at row offset i, column offset j (torch `PixelShuffle` order)."""
    B, Hc, Wc, _ = x.shape
    x = x.reshape(B, Hc, Wc, cell, cell).permute(0, 1, 3, 2, 4)
    return x.reshape(B, Hc * cell, Wc * cell)


def cells_to_heatmap(
    semi: torch.Tensor, cell: int = 8, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Channel softmax -> drop the dustbin -> depth-to-space.

    Args:
      semi: `(B, Hc, Wc, 65)` raw detector logits. The softmax runs in the
        input precision.
      dtype: dtype of the returned heatmap (`torch.bfloat16` on the serving
        fast path); default keeps the softmax dtype.

    Returns:
      `(B, Hc*cell, Wc*cell)` heatmap.
    """
    nodust = torch.softmax(semi, dim=-1)[..., :-1]
    if dtype is not None:
        nodust = nodust.to(dtype)
    return depth_to_space(nodust, cell)
