"""Keypoint heatmap <-> 65-channel cell encoding.

Counterpart of `yolopoint_tpu/ops/heatmap.py` (`space_to_depth`,
`depth_to_space`, `labels_to_cells`, `cells_to_heatmap`, `cell_valid_mask`).
Layout as in the JAX package: cell tensors are NHWC `(B, Hc, Wc, 65)`,
label maps and heatmaps `(B, H, W)`.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, cell: int) -> torch.Tensor:
    """(B, H, W) -> (B, Hc, Wc, cell*cell), channel i*cell + j (torch
    `PixelUnshuffle` order for one channel)."""
    B, H, W = x.shape
    x = x.reshape(B, H // cell, cell, W // cell, cell).permute(0, 1, 3, 2, 4)
    return x.reshape(B, H // cell, W // cell, cell * cell)


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


def labels_to_cells(labels_2d: torch.Tensor, cell: int = 8, add_dustbin: bool = True) -> torch.Tensor:
    """Binary `(B, H, W)` keypoint map -> `(B, Hc, Wc, 65)` soft cell targets:
    space-to-depth, a dustbin channel that is 1 only for empty cells, and
    per-cell normalization to a sum of 1."""
    cells = space_to_depth(labels_2d, cell)
    if not add_dustbin:
        return cells
    filled = cells.sum(dim=-1, keepdim=True)
    dustbin = torch.where(1.0 - filled < 1.0, 0.0, 1.0 - filled)
    cells = torch.cat([cells, dustbin], dim=-1)
    return cells / cells.sum(dim=-1, keepdim=True)


def cell_valid_mask(mask_2d: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """`(B, H, W)` {0, 1} mask -> `(B, Hc, Wc)`: a cell is valid iff all of
    its pixels are."""
    return space_to_depth(mask_2d, cell).prod(dim=-1)
