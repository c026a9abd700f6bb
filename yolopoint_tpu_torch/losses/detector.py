"""Keypoint detector (semi) losses.

Counterpart of `yolopoint_tpu/losses/detector.py`: BCE after a channel
softmax against the dustbin-normalized cell targets (`detector_loss`), and
per-cell softmax cross-entropy (`detector_loss_ce`); both are masked by the
valid cells and normalized by their count. Inputs are NHWC
`(B, Hc, Wc, 65)` logits and targets and `(B, Hc, Wc)` masks; the loss is
computed in f32.
"""

from __future__ import annotations

import torch


def detector_loss(semi_logits: torch.Tensor, target_cells: torch.Tensor,
                  cell_mask: torch.Tensor) -> torch.Tensor:
    """BCE between the softmaxed 65-channel logits and the soft targets.

    The probabilities are clipped to [0, 1] and the logs take eps 1e-7, as
    in the JAX package (its TPU division could return 1 + 1 ulp).
    """
    p = torch.softmax(semi_logits.float(), dim=-1).clamp(0.0, 1.0)
    eps = 1e-7
    bce = -(target_cells * torch.log(p + eps) + (1.0 - target_cells) * torch.log(1.0 - p + eps))
    per_cell = bce.sum(dim=-1) * cell_mask
    return per_cell.sum() / (cell_mask.sum() + 1e-10)


def detector_loss_ce(semi_logits: torch.Tensor, target_cells: torch.Tensor,
                     cell_mask: torch.Tensor) -> torch.Tensor:
    """Per-cell softmax cross-entropy against the soft targets (MagicPoint's
    objective; `model.superpoint.det_loss: ce`)."""
    logp = torch.log_softmax(semi_logits.float(), dim=-1)
    per_cell = -(target_cells * logp).sum(dim=-1) * cell_mask
    return per_cell.sum() / (cell_mask.sum() + 1e-10)
