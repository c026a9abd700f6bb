"""Exact top-k, counterpart of `yolopoint_tpu/ops/topk.py:exact_top_k`.

On the GPU a sort is exact, so none of the TPU's workarounds (the
PartialReduce lowering, the denormal bias for int32 keys) carry over.
Equal values come lowest index first, as `jax.lax.top_k` orders them on the
CPU: box NMS takes the order as its priority (bf16-decoded scores tie often
among the val protocol's multi-label candidates, and the tie order decides
which box suppresses which), so the card and the CPU must agree on it.
"""

from __future__ import annotations

import torch


def exact_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`(values, indices)` of the k largest entries along the last axis,
    values sorted descending, ties lowest index first. `x` may be float or
    int32."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
