"""Exact top-k, counterpart of `yolopoint_tpu/ops/topk.py:exact_top_k`.

On the GPU `torch.topk` is exact, so none of the TPU's workarounds (the
PartialReduce lowering, the denormal bias for int32 keys) carry over. The
order among equal values is unspecified, as in the JAX package; callers use
the result as a priority order where ties do not matter.
"""

from __future__ import annotations

import torch


def exact_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`(values, indices)` of the k largest entries along the last axis,
    values sorted descending. `x` may be float or (non-negative) int32."""
    return torch.topk(x, k, dim=-1, largest=True, sorted=True)
