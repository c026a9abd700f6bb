"""Mutual nearest-neighbour descriptor matching.

Counterpart of `yolopoint_tpu/ops/matching.py`: one f32 matmul and two
reductions, on the device of its inputs (the keypoint-plus-match step of
the JAX package's `bench.py`).
"""

from __future__ import annotations

import torch


def mutual_nearest_neighbor(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor | None = None,
    valid_b: torch.Tensor | None = None,
    nn_thresh: float = 0.7,
) -> dict[str, torch.Tensor]:
    """Two-way nearest-neighbour matching of unit descriptors.

    The distance is `sqrt(2 - 2 a.b)`; a pair (i, j) matches iff j is the
    nearest of i, i the nearest of j, and the distance is below `nn_thresh`.

    Args:
      desc_a: `(N, D)` unit descriptors.
      desc_b: `(M, D)` unit descriptors.
      valid_a, valid_b: optional bool masks of padded entries.
      nn_thresh: distance threshold.

    Returns:
      `indices` `(N,)` int32 (the match in B of each A point), `distance`
      `(N,)` and `valid` `(N,)` bool (mutual, under the threshold, and valid).
    """
    sim = desc_a.float() @ desc_b.float().T
    dmat = torch.sqrt(torch.clamp(2.0 - 2.0 * torch.clamp(sim, -1.0, 1.0), min=0.0))
    inf = torch.tensor(float("inf"), dtype=dmat.dtype, device=dmat.device)
    if valid_a is not None:
        dmat = torch.where(valid_a[:, None], dmat, inf)
    if valid_b is not None:
        dmat = torch.where(valid_b[None, :], dmat, inf)

    dist_ab, idx_ab = torch.min(dmat, dim=1)  # first index among equal values
    idx_ba = torch.argmin(dmat, dim=0)

    mutual = idx_ba[idx_ab] == torch.arange(desc_a.shape[0], device=dmat.device)
    ok = mutual & (dist_ab < nn_thresh) & torch.isfinite(dist_ab)
    if valid_a is not None:
        ok = ok & valid_a
    return {"indices": idx_ab.to(torch.int32), "distance": dist_ab, "valid": ok}
