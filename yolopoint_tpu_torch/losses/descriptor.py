"""Descriptor losses between the two views: sparse contrastive and InfoNCE.

Counterpart of `yolopoint_tpu/losses/descriptor.py` (`descriptor_loss_sparse`,
`infonce_loss` and their sampling machinery). Every image contributes a
fixed number of cell coordinates, weighted by the warped view's cell
validity; negatives are shared by groups of 128 queries.

Randomness is split from the arithmetic: `draw_descriptor_samples` draws
the cell coordinates and the negative indices from a `torch.Generator`;
the losses take them as `samples`.

Gradient note: `_bilinear_desc` gathers; its backward is a scatter-add,
whose float sums run in a nondeterministic order on CUDA.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops.geometry import homography_scaling, warp_image, warp_points
from yolopoint_tpu_torch.ops.heatmap import cell_valid_mask
from yolopoint_tpu_torch.ops.sampling import grid_sample

NEG_GROUP = 128


def draw_descriptor_samples(gen: torch.Generator, batch: int, hc: int, wc: int,
                            num_samples: int, num_neg: int, group: int = NEG_GROUP) -> dict:
    """`uv_a` `(B, N, 2)` integer cell coords `(x, y)` as f32, uniform over the
    `(hc, wc)` map, and `neg_idx` `(G, num_neg)` rows of the flat batch pool
    (`G` = `B * N` rounded up to `group`, over `group`)."""
    dev = gen.device
    xs = torch.randint(0, wc, (batch, num_samples), generator=gen, device=dev)
    ys = torch.randint(0, hc, (batch, num_samples), generator=gen, device=dev)
    n = batch * num_samples
    G = -(-n // group)
    neg = torch.randint(0, n, (G, num_neg), generator=gen, device=dev)
    return {"uv_a": torch.stack([xs, ys], dim=-1).float(), "neg_idx": neg}


def _bilinear_desc(desc: torch.Tensor, coords_cell: torch.Tensor) -> torch.Tensor:
    """Sample `(B, Hc, Wc, D)` maps at `(B, N, 2)` cell coords, no renorm: the
    reference normalizes by `(Wc, Hc)` and samples align-corners, i.e. at
    `x (Wc - 1) / Wc`."""
    B, Hc, Wc, D = desc.shape
    sx = coords_cell[..., 0] * (Wc - 1) / Wc
    sy = coords_cell[..., 1] * (Hc - 1) / Hc
    return grid_sample(desc, torch.stack([sx, sy], dim=-1))


def _matched_coords(uv_a, desc_shape, valid_mask_warp, inv_homographies, cell_size: int):
    """`(uv_b (B, N, 2) matched warped cell coords, rounded; weight (B, N))`.

    The warped view's valid mask is pooled to cells and then warped to the
    base frame at cell resolution (nearest): the (B, Hc, Wc, 1) warp that
    the JAX package ran as its resident Pallas kernel (K5).
    """
    B, Hc, Wc, _ = desc_shape
    m_cells_w = cell_valid_mask(valid_mask_warp, cell_size)
    m_cells = warp_image(m_cells_w[..., None].contiguous(), inv_homographies, mode="nearest")[..., 0]
    ax, ay = uv_a[..., 0].long(), uv_a[..., 1].long()
    w = m_cells[torch.arange(B, device=uv_a.device)[:, None], ay, ax]
    uv_b = torch.round(warp_points(uv_a, homography_scaling(inv_homographies, Hc, Wc)))
    inside = ((uv_b[..., 0] >= 0) & (uv_b[..., 0] <= Wc - 1)
              & (uv_b[..., 1] >= 0) & (uv_b[..., 1] <= Hc - 1))
    return uv_b, w * inside.to(w.dtype)


def _group_negative_products(neg_idx, d_a_flat, d_b_flat, w_flat, group: int = NEG_GROUP):
    """Negative dot products with one negative set per group of `group`
    queries: `(neg_prod (Npad, K), pair_w (Npad, K), padded query weights)`;
    self-pairs and invalid pairs weigh 0."""
    N, D = d_a_flat.shape
    G, K = neg_idx.shape
    Npad = G * group
    pad = Npad - N
    w_q = torch.nn.functional.pad(w_flat, (0, pad)) if pad else w_flat
    if pad:
        d_a_flat = torch.nn.functional.pad(d_a_flat, (0, 0, 0, pad))
    d_neg = d_b_flat[neg_idx]                                        # (G, K, D)
    neg_prod = torch.bmm(d_a_flat.reshape(G, group, D), d_neg.transpose(1, 2))
    q_idx = torch.arange(Npad, device=neg_idx.device).reshape(G, group, 1)
    not_self = (neg_idx[:, None, :] != q_idx).to(w_flat.dtype)
    pair_w = w_q.reshape(G, group, 1) * w_flat[neg_idx][:, None, :] * not_self
    return neg_prod.reshape(Npad, K), pair_w.reshape(Npad, K), w_q


def _views(descriptors, descriptors_warped, valid_mask_warp, inv_homographies, samples, cell_size):
    uv_a = samples["uv_a"]
    uv_b, w = _matched_coords(uv_a, descriptors.shape, valid_mask_warp, inv_homographies,
                              cell_size)
    return _bilinear_desc(descriptors, uv_a), _bilinear_desc(descriptors_warped, uv_b), w


def descriptor_loss_sparse(
    descriptors: torch.Tensor,
    descriptors_warped: torch.Tensor,
    valid_mask_warp: torch.Tensor,
    inv_homographies: torch.Tensor,
    samples: dict,
    cell_size: int = 8,
) -> torch.Tensor:
    """Pixel-wise contrastive loss: positives `clamp(1 - d.d+)` as a masked
    mean; negatives `clamp(d.d- - 0.1)` summed and normalized by the count of
    hard negatives + 1. Maps are NHWC `(B, Hc, Wc, D)`; `samples` from
    `draw_descriptor_samples`."""
    B, Hc, Wc, D = descriptors.shape
    d_a, d_b, w = _views(descriptors, descriptors_warped, valid_mask_warp, inv_homographies,
                         samples, cell_size)
    w_flat = w.reshape(-1)
    pos_hinge = (1.0 - (d_a * d_b).sum(-1).reshape(-1)).clamp(min=0.0) * w_flat
    match_loss = pos_hinge.sum() / w_flat.sum().clamp(min=1.0)
    neg_prod, pair_w, _ = _group_negative_products(
        samples["neg_idx"], d_a.reshape(-1, D), d_b.reshape(-1, D), w_flat)
    neg_hinge = (neg_prod - 0.1).clamp(min=0.0) * pair_w
    num_hard = torch.count_nonzero(neg_hinge).to(torch.float32)
    return match_loss + neg_hinge.sum() / (num_hard + 1.0)


def infonce_loss(
    descriptors: torch.Tensor,
    descriptors_warped: torch.Tensor,
    valid_mask_warp: torch.Tensor,
    inv_homographies: torch.Tensor,
    samples: dict,
    cell_size: int = 8,
    tau: float = 0.07,
) -> torch.Tensor:
    """InfoNCE over [positive, negatives] logits at temperature `tau`; self-
    and invalid pairs are masked out of the softmax."""
    B, Hc, Wc, D = descriptors.shape
    d_a, d_b, w = _views(descriptors, descriptors_warped, valid_mask_warp, inv_homographies,
                         samples, cell_size)
    d_a_flat, d_b_flat, w_flat = d_a.reshape(-1, D), d_b.reshape(-1, D), w.reshape(-1)
    N = w_flat.shape[0]
    pos = (d_a_flat * d_b_flat).sum(-1)
    neg_prod, pair_w, w_q = _group_negative_products(samples["neg_idx"], d_a_flat, d_b_flat,
                                                     w_flat)
    Npad = neg_prod.shape[0]
    pos_pad = torch.nn.functional.pad(pos, (0, Npad - N)) if Npad > N else pos
    neg_masked = torch.where(pair_w > 0.0, neg_prod, -1e9)
    logits = torch.cat([pos_pad[:, None], neg_masked], dim=1) / tau
    logp = torch.log_softmax(logits, dim=1)[:, 0]
    return -(logp * w_q).sum() / w_flat.sum().clamp(min=1.0)
