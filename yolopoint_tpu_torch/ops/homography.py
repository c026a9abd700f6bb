"""Random homographies and the 4-point perspective solve.

Counterpart of `perspective_transform`, `perspective_transform_np` (with
its `_perspective_system`, host-side numpy, for the evaluation's RANSAC) and
`sample_homography_batch` in `yolopoint_tpu/ops/homography.py`: a SuperPoint-style random patch
homography, batched, in normalized `[-1, 1]` coordinates. The draws come
from a `torch.Generator`, so the numbers differ from `jax.random`'s; the
distribution is the same (truncated-normal perspective and scale, a
uniform choice among the border-valid scale and rotation candidates,
uniform translation).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def perspective_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """`(..., 3, 3)` homographies with `H[2, 2] = 1` mapping the 4 `src`
    points onto the 4 `dst` points (`(..., 4, 2)` each): the 8x8 DLT system,
    solved batched."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)
    b = torch.cat([u, v], dim=-1)[..., None]
    h = torch.linalg.solve(A, b)[..., 0]
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))


def _perspective_system(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 8x8 DLT system `A h = b` for `H @ src ~ dst`, `(..., 4, 2)` quads."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = np.zeros_like(x), np.ones_like(x)
    rows_u = np.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], axis=-1)
    rows_v = np.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], axis=-1)
    A = np.concatenate([rows_u, rows_v], axis=-2)
    b = np.concatenate([u, v], axis=-1)[..., None]
    return A, b


def perspective_transform_np(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Host-side 4-point homography solve in float64, `H[2, 2] = 1`."""
    A, b = _perspective_system(np.asarray(src, np.float64), np.asarray(dst, np.float64))
    h = np.linalg.solve(A, b)[..., 0]
    return np.concatenate([h, np.ones(h.shape[:-1] + (1,))], axis=-1).reshape(
        h.shape[:-1] + (3, 3))


def truncated_normal(gen: torch.Generator, shape, bound: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to `[-bound, bound]`, by inverting the CDF
    of a uniform draw between the two tails' CDF values."""
    lo, hi = math.erf(-bound / math.sqrt(2.0)), math.erf(bound / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo
    return (math.sqrt(2.0) * torch.erfinv(u)).clamp(-bound, bound)


def _pick_valid(gen: torch.Generator, candidates: torch.Tensor, allow_artifacts: bool):
    """Per row, a uniform choice among the candidates whose 4 corners stay
    in `[0, 1)` (Gumbel-max over the valid ones; candidate 0 if none is)."""
    ok = ((candidates >= 0.0) & (candidates < 1.0)).all(dim=-1).all(dim=-1)  # (B, K)
    if allow_artifacts:
        ok = torch.ones_like(ok)
    u = torch.rand(ok.shape, generator=gen, device=gen.device).clamp(min=1e-20)
    g = -torch.log(-torch.log(u))
    idx = torch.where(ok, g, -math.inf).argmax(dim=1)
    return candidates[torch.arange(candidates.shape[0], device=candidates.device), idx]


def sample_homography_batch(
    gen: torch.Generator,
    batch: int,
    perspective: bool = True,
    scaling: bool = True,
    rotation: bool = True,
    translation: bool = True,
    n_scales: int = 5,
    n_angles: int = 25,
    scaling_amplitude: float = 0.1,
    perspective_amplitude_x: float = 0.1,
    perspective_amplitude_y: float = 0.1,
    patch_ratio: float = 1.0,
    max_angle: float = math.pi / 2,
    allow_artifacts: bool = False,
    translation_overflow: float = 0.0,
) -> torch.Tensor:
    """`(batch, 3, 3)` f32 random homographies in normalized coords, on the
    generator's device; they map output (warped patch) points to input
    points. Arguments as in the JAX package's YAML
    (`data.augmentation.homographic.params`)."""
    dev = gen.device
    margin = (1 - patch_ratio) / 2
    pts1 = torch.tensor([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], device=dev)
    pts2 = margin + torch.tensor(
        [[0, 0], [0, patch_ratio], [patch_ratio, patch_ratio], [patch_ratio, 0]],
        dtype=torch.float32, device=dev).expand(batch, 4, 2)

    if perspective:
        ax = perspective_amplitude_x if allow_artifacts else min(perspective_amplitude_x, margin)
        ay = perspective_amplitude_y if allow_artifacts else min(perspective_amplitude_y, margin)
        tn = truncated_normal(gen, (batch, 3))
        persp, h_left, h_right = tn[:, 0] * (ay / 2), tn[:, 1] * (ax / 2), tn[:, 2] * (ax / 2)
        disp = torch.stack([
            torch.stack([h_left, persp], -1), torch.stack([h_left, -persp], -1),
            torch.stack([h_right, persp], -1), torch.stack([h_right, -persp], -1),
        ], dim=1)
        pts2 = pts2 + disp

    if scaling:
        tn = truncated_normal(gen, (batch, n_scales))
        scales = torch.cat([torch.ones(batch, 1, device=dev), 1.0 + tn * (scaling_amplitude / 2)], 1)
        center = pts2.mean(dim=1, keepdim=True)
        scaled = (pts2 - center)[:, None] * scales[:, :, None, None] + center[:, None]
        pts2 = _pick_valid(gen, scaled, allow_artifacts)

    if translation:
        t_min = pts2.min(dim=1).values
        t_max = (1 - pts2).min(dim=1).values
        if allow_artifacts:
            t_min = t_min + translation_overflow
            t_max = t_max + translation_overflow
        u = torch.rand((batch, 2), generator=gen, device=dev)
        pts2 = pts2 + (-t_min + u * (t_max + t_min))[:, None, :]

    if rotation:
        angles = torch.cat([torch.linspace(-max_angle, max_angle, n_angles, device=dev),
                            torch.zeros(1, device=dev)])
        cos, sin = torch.cos(angles), torch.sin(angles)
        rot = torch.stack([cos, -sin, sin, cos], dim=1).reshape(-1, 2, 2)
        center = pts2.mean(dim=1, keepdim=True)
        rotated = torch.einsum("bnd,kde->bkne", pts2 - center, rot) + center[:, None]
        pts2 = _pick_valid(gen, rotated, allow_artifacts)

    src = (pts1 * 2.0 - 1.0).expand(batch, 4, 2)
    return perspective_transform(src, pts2 * 2.0 - 1.0)
