"""Random homographies and the 4-point perspective solve.

Counterpart of `perspective_transform`, `perspective_transform_np` (with
its `_perspective_system`, host-side numpy, for the evaluation's RANSAC),
`sample_homography_np` and `sample_homography_batch` in
`yolopoint_tpu/ops/homography.py`: a SuperPoint-style random patch
homography. `sample_homography_batch` draws a batch in normalized `[-1, 1]`
coordinates from a `torch.Generator`, so its numbers differ from
`jax.random`'s; the distribution is the same (truncated-normal perspective
and scale, a uniform choice among the border-valid scale and rotation
candidates, uniform translation). `sample_homography_np` is the host
sampler of the host-warp path, a numpy `Generator` per homography: the same
seed gives the JAX package's float64 matrices.
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


def _truncnorm(rng: np.random.Generator, scale: float, size, bound: float = 2.0) -> np.ndarray:
    """Normal truncated to `[-bound, bound]` sigma by rejection, times `scale`."""
    out = rng.standard_normal(size)
    bad = np.abs(out) > bound
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > bound
    return out * scale


def sample_homography_np(
    shape,
    shift: float = 0.0,
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
    crop_pts: dict | None = None,
    seed: int | None = None,
):
    """One random homography in float64, drawn from `default_rng(seed)`.

    It maps output (warped patch) points to input (original patch) points:
    the patch, a `patch_ratio` centred crop of the unit square, perturbed by
    perspective, scale, translation and rotation, keeping only border-valid
    scale and rotation candidates unless `allow_artifacts`. `shape` is the
    `(H, W)` the corners are scaled by before `shift` (`(2, 2)` and `-1`
    give normalized `[-1, 1]` homographies). With `crop_pts` (`tl`,
    `H_crop`, `W_crop`, `HW_full`) it returns `(H, H_big)`, `H_big` mapping
    the full frame.
    """
    rng = np.random.default_rng(seed)
    pts1 = np.stack([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]], axis=0)
    margin = (1 - patch_ratio) / 2
    pts2 = margin + np.array(
        [[0, 0], [0, patch_ratio], [patch_ratio, patch_ratio], [patch_ratio, 0]],
        dtype=np.float64)

    if perspective:
        if not allow_artifacts:
            perspective_amplitude_x = min(perspective_amplitude_x, margin)
            perspective_amplitude_y = min(perspective_amplitude_y, margin)
        persp_disp = _truncnorm(rng, perspective_amplitude_y / 2, 1)
        h_left = _truncnorm(rng, perspective_amplitude_x / 2, 1)
        h_right = _truncnorm(rng, perspective_amplitude_x / 2, 1)
        pts2 += np.array([[h_left, persp_disp], [h_left, -persp_disp],
                          [h_right, persp_disp], [h_right, -persp_disp]]).squeeze(-1)

    if scaling:
        scales = np.concatenate([[1.0], 1.0 + _truncnorm(rng, scaling_amplitude / 2, n_scales)])
        center = pts2.mean(axis=0, keepdims=True)
        scaled = (pts2 - center)[None] * scales[:, None, None] + center
        if allow_artifacts:
            valid = np.arange(n_scales)
        else:
            valid = np.where(((scaled >= 0.0) & (scaled < 1.0)).all(axis=(1, 2)))[0]
        # candidate 0 where none is valid, as the device sampler (`_pick_valid`)
        # takes it (a config that sets no parameters: patch_ratio 1 leaves the
        # corners on the unit square's edge); the JAX package's numpy sampler
        # raises there
        pts2 = scaled[valid[rng.integers(len(valid))]] if len(valid) else scaled[0]

    if translation:
        t_min, t_max = pts2.min(axis=0), (1 - pts2).min(axis=0)
        if allow_artifacts:
            t_min = t_min + translation_overflow
            t_max = t_max + translation_overflow
        pts2 += np.array([rng.uniform(-t_min[0], t_max[0]), rng.uniform(-t_min[1], t_max[1])])

    if rotation:
        angles = np.concatenate([np.linspace(-max_angle, max_angle, n_angles), [0.0]])
        center = pts2.mean(axis=0, keepdims=True)
        rot = np.stack([np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)],
                       axis=1).reshape(-1, 2, 2)
        rotated = (pts2 - center)[None] @ rot + center
        if allow_artifacts:
            valid = np.arange(n_angles)
        else:
            valid = np.where(((rotated >= 0.0) & (rotated < 1.0)).all(axis=(1, 2)))[0]
        pts2 = rotated[valid[rng.integers(len(valid))]] if len(valid) else rotated[0]

    wh = np.asarray(shape, np.float64)[::-1]
    pts1_px = pts1 * wh[None, :] + shift
    pts2_px = pts2 * wh[None, :] + shift
    homography = perspective_transform_np(pts1_px, pts2_px)

    if crop_pts is not None:
        # the patch homography composed with the full frame -> crop map
        W, Hc = crop_pts["W_crop"], crop_pts["H_crop"]
        tl = np.array(crop_pts["tl"], np.float64)
        corners_yx = np.array([tl, tl + [Hc, 0], tl + [Hc, W], tl + [0, W]], np.float64)
        corners_norm = corners_yx / np.asarray(crop_pts["HW_full"], np.float64) * 2 - 1
        H_32_1 = perspective_transform_np(pts1_px, corners_norm)
        pts42 = (H_32_1 @ np.concatenate([pts2_px, np.ones((4, 1))], axis=1).T).T
        pts42 = pts42[:, :2] / pts42[:, 2:]
        homography_big = perspective_transform_np(corners_norm[:, ::-1].copy(),
                                                  pts42[:, ::-1].copy())
        return homography, homography_big
    return homography


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
