"""Dataset sanity checks: a visual overlay and invariant checks.

Counterpart of `yolopoint_tpu/data/sanity.py`: `overlay_sample` (bit for bit
the JAX function, pure numpy) draws a sample's points, boxes and valid mask
into an array to save or show; `point_count_stats` summarizes the keypoint
counts of a dataset; `check_homography_roundtrip` warps points by sampled
homographies and back through the port's own sampler and warp, drawn from a
seeded `torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def overlay_sample(sample: Mapping[str, Any]) -> np.ndarray:
    """Render points (green), boxes (orange) and the valid mask (dimmed) onto
    the sample image; returns an HxWx3 uint8 array."""
    img = (np.asarray(sample["image"]) * 255).astype(np.uint8).copy()
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if (mask := sample.get("valid_mask")) is not None:
        img = (img * (0.4 + 0.6 * np.asarray(mask)[..., None])).astype(np.uint8)
    h, w = img.shape[:2]
    pts = np.asarray(sample.get("points", np.zeros((0, 2))))
    pmask = np.asarray(sample.get("point_mask", np.ones(len(pts), bool)))
    for (x, y) in pts[pmask].astype(int):
        if 0 <= y < h and 0 <= x < w:
            img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = (0, 255, 0)
    boxes = np.asarray(sample.get("boxes", np.zeros((0, 5))))
    bmask = np.asarray(sample.get("box_mask", np.ones(len(boxes), bool)))
    for b in boxes[bmask]:
        cx, cy, bw, bh = b[1] * w, b[2] * h, b[3] * w, b[4] * h
        x1, y1 = int(cx - bw / 2), int(cy - bh / 2)
        x2, y2 = int(cx + bw / 2), int(cy + bh / 2)
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        img[y1:y2 + 1, [x1, x2]] = (255, 128, 0)
        img[[y1, y2], x1:x2 + 1] = (255, 128, 0)
    return img


def point_count_stats(dataset, max_samples: int = 200) -> dict[str, float]:
    """Keypoint-count distribution over the first `max_samples` samples of a
    dataset (`dataset.get(i)["points"]`)."""
    counts = []
    for i in range(min(len(dataset), max_samples)):
        counts.append(len(dataset.get(i)["points"]))
    counts = np.asarray(counts)
    return {
        "mean": float(counts.mean()) if len(counts) else 0.0,
        "std": float(counts.std()) if len(counts) else 0.0,
        "min": int(counts.min()) if len(counts) else 0,
        "max": int(counts.max()) if len(counts) else 0,
        "zero_fraction": float((counts == 0).mean()) if len(counts) else 1.0,
    }


def check_homography_roundtrip(height: int = 64, width: int = 96, n: int = 20,
                               seed: int = 0) -> float:
    """Warp 32 points by each of `n` sampled homographies (pixel
    coordinates), then by its inverse; returns the largest round-trip error
    in pixels. The draws come from a CPU `torch.Generator` seeded by `seed`."""
    from yolopoint_tpu_torch.ops.geometry import homography_scaling, mat3_inverse, warp_points
    from yolopoint_tpu_torch.ops.homography import sample_homography_batch

    gen = torch.Generator().manual_seed(seed)
    hs = sample_homography_batch(gen, n)
    lo = torch.tensor([5.0, 5.0])
    hi = torch.tensor([width - 5.0, height - 5.0])
    pts = lo + torch.rand((32, 2), generator=gen) * (hi - lo)
    err = 0.0
    for i in range(n):
        hp = homography_scaling(hs[i], height, width)
        hp_inv = homography_scaling(mat3_inverse(hs[i]), height, width)
        back = warp_points(warp_points(pts, hp), hp_inv)
        err = max(err, float((back - pts).abs().max()))
    return err
