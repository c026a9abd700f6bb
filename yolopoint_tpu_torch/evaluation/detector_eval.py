"""Keypoint detector metrics: repeatability + localization error.

Numpy copy of `yolopoint_tpu/evaluation/detector_eval.py`. Point sets
come from the device pipeline as `(max_k, 2/3)` arrays + masks; metric
math is numpy.
"""

from __future__ import annotations

import numpy as np


def homography_scaling_np(H: np.ndarray, height: float, width: float) -> np.ndarray:
    """Conjugate a normalized-coords homography into pixel coords (numpy twin
    of `ops.geometry.homography_scaling`)."""
    trans = np.array([[2.0 / width, 0, -1], [0, 2.0 / height, -1], [0, 0, 1.0]])
    return np.linalg.inv(trans) @ H @ trans


def warp_keypoints_np(points: np.ndarray, H: np.ndarray, shape_hw, scale: bool = True) -> np.ndarray:
    """Warp `(N, 2)` pixel points by H (optionally conjugating from the
    normalized convention). Parity: `warp_keypoints`
    (`detector_evaluation.py:28-41`)."""
    if scale:
        H = homography_scaling_np(H, *shape_hw[:2])
    pts = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    w = pts @ H.T
    return w[:, :2] / w[:, 2:]


def _filter_in_bounds(points: np.ndarray, shape_hw, margin: int = 2) -> np.ndarray:
    ok = (
        (points[:, 0] >= margin) & (points[:, 0] < shape_hw[1] - margin)
        & (points[:, 1] >= margin) & (points[:, 1] < shape_hw[0] - margin)
    )
    return points[ok]


def _select_k_best(points: np.ndarray, k: int) -> np.ndarray:
    """Top-k by prob (3rd column), strip prob (`detector_evaluation.py:82-90`)."""
    if points.shape[1] > 2:
        order = points[:, 2].argsort()
        start = min(k, points.shape[0])
        return points[order][-start:, :2]
    return points


def compute_repeatability(
    keypoints: np.ndarray,
    warped_keypoints: np.ndarray,
    homography: np.ndarray,
    inv_homography: np.ndarray,
    shape_hw,
    keep_k_points: int = 300,
    distance_thresh: float = 3.0,
) -> tuple[float, float]:
    """Symmetric repeatability + localization error between two views.

    Args:
      keypoints / warped_keypoints: `(N, 3)` `[x, y, prob]` (valid rows only).
      homography / inv_homography: normalized-coords H linking the views.
      shape_hw: image (H, W).

    Returns:
      (repeatability in [0,1], localization_err or -1).
    """
    kp = np.asarray(keypoints, np.float64).copy()
    wkp = np.asarray(warped_keypoints, np.float64).copy()

    # keep warped detections whose back-warp stays in frame (ref: keep_true_keypoints)
    if len(wkp):
        back = warp_keypoints_np(wkp[:, :2], homography, shape_hw)
        ok = (
            (back[:, 0] >= 2) & (back[:, 0] < shape_hw[1] - 2)
            & (back[:, 1] >= 2) & (back[:, 1] < shape_hw[0] - 2)
        )
        wkp = wkp[ok]

    # warp base detections into the warped frame
    if len(kp):
        kp[:, :2] = warp_keypoints_np(kp[:, :2], inv_homography, shape_hw)
        kp = _filter_in_bounds(kp, shape_hw)

    true_warped = _select_k_best(kp, keep_k_points)
    warped = _select_k_best(wkp, keep_k_points)

    N1, N2 = len(true_warped), len(warped)
    if N1 + N2 == 0:
        return 0.0, -1.0
    if N1 == 0 or N2 == 0:
        return 0.0, -1.0

    norm = np.linalg.norm(true_warped[:, None] - warped[None], axis=2)
    min1 = norm.min(axis=1)
    min2 = norm.min(axis=0)
    count1 = int((min1 <= distance_thresh).sum())
    count2 = int((min2 <= distance_thresh).sum())
    repeatability = (count1 + count2) / (N1 + N2)
    if count1 + count2 > 0:
        loc_err = (
            min1[min1 <= distance_thresh].sum() + min2[min2 <= distance_thresh].sum()
        ) / (count1 + count2)
    else:
        loc_err = -1.0
    return float(repeatability), float(loc_err)


def batch_precision_recall(pred_heatmap: np.ndarray, labels_2d: np.ndarray) -> dict:
    """Soft precision/recall of heatmaps vs binary label maps
    (`detector_evaluation.py:9-25`)."""
    eps = 1e-6
    inter = (pred_heatmap * labels_2d).sum(axis=(-2, -1))
    precision = inter / (pred_heatmap.sum(axis=(-2, -1)) + eps)
    recall = inter / (labels_2d.sum(axis=(-2, -1)) + eps)
    return {"precision": precision, "recall": recall}
