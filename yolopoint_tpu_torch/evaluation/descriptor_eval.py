"""Descriptor metrics: homography estimation correctness + matching score.

Numpy copy of `yolopoint_tpu/evaluation/descriptor_eval.py`:
cross-checked L2 matching of top-K descriptors, RANSAC homography, corner
error vs ground truth. Matching uses the framework's mutual-NN semantics
(numpy here — eval-only). The homography comes from the numpy DLT +
RANSAC, on every host: the port does not use OpenCV, so it computes what
the JAX package computes where OpenCV is not installed (the JAX package
takes `cv2.findHomography` where it is).
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.evaluation.detector_eval import homography_scaling_np
from yolopoint_tpu_torch.ops.homography import perspective_transform_np


def mutual_match_np(desc1: np.ndarray, desc2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Cross-checked NN matching (cv2.BFMatcher(crossCheck=True) semantics):
    pairs (i, j) where j = argmin_j d(i,j) and i = argmin_i d(i,j).

    Returns (idx_pairs (L, 2), distances (L,)), sorted by distance.
    """
    if len(desc1) == 0 or len(desc2) == 0:
        return np.zeros((0, 2), int), np.zeros((0,))
    d = np.linalg.norm(desc1[:, None] - desc2[None], axis=2)
    ab = d.argmin(axis=1)
    ba = d.argmin(axis=0)
    keep = ba[ab] == np.arange(len(desc1))
    i = np.flatnonzero(keep)
    j = ab[keep]
    dist = d[i, j]
    order = dist.argsort()
    return np.stack([i[order], j[order]], axis=1), dist[order]


def ransac_homography_np(
    src: np.ndarray, dst: np.ndarray, thresh: float = 3.0, iters: int = 2000, seed: int = 0
) -> tuple[np.ndarray | None, np.ndarray]:
    """Minimal 4-point DLT RANSAC (the JAX package's fallback for
    `cv2.findHomography`)."""
    n = len(src)
    if n < 4:
        return None, np.zeros(0, int)
    rng = np.random.default_rng(seed)
    best_inliers = np.zeros(n, bool)
    for _ in range(iters):
        idx = rng.choice(n, 4, replace=False)
        try:
            H = perspective_transform_np(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        pts = np.concatenate([src, np.ones((n, 1))], axis=1) @ H.T
        denom = pts[:, 2:]
        ok = np.abs(denom[:, 0]) > 1e-9
        proj = np.zeros_like(src)
        proj[ok] = pts[ok, :2] / denom[ok]
        err = np.linalg.norm(proj - dst, axis=1)
        inliers = ok & (err < thresh)
        if inliers.sum() > best_inliers.sum():
            best_inliers = inliers
    if best_inliers.sum() < 4:
        return None, np.zeros(0, int)
    # least-squares refit on inliers via normalized DLT
    A = []
    for (x, y), (u, v) in zip(src[best_inliers], dst[best_inliers]):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    H /= H[2, 2]
    return H, best_inliers.astype(int)


def estimate_homography(src: np.ndarray, dst: np.ndarray, thresh: float = 3.0):
    """The numpy RANSAC homography and its inlier labels."""
    return ransac_homography_np(src, dst, thresh)


def compute_homography_correctness(
    keypoints: np.ndarray,
    warped_keypoints: np.ndarray,
    desc: np.ndarray,
    warped_desc: np.ndarray,
    inv_homography: np.ndarray,
    shape_hw,
    keep_k_points: int = 300,
    correctness_thresh: float = 3.0,
) -> dict:
    """Estimate H from descriptor matches; correct if the mean error of the 4
    warped corners vs ground truth is <= thresh.

    Args:
      keypoints / warped_keypoints: `(N, >=2)` `[x, y, ...]` conf-sorted desc.
      desc / warped_desc: `(N, D)` unit descriptors aligned with points.
      inv_homography: normalized-coords ground-truth inverse homography.

    Returns dict with `correctness`, `mean_dist`, `inliers`, `matches`,
    `matching_score` = 2*inliers/(N1+N2).
    """
    kp = np.asarray(keypoints)[:keep_k_points, :2]
    wkp = np.asarray(warped_keypoints)[:keep_k_points, :2]
    d1 = np.asarray(desc)[:keep_k_points]
    d2 = np.asarray(warped_desc)[:keep_k_points]

    pairs, dist = mutual_match_np(d1, d2)
    m_src = kp[pairs[:, 0]] if len(pairs) else np.zeros((0, 2))
    m_dst = wkp[pairs[:, 1]] if len(pairs) else np.zeros((0, 2))

    result = {
        "correctness": 0.0,
        "mean_dist": None,
        "inliers": np.zeros(0, int),
        "matches": np.hstack([m_src, m_dst]) if len(pairs) else np.zeros((0, 4)),
        # guard: all-identical descriptors give dist.max()==0 -> NaN mscores
        "mscores": dist / dist.max() if len(dist) and dist.max() > 0 else np.zeros_like(dist),
        "matching_score": 0.0,
        "homography": np.eye(3),
    }
    if len(m_src) < 4:
        return result

    H, inliers = estimate_homography(m_src, m_dst, correctness_thresh)
    if H is None:
        return result

    h, w = shape_hw[0], shape_hw[1]
    corners = np.array([[0, 0], [0, h - 1], [w - 1, 0], [w - 1, h - 1]], np.float64)
    corners_h = np.concatenate([corners, np.ones((4, 1))], axis=1)
    real_H = homography_scaling_np(np.asarray(inv_homography, np.float64), h, w)
    real_c = corners_h @ real_H.T
    real_c = real_c[:, :2] / real_c[:, 2:]
    est_c = corners_h @ np.asarray(H, np.float64).T
    est_c = est_c[:, :2] / est_c[:, 2:]
    mean_dist = float(np.linalg.norm(real_c - est_c, axis=1).mean())

    n_inl = int(np.asarray(inliers).sum()) if len(inliers) else 0
    result.update(
        correctness=float(mean_dist <= correctness_thresh),
        mean_dist=mean_dist,
        inliers=np.asarray(inliers),
        matching_score=2.0 * n_inl / max(len(kp) + len(wkp), 1),
        homography=H,
    )
    return result
