"""OpenCV's RANSAC homography, as `cv2.findHomography(src, dst, cv2.RANSAC)`
of OpenCV 5.0 computes it, without OpenCV.

The JAX package estimates the HPatches and validation homographies with
`cv2.findHomography(src.astype(f32), dst.astype(f32), cv2.RANSAC)` wherever
OpenCV is installed (`yolopoint_tpu/evaluation/descriptor_eval.py`). The port
imports no OpenCV, so it carries that estimate here, in two forms that compute
the same numbers: `find_homography_ransac`, numpy, for a run on the CPU, and
`find_homography_ransac_compiled`, the same steps in compiled host code
(`yp_find_homography` in `ops/csrc/host_image.cpp`) for a run on a GPU.
`find_homography_for(device)` picks one.

The steps, found against `cv2` 5.0.0 by seeded sweeps
(`tests/test_torch_ransac.py`):
1. The points go to f32. Four points are fitted directly (a mask of ones).
2. OpenCV's classic RANSAC registrator: `cv::RNG` seeded with 2^64 - 1
   (multiply-with-carry, `uniform(0, n) = next() % n`); four distinct indices
   a draw; a draw is kept when its last point is not collinear with two of the
   others in either set (`FLT_EPSILON`) and the four triples' orientation
   signs agree between the sets, else the next draw is taken (10000 draws at
   most); the normalised DLT (centroids, mean absolute deviations, a 9x9
   `L^T L` accumulated point by point, its eigenvector of the smallest
   eigenvalue by OpenCV's Jacobi, then scaled to `H[2,2] = 1`); the error
   `dx^2 + dy^2` in f32, an inlier where it is at most `3^2`; the best model
   replaced only by more than `max(best, 3)` inliers, and the iteration count
   cut by `RANSACUpdateNumIters(0.995, outlier share, 4, n)`, from 2000.
3. The DLT refitted on the inliers, then refined on them by OpenCV 5's
   Levenberg-Marquardt on the nine entries of H (Nielsen's damping update,
   `lambda` from 1e-4, the diagonal clamped to [1e-6, 1e32], at most 10
   iterations, stopped by a relative energy change or a squared step under
   1e-6), then scaled to `H[2,2] = 1`.
4. The mask recomputed on all points from the final H, by the f32 test of
   step 2.
No model is `(None, zeros)`. Steps 1, 2 and 4 give `cv2`'s masks; step 3's H
agrees with `cv2`'s to ~1e-7 of its largest entry (OpenCV's solver is not
copied to the last bit), which moves the HPatches corners by far less than
a pixel.

Every sum is taken in the C++ loop's order (`np.cumsum` along the points),
no product is fused and no libm function but `pow` and `log` (in the
iteration count, rounded to an integer) is called, so the numpy and compiled
forms give the same bits.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import numpy as np
import torch

_F32 = np.float32
_F64 = np.float64
FLT_EPSILON = float(np.finfo(np.float32).eps)
DBL_EPSILON = float(np.finfo(np.float64).eps)
DBL_MIN = float(np.finfo(np.float64).tiny)
# OpenCV's default reprojection threshold: the JAX call passes none
THRESHOLD = 3.0
MAX_ATTEMPTS = 10000
LM_MAX_ITERS = 10
# the triples of the orientation test (`HomographyEstimatorCallback::checkSubset`)
_TRIPLES = ((0, 1, 2), (1, 2, 3), (0, 2, 3), (0, 1, 3))


class CvRng:
    """`cv::RNG`: multiply-with-carry on a 64-bit state."""

    def __init__(self, state: int = 0xFFFFFFFFFFFFFFFF):
        self.state = state

    def next(self) -> int:
        s = self.state
        s = (s & 0xFFFFFFFF) * 4164903690 + (s >> 32)
        self.state = s
        return s & 0xFFFFFFFF

    def uniform(self, n: int) -> int:
        return self.next() % n


def _draw(rng: CvRng, count: int, k: int) -> np.ndarray:
    """`k` draws of four distinct indices in `[0, count)` (`getSubset`)."""
    out = []
    for _ in range(k):
        idx = []
        for _ in range(4):
            j = rng.uniform(count)
            while j in idx:
                j = rng.uniform(count)
            idx.append(j)
        out.append(idx)
    return np.asarray(out, np.int64)


def _seqsum(a: np.ndarray, axis: int) -> np.ndarray:
    """A sum in index order, as a C loop adds."""
    return np.take(np.cumsum(a, axis=axis), -1, axis=axis)


def _collinear(p: np.ndarray) -> np.ndarray:
    """`haveCollinearPoints(p, 4)` for (K, 4, 2) f32 sets: the last point on a
    line through two of the others, or too close to one."""
    out = np.zeros(len(p), bool)
    for j in range(3):
        dx1 = (p[:, j, 0] - p[:, 3, 0]).astype(_F64)
        dy1 = (p[:, j, 1] - p[:, 3, 1]).astype(_F64)
        for k in range(j):
            dx2 = (p[:, k, 0] - p[:, 3, 0]).astype(_F64)
            dy2 = (p[:, k, 1] - p[:, 3, 1]).astype(_F64)
            out |= (np.abs(dx2 * dy1 - dy2 * dx1)
                    <= FLT_EPSILON * (np.abs(dx1) + np.abs(dy1) + np.abs(dx2) + np.abs(dy2)))
    return out


def _det3(p: np.ndarray, t) -> np.ndarray:
    """`determinant(Matx33d)` of the rows `(x, y, 1)` of points `t`."""
    a = p[:, t[0]].astype(_F64)
    b = p[:, t[1]].astype(_F64)
    c = p[:, t[2]].astype(_F64)
    return (a[:, 0] * (b[:, 1] * 1.0 - c[:, 1] * 1.0)
            - a[:, 1] * (b[:, 0] * 1.0 - c[:, 0] * 1.0)
            + 1.0 * (b[:, 0] * c[:, 1] - c[:, 0] * b[:, 1]))


def subset_ok(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    """`checkSubset` for (K, 4, 2) f32 source and destination sets."""
    negative = sum((_det3(s, t) * _det3(d, t) < 0).astype(np.int64) for t in _TRIPLES)
    return ~_collinear(s) & ~_collinear(d) & ((negative == 0) | (negative == 4))


def jacobi_smallest(a: np.ndarray, max_sweeps: int = 30) -> np.ndarray:
    """The eigenvector of the smallest eigenvalue of each symmetric (K, n, n)
    f64 matrix, by cyclic Jacobi: sweeps over the pairs (p, q), p < q, in
    row order, each rotating where `|a[p, q]| > DBL_EPSILON` (the rotation of
    OpenCV's `JacobiImpl_`, its `hypot` as the square root of the sum of
    squares; the diagonal kept apart), until no entry is left above that or
    after `max_sweeps`; the first of the smallest diagonal."""
    kk, n, _ = a.shape
    a = np.ascontiguousarray(np.moveaxis(np.asarray(a, _F64), 0, -1))  # (n, n, K)
    col = np.arange(n)
    w = a[col, col].copy()
    v = np.repeat(np.eye(n)[..., None], kk, axis=2)
    upper = np.triu_indices(n, 1)
    for _ in range(max_sweeps):
        if not (np.abs(a[upper]) > DBL_EPSILON).any():
            break
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq = a[p, q]
                act = np.abs(apq) > DBL_EPSILON
                if not act.any():
                    continue
                # a matrix that does not rotate here takes the identity
                pv = np.where(act, apq, 1.0)
                y = np.where(act, (w[q] - w[p]) * 0.5, 0.0)
                t = np.abs(y) + np.sqrt(pv * pv + y * y)
                s = np.sqrt(pv * pv + t * t)
                c = np.where(act, t / s, 1.0)
                s = np.where(act, pv / s, 0.0)
                t = np.where(act, (pv / t) * pv, 0.0)
                neg = y < 0
                s = np.where(neg, -s, s)
                t = np.where(neg, -t, t)
                w[p] -= t
                w[q] += t
                a0 = a[p].copy()
                b0 = a[q].copy()
                nk = a0 * c - b0 * s
                nl = a0 * s + b0 * c
                nk[p] = a0[p]
                nk[q] = np.where(act, 0.0, a0[q])
                nl[p] = nk[q]
                nl[q] = b0[q]
                a[p] = nk
                a[:, p] = nk
                a[q] = nl
                a[:, q] = nl
                v0 = v[p].copy()
                v1 = v[q]
                v[p] = v0 * c - v1 * s
                v[q] = v0 * s + v1 * c
    return v[np.argmin(w, axis=0), :, np.arange(kk)]


def _matmul3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(K, 3, 3) products, each entry summed in index order."""
    return ((a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :])
            + a[..., :, 2, None] * b[..., None, 2, :])


def dlt(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`HomographyEstimatorCallback::runKernel` for (K, N, 2) f32 sets:
    (H (K, 3, 3), ok (K,)); a set whose points do not spread is not ok."""
    big_m = src.astype(_F64)
    m = dst.astype(_F64)
    kk, count, _ = m.shape
    cm = _seqsum(m, 1) / count
    c_big = _seqsum(big_m, 1) / count
    sm = _seqsum(np.abs(m - cm[:, None]), 1)
    s_big = _seqsum(np.abs(big_m - c_big[:, None]), 1)
    ok = ~((np.abs(sm) < DBL_EPSILON).any(1) | (np.abs(s_big) < DBL_EPSILON).any(1))
    with np.errstate(divide="ignore", invalid="ignore"):
        sm = count / sm
        s_big = count / s_big
        x = (m[..., 0] - cm[:, None, 0]) * sm[:, None, 0]
        y = (m[..., 1] - cm[:, None, 1]) * sm[:, None, 1]
        bx = (big_m[..., 0] - c_big[:, None, 0]) * s_big[:, None, 0]
        by = (big_m[..., 1] - c_big[:, None, 1]) * s_big[:, None, 1]
    one = np.ones_like(x)
    zero = np.zeros_like(x)
    lx = np.stack([bx, by, one, zero, zero, zero, -x * bx, -x * by, -x], -1)
    ly = np.stack([zero, zero, zero, bx, by, one, -y * bx, -y * by, -y], -1)
    ltl = _seqsum(lx[..., :, None] * lx[..., None, :] + ly[..., :, None] * ly[..., None, :], 1)
    ltl = np.triu(ltl)
    ltl = ltl + np.triu(ltl, 1).transpose(0, 2, 1)
    h0 = jacobi_smallest(np.where(ok[:, None, None], ltl, np.eye(9))).reshape(kk, 3, 3)
    z = np.zeros(kk)
    o = np.ones(kk)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_norm = np.stack([1.0 / sm[:, 0], z, cm[:, 0], z, 1.0 / sm[:, 1], cm[:, 1], z, z, o],
                            -1).reshape(kk, 3, 3)
        norm2 = np.stack([s_big[:, 0], z, -c_big[:, 0] * s_big[:, 0], z, s_big[:, 1],
                          -c_big[:, 1] * s_big[:, 1], z, z, o], -1).reshape(kk, 3, 3)
        h = _matmul3(_matmul3(inv_norm, h0), norm2)
        # scaled to H[2,2] = 1, but where that entry vanishes (a degenerate
        # set, whose H cv2 returns unscaled)
        h22 = h[:, 2, 2]
        scale = np.where(np.abs(h22) > DBL_EPSILON, 1.0 / np.where(h22 == 0, 1.0, h22), 1.0)
        h = h * scale[:, None, None]
    return h, ok


def reprojection_errors(h: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """`computeError` in f32: (K, N) `dx^2 + dy^2` of each (K, 3, 3) model,
    whose `H[2,2]` is taken as 1."""
    hf = np.asarray(h, _F64).reshape(-1, 9)[:, :8].astype(_F32)
    x, y = src[:, 0], src[:, 1]
    one = _F32(1.0)
    with np.errstate(all="ignore"):
        ww = one / (hf[:, 6:7] * x + hf[:, 7:8] * y + one)
        dx = (hf[:, 0:1] * x + hf[:, 1:2] * y + hf[:, 2:3]) * ww - dst[:, 0]
        dy = (hf[:, 3:4] * x + hf[:, 4:5] * y + hf[:, 5:6]) * ww - dst[:, 1]
        return dx * dx + dy * dy


def update_num_iters(p: float, ep: float, model_points: int, max_iters: int) -> int:
    """`RANSACUpdateNumIters`."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, DBL_MIN)
    denom = 1.0 - math.pow(1.0 - ep, float(model_points))
    if denom < DBL_MIN:
        return 0
    num = math.log(num)
    denom = math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def _residuals(p: np.ndarray, src: np.ndarray, dst: np.ndarray, jac: bool):
    """The refinement's residuals (2N,) and Jacobian (2N, 9) at the nine
    entries `p` of H."""
    mx = src[:, 0].astype(_F64)
    my = src[:, 1].astype(_F64)
    ww = p[6] * mx + p[7] * my + p[8]
    with np.errstate(divide="ignore"):
        ww = np.where(np.abs(ww) > DBL_EPSILON, 1.0 / ww, 0.0)
    xi = (p[0] * mx + p[1] * my + p[2]) * ww
    yi = (p[3] * mx + p[4] * my + p[5]) * ww
    err = np.stack([xi - dst[:, 0].astype(_F64), yi - dst[:, 1].astype(_F64)], 1).reshape(-1)
    if not jac:
        return err, None
    z = np.zeros_like(mx)
    jx = np.stack([mx * ww, my * ww, ww, z, z, z, -mx * ww * xi, -my * ww * xi, -ww * xi], 1)
    jy = np.stack([z, z, z, mx * ww, my * ww, ww, -mx * ww * yi, -my * ww * yi, -ww * yi], 1)
    return err, np.stack([jx, jy], 1).reshape(-1, 9)


def _normal_equations(err: np.ndarray, j: np.ndarray):
    """`J^T J`, `J^T r` and `r^T r`, each summed row by row."""
    a = _seqsum(j[:, :, None] * j[:, None, :], 0)
    g = _seqsum(j * err[:, None], 0)
    return a, g, float(_seqsum(err * err, 0))


def _cholesky_solve(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """`a x = b` for a symmetric positive definite `a`, by `L L^T`, each sum
    in index order; None where a pivot is not positive."""
    n = len(b)
    low = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1):
            s = float(a[i, j])
            for k in range(j):
                s -= float(low[i, k]) * float(low[j, k])
            if i == j:
                if not s > 0.0:
                    return None
                low[i, i] = math.sqrt(s)
            else:
                low[i, j] = s / float(low[j, j])
    y = np.zeros(n)
    for i in range(n):
        s = float(b[i])
        for k in range(i):
            s -= float(low[i, k]) * float(y[k])
        y[i] = s / float(low[i, i])
    x = np.zeros(n)
    for i in reversed(range(n)):
        s = float(y[i])
        for k in range(i + 1, n):
            s -= float(low[k, i]) * float(x[k])
        x[i] = s / float(low[i, i])
    return x


def _div(a: float, b: float) -> float:
    """`a / b` as C divides (inf or nan where `b` is 0)."""
    with np.errstate(all="ignore"):
        return float(np.float64(a) / np.float64(b))


def refine(h: np.ndarray, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """OpenCV 5's Levenberg-Marquardt refinement of H on the inliers."""
    p = np.asarray(h, _F64).reshape(9).copy()
    err, j = _residuals(p, src, dst, True)
    a, g, energy = _normal_equations(err, j)
    lam, up = 1e-4, 2.0
    for it in range(1, LM_MAX_ITERS + 1):
        d = np.minimum(np.maximum(np.diag(a), 1e-6), 1e32)
        damped = a.copy()
        for i in range(9):
            damped[i, i] = a[i, i] + lam * d[i]
        x = _cholesky_solve(damped, -g)
        done = False
        if x is None:
            lam *= up
            up *= 2.0
        else:
            probe = p + x
            err2, _ = _residuals(probe, src, dst, False)
            energy2 = float(_seqsum(err2 * err2, 0))
            change = energy - energy2
            if not change >= 0.0 or abs(change) < DBL_EPSILON:
                lam *= up
                up *= 2.0
            else:
                pred = float(_seqsum(x * (g - lam * d * x), 0))
                rho = _div(change, -0.5 * pred)
                q = 2.0 * rho - 1.0
                lam *= max(1.0 - q * q * q, 1.0 / 3.0)
                up = 2.0
                done = 1e-6 > _div(change, energy2) or 1e-6 > float(_seqsum(x * x, 0))
                p = probe
                err, j = _residuals(p, src, dst, True)
                a, g, energy = _normal_equations(err, j)
        if done or lam >= 1e32:
            break
    return (p * (1.0 / p[8])).reshape(3, 3)


def _ransac(src: np.ndarray, dst: np.ndarray, max_iters: int, confidence: float):
    """OpenCV's classic RANSAC registrator: (best model or None, best mask)."""
    count = len(src)
    rng = CvRng()
    thresh = _F32(THRESHOLD * THRESHOLD)
    niters = max(max_iters, 1)
    best_count, best_h, best_mask = 0, None, None
    it = 0
    failed = 0  # draws failed in a row since the last kept one
    chunk = 64  # draws a batch, doubled up to 4096: most runs stop early
    while it < niters:
        tuples = _draw(rng, count, chunk)
        chunk = min(2 * chunk, 4096)
        keep = subset_ok(src[tuples], dst[tuples])
        hyps = []
        for t, ok in zip(tuples, keep):
            if ok:
                hyps.append(t)
                failed = 0
            else:
                failed += 1
                if failed >= MAX_ATTEMPTS:
                    break
        if hyps:
            sel = np.asarray(hyps)
            models, fit = dlt(src[sel], dst[sel])
            inl = reprojection_errors(models, src, dst) <= thresh
            good = inl.sum(1)
            for i in range(len(sel)):
                if it >= niters:
                    break
                it += 1
                if fit[i] and good[i] > max(best_count, 3):
                    best_count, best_h, best_mask = int(good[i]), models[i], inl[i]
                    niters = update_num_iters(confidence, (count - best_count) / count, 4, niters)
        if failed >= MAX_ATTEMPTS and it < niters:
            if it == 0:
                return None, None
            break
    return (best_h, best_mask) if best_count > 0 else (None, None)


def find_homography_ransac(src: np.ndarray, dst: np.ndarray, max_iters: int = 2000,
                           confidence: float = 0.995) -> tuple[Optional[np.ndarray], np.ndarray]:
    """`cv2.findHomography(src.astype(f32), dst.astype(f32), cv2.RANSAC)`:
    (H (3, 3) f64 or None, the (N,) uint8 inlier mask)."""
    src = np.ascontiguousarray(np.asarray(src).reshape(-1, 2), _F32)
    dst = np.ascontiguousarray(np.asarray(dst).reshape(-1, 2), _F32)
    n = len(src)
    if n < 4:
        return None, np.zeros(n, np.uint8)
    if n == 4:
        h, ok = dlt(src[None], dst[None])
        return (h[0], np.ones(4, np.uint8)) if ok[0] else (None, np.zeros(4, np.uint8))
    h, mask = _ransac(src, dst, max_iters, confidence)
    if h is None:
        return None, np.zeros(n, np.uint8)
    s_in, d_in = src[mask], dst[mask]
    refit, ok = dlt(s_in[None], d_in[None])
    if ok[0]:
        h = refit[0]
    h = refine(h, s_in, d_in)
    mask = reprojection_errors(h[None], src, dst)[0] <= _F32(THRESHOLD * THRESHOLD)
    return h, mask.astype(np.uint8)


def find_homography_ransac_compiled(src: np.ndarray, dst: np.ndarray, max_iters: int = 2000,
                                    confidence: float = 0.995,
                                    lib: Optional[ctypes.CDLL] = None
                                    ) -> tuple[Optional[np.ndarray], np.ndarray]:
    """`find_homography_ransac` in compiled host code (`yp_find_homography` of
    `lib`, by default the kernel library); raises where that cannot be built."""
    if lib is None:
        from yolopoint_tpu_torch.ops import _build

        lib = _build.library()
    src = np.ascontiguousarray(np.asarray(src).reshape(-1, 2), _F32)
    dst = np.ascontiguousarray(np.asarray(dst).reshape(-1, 2), _F32)
    n = len(src)
    h = np.zeros(9, _F64)
    mask = np.zeros(n, np.uint8)
    code = lib.yp_find_homography(ctypes.c_void_p(src.ctypes.data), ctypes.c_void_p(dst.ctypes.data),
                                  ctypes.c_int(n), ctypes.c_int(max_iters),
                                  ctypes.c_double(confidence), ctypes.c_void_p(h.ctypes.data),
                                  ctypes.c_void_p(mask.ctypes.data))
    if code < 0:
        raise ValueError(f"yp_find_homography: bad arguments (n={n}, max_iters={max_iters}, "
                         f"confidence={confidence})")
    return (h.reshape(3, 3), mask) if code == 1 else (None, mask)


def find_homography_for(device: str | torch.device) -> Callable[..., tuple]:
    """The estimate a run on `device` takes: numpy for the CPU, else the
    compiled host code."""
    if torch.device(device).type == "cpu":
        return find_homography_ransac
    return find_homography_ransac_compiled
