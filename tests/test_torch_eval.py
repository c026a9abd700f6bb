"""The port's copies of the evaluation modules (`yolopoint_tpu_torch.evaluation`)
against `yolopoint_tpu.evaluation` on the same seeded numpy inputs: every
result equal (both are the same float64 numpy arithmetic). The port
estimates homographies with the numpy RANSAC whether `cv2` is importable or
not; it is held against the JAX package with `cv2` hidden (which then runs
the same numpy RANSAC, as it does where `cv2` is not installed)."""

import sys

import numpy as np
import pytest
import torch

import yolopoint_tpu.evaluation.descriptor_eval as jdesc
import yolopoint_tpu.evaluation.detector_eval as jdet
import yolopoint_tpu.evaluation.yolo_eval as jyolo
import yolopoint_tpu_torch.evaluation.descriptor_eval as tdesc
import yolopoint_tpu_torch.evaluation.detector_eval as tdet
import yolopoint_tpu_torch.evaluation.yolo_eval as tyolo
from yolopoint_tpu.ops.homography import perspective_transform_np as jax_perspective_np
from yolopoint_tpu_torch.ops.homography import perspective_transform_np

torch.set_num_threads(1)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _dets_labels(rng, n_det, n_lab, nc=4):
    lab_xy = rng.uniform(0, 100, (n_lab, 2))
    labels = np.concatenate([rng.integers(0, nc, (n_lab, 1)), lab_xy,
                             lab_xy + rng.uniform(5, 40, (n_lab, 2))], 1)
    anchor = labels if n_lab else np.array([[0, 10, 10, 40, 40]], np.float64)
    src = rng.integers(0, len(anchor), n_det)  # detections jitter around labels
    xy = anchor[src, 1:3] + rng.normal(0, 3, (n_det, 2))
    wh = anchor[src, 3:5] - anchor[src, 1:3] + rng.normal(0, 3, (n_det, 2))
    cls = np.where(rng.uniform(size=n_det) < 0.8, anchor[src, 0], rng.integers(0, nc, n_det))
    dets = np.concatenate([xy, xy + np.abs(wh), rng.uniform(0.01, 1, (n_det, 1)),
                           cls[:, None]], 1)
    return dets, labels


def test_yolo_eval_equal_to_jax():
    rng = np.random.default_rng(0)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    cm_t, cm_j = tyolo.ConfusionMatrix(4), jyolo.ConfusionMatrix(4)
    for n_det, n_lab in ((40, 8), (25, 5), (0, 3), (6, 0), (60, 12)):
        dets, labels = _dets_labels(rng, n_det, n_lab)
        c = tyolo.process_batch(dets, labels, iouv)
        _equal(c, jyolo.process_batch(dets, labels, iouv))
        _equal(tyolo.np_box_iou(dets[:, :4], dets[:, :4]),
               jyolo.np_box_iou(dets[:, :4], dets[:, :4]))
        cm_t.process_batch(dets, labels)
        cm_j.process_batch(dets, labels)
        stats.append((c, dets[:, 4], dets[:, 5], labels[:, 0]))
    _equal(cm_t.matrix, cm_j.matrix)
    assert cm_t.matrix.sum() > 0
    tp, conf, pcls, tcls = (np.concatenate([s[i] for s in stats]) for i in range(4))
    assert tp.any()
    _equal(tyolo.ap_per_class(tp, conf, pcls, tcls, return_curves=True),
           jyolo.ap_per_class(tp, conf, pcls, tcls, return_curves=True))
    r, p = np.sort(rng.uniform(size=30)), rng.uniform(size=30)
    _equal(tyolo.compute_ap(r, p), jyolo.compute_ap(r, p))
    _equal(tyolo.smooth(p, 0.1), jyolo.smooth(p, 0.1))
    assert tyolo.fitness_yolo(0.5, 0.4, 0.6, 0.3) == jyolo.fitness_yolo(0.5, 0.4, 0.6, 0.3)
    assert tyolo.combined_fitness(0.7, 0.2, 0.35) == jyolo.combined_fitness(0.7, 0.2, 0.35)


def _normalized_homography(rng):
    """A mild homography in the [-1, 1] convention of the val step."""
    src = np.array([[-1, -1], [-1, 1], [1, 1], [1, -1]], np.float64)
    return jax_perspective_np(src, src + rng.uniform(-0.15, 0.15, (4, 2)))


def _keypoint_pair(rng, H=96, W=128, n=80):
    hom = _normalized_homography(rng)
    inv = np.linalg.inv(hom)
    pts = rng.uniform(4, [W - 4, H - 4], (n, 2))
    kp = np.concatenate([pts, rng.uniform(0, 1, (n, 1))], 1)
    warped = jdet.warp_keypoints_np(pts, inv, (H, W)) + rng.normal(0, 0.7, (n, 2))
    wkp = np.concatenate([warped, rng.uniform(0, 1, (n, 1))], 1)
    return kp, wkp, hom, inv, (H, W)


def test_detector_eval_equal_to_jax():
    rng = np.random.default_rng(1)
    kp, wkp, hom, inv, hw = _keypoint_pair(rng)
    got = tdet.compute_repeatability(kp, wkp, hom, inv, hw)
    _equal(got, jdet.compute_repeatability(kp, wkp, hom, inv, hw))
    assert got[0] > 0.3
    _equal(tdet.compute_repeatability(kp[:0], wkp, hom, inv, hw),
           jdet.compute_repeatability(kp[:0], wkp, hom, inv, hw))
    _equal(tdet.warp_keypoints_np(kp[:, :2], hom, hw), jdet.warp_keypoints_np(kp[:, :2], hom, hw))
    heat = rng.uniform(0, 1, (2, 32, 40)) ** 4
    lab = (rng.uniform(size=(2, 32, 40)) < 0.05).astype(np.float64)
    _equal(tdet.batch_precision_recall(heat, lab), jdet.batch_precision_recall(heat, lab))


def test_perspective_transform_np_equal_to_jax():
    rng = np.random.default_rng(2)
    src = rng.uniform(0, 100, (5, 4, 2))
    dst = src + rng.uniform(-10, 10, (5, 4, 2))
    _equal(perspective_transform_np(src, dst), jax_perspective_np(src, dst))


@pytest.mark.parametrize("hide_cv2", [False, True])
def test_homography_correctness_equal_to_jax(hide_cv2, monkeypatch):
    if hide_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    rng = np.random.default_rng(3)
    kp, wkp, hom, inv, hw = _keypoint_pair(rng)
    desc = rng.normal(size=(len(kp), 32))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    wdesc = desc + rng.normal(0, 0.05, desc.shape)  # mostly mutual matches
    wdesc[::5] = rng.normal(size=wdesc[::5].shape)  # and some outliers
    got = tdesc.compute_homography_correctness(kp, wkp, desc, wdesc, inv, hw)
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX package's numpy RANSAC
    want = jdesc.compute_homography_correctness(kp, wkp, desc, wdesc, inv, hw)
    _equal(got, want)
    assert got["correctness"] == 1.0 and got["matching_score"] > 0.5
    if hide_cv2:  # the numpy RANSAC on its own
        m = got["matches"]
        _equal(tdesc.ransac_homography_np(m[:, :2], m[:, 2:]),
               jdesc.ransac_homography_np(m[:, :2], m[:, 2:]))
    _equal(tdesc.mutual_match_np(desc, wdesc), jdesc.mutual_match_np(desc, wdesc))
