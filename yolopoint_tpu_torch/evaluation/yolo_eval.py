"""YOLO mAP stack: TP matrices, PR/AP curves, confusion matrix, fitness.

Numpy copy of `yolopoint_tpu/evaluation/yolo_eval.py` (the port imports
nothing of the JAX package): `process_batch`, `ap_per_class` with the
101-point interpolated `compute_ap`, `ConfusionMatrix`, and the
model-selection fitness. Host-side, eval-only.
"""

from __future__ import annotations

import numpy as np


def np_box_iou(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU of xyxy boxes (numpy twin of `ops.boxes.box_iou`)."""
    a1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    a2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    return inter / (a1[:, None] + a2[None, :] - inter + eps)


def process_batch(detections: np.ndarray, labels: np.ndarray, iouv: np.ndarray) -> np.ndarray:
    """Correct-prediction matrix at each IoU level.

    Args:
      detections: `(N, 6)` `[x1, y1, x2, y2, conf, cls]`.
      labels: `(M, 5)` `[cls, x1, y1, x2, y2]`.
      iouv: IoU thresholds, e.g. linspace(0.5, 0.95, 10).

    Returns `(N, len(iouv))` bool. Each label matches at most one detection
    (greedy by IoU), parity with `yolo_evaluation.py:72-94`.
    """
    correct = np.zeros((detections.shape[0], iouv.shape[0]), bool)
    if len(labels) == 0 or len(detections) == 0:
        return correct
    iou = np_box_iou(labels[:, 1:], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[None, :, 5]
    for i, thr in enumerate(iouv):
        li, di = np.where((iou >= thr) & correct_class)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (`metrics_yolo.py:21-26`)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate([p * y[0], y, p * y[-1]])
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (`metrics_yolo.py:96-121`)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    eps: float = 1e-16,
    return_curves: bool = False,
):
    """Per-class P, R, F1, AP from accumulated predictions
    (`metrics_yolo.py:29-93`). Returns (tp, fp, p, r, f1, ap, unique_classes);
    with `return_curves`, appends a dict of the full px/P/R/F1/PR curves for
    plotting (reference `metrics_yolo.py:84-88` -> `plots_yolo.py`)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = len(unique_classes)

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = np.zeros((nc, 101))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l, n_p = nt[ci], sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:  # PR curve at IoU 0.5
                prec_values[ci] = np.interp(np.linspace(0, 1, 101), mrec, mpre)

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1v = p_curve[:, i], r_curve[:, i], f1[:, i]
    tp_out = (r * nt).round()
    fp_out = (tp_out / (p + eps) - tp_out).round()
    out = (tp_out, fp_out, p, r, f1v, ap, unique_classes.astype(int))
    if return_curves:
        curves = {
            "px": px, "p": p_curve, "r": r_curve, "f1": f1,
            "pr_x": np.linspace(0, 1, 101), "pr": prec_values,
            "ap50": ap[:, 0], "classes": unique_classes.astype(int),
        }
        return out + (curves,)
    return out


class ConfusionMatrix:
    """(nc+1)x(nc+1) detection confusion matrix (`metrics_yolo.py:124-199`)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc, self.conf, self.iou_thres = nc, conf, iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray) -> None:
        if len(detections):
            detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int) if len(labels) else np.zeros(0, int)
        det_classes = detections[:, 5].astype(int) if len(detections) else np.zeros(0, int)
        if len(labels) and len(detections):
            iou = np_box_iou(labels[:, 1:], detections[:, :4])
            li, di = np.where(iou > self.iou_thres)
        else:
            li = di = np.zeros(0, int)
        if len(li):
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if len(li) > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        m0, m1 = matches[:, 0].astype(int), matches[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if len(matches) and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if len(matches):
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1


def fitness_yolo(p: float, r: float, map50: float, map_: float) -> float:
    """0.1*mAP50 + 0.9*mAP (`metrics_yolo.py:15-18`)."""
    return 0.1 * map50 + 0.9 * map_


def combined_fitness(repeatability: float, homography: float, yolo_fit: float) -> float:
    """Model-selection fitness
    `0.3*(0.55*rep + 0.45*homo) + 0.7*yolo_fitness`."""
    return 0.3 * (0.55 * repeatability + 0.45 * homography) + 0.7 * yolo_fit
