"""YOLOv5 object loss with a fixed-shape `build_targets`.

Counterpart of `yolopoint_tpu/losses/objects.py`: every (target, anchor,
neighbour-cell offset) is a candidate in a dense `(B, M, na, 5)` tensor with
a validity mask, so no shape depends on the data. Anchor match
`max(r, 1/r) < anchor_t`; the centre cell plus the left/up and right/down
neighbours whose in-cell fraction is below 0.5; CIoU box loss (masked
mean), objectness BCE against the detached, clamped IoU scattered into the
grid (balance 4.0, 1.0, 0.4), class BCE with `cp`/`cn` smoothing; optional
focal modulation. Gains come rescaled by the caller (`rescale_yolo_gains`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops.boxes import bbox_iou


@dataclasses.dataclass(frozen=True)
class ObjectLossConfig:
    """Hyperparameters (`model.yolo.*` of the YAML schema)."""

    box: float = 0.05
    obj: float = 1.0
    cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    label_smoothing: float = 0.0
    fl_gamma: float = 0.0
    balance: tuple = (4.0, 1.0, 0.4)

    @property
    def cp_cn(self) -> tuple[float, float]:
        eps = self.label_smoothing
        return 1.0 - 0.5 * eps, 0.5 * eps


def _bce_logits(logits, targets, pos_weight=1.0):
    """BCE with logits, elementwise, in the log-sigmoid form."""
    return -(pos_weight * targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))


def _focal_factor(logits, targets, gamma, alpha=0.25):
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


def qfocal_factor(logits, targets, gamma=1.5, alpha=0.25):
    """Quality-focal modulation."""
    p = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1 - targets) * (1 - alpha)
    return alpha_factor * (targets - p).abs() ** gamma


class Candidates(NamedTuple):
    """One level's fixed-shape target candidates, flattened to `B * M * na * 5`
    rows: image, anchor and cell indices, validity, class, anchor size and
    the target box (xy within the cell, wh; grid units)."""

    b: torch.Tensor
    a: torch.Tensor
    gj: torch.Tensor
    gi: torch.Tensor
    valid: torch.Tensor
    cls: torch.Tensor
    anchor: torch.Tensor
    tbox: torch.Tensor


def build_targets(targets: torch.Tensor, target_mask: torch.Tensor, anchors: torch.Tensor,
                  nx: int, ny: int, anchor_t: float) -> Candidates:
    """Every (target, anchor, neighbour-cell offset) of one `(ny, nx)` level:
    anchor match `max(r, 1/r) < anchor_t`; the centre cell plus the left/up
    and right/down neighbours whose in-cell fraction is below 0.5."""
    dev = targets.device
    B, M = targets.shape[:2]
    na = anchors.shape[0]
    g = 0.5
    offs = torch.tensor([[0.0, 0.0], [g, 0.0], [0.0, g], [-g, 0.0], [0.0, -g]], device=dev)
    grid_shape = (B, M, na, 5)
    gain = torch.tensor([nx, ny, nx, ny], dtype=torch.float32, device=dev)
    txywh = targets[..., 1:5] * gain
    tcls = targets[..., 0].long()

    r = txywh[..., None, 2:4] / anchors[None, None]          # (B, M, na, 2)
    ratio = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(-1)
    anchor_ok = ratio < anchor_t

    gxy = txywh[..., 0:2]
    gxi = gain[0:2] - gxy
    jk = (torch.remainder(gxy, 1.0) < g) & (gxy > 1.0)       # left, up
    lm = (torch.remainder(gxi, 1.0) < g) & (gxi > 1.0)       # right, down
    off_ok = torch.stack([torch.ones_like(jk[..., 0]), jk[..., 0], jk[..., 1],
                          lm[..., 0], lm[..., 1]], dim=-1)   # (B, M, 5)
    valid = target_mask[..., None, None] & anchor_ok[..., None] & off_ok[:, :, None, :]
    valid = valid & (txywh[..., 2:4].amin(-1) > 0)[..., None, None]

    gij = torch.floor(gxy[:, :, None, None, :] - offs).expand(B, M, na, 5, 2)
    gi = gij[..., 0].long().clamp(0, nx - 1).reshape(-1)
    gj = gij[..., 1].long().clamp(0, ny - 1).reshape(-1)
    gxy_f = gxy[:, :, None, None, :].expand(B, M, na, 5, 2).reshape(-1, 2)
    gwh_f = txywh[..., None, None, 2:4].expand(B, M, na, 5, 2).reshape(-1, 2)
    return Candidates(
        b=torch.arange(B, device=dev)[:, None, None, None].expand(grid_shape).reshape(-1),
        a=torch.arange(na, device=dev)[None, None, :, None].expand(grid_shape).reshape(-1),
        gj=gj, gi=gi, valid=valid.reshape(-1),
        cls=tcls[..., None, None].expand(grid_shape).reshape(-1),
        anchor=anchors[None, None, :, None, :].expand(B, M, na, 5, 2).reshape(-1, 2),
        tbox=torch.cat([gxy_f - torch.stack([gi, gj], -1).float(), gwh_f], dim=-1),
    )


def candidate_boxes(pi: torch.Tensor, c: Candidates) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw predictions at the candidates' cells `(rows, nc + 5)` and their
    decoded boxes `(rows, 4)` (xy within the cell, wh; grid units)."""
    psub = pi[c.b, c.a, c.gj, c.gi]
    pxy = torch.sigmoid(psub[:, 0:2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(psub[:, 2:4]) * 2.0) ** 2 * c.anchor
    return psub, torch.cat([pxy, pwh], dim=-1)


def object_loss(
    preds: Sequence[torch.Tensor],
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    anchors_per_stride: np.ndarray,
    cfg: ObjectLossConfig,
    nc: int,
) -> tuple[torch.Tensor, dict]:
    """The 3-level YOLOv5 loss.

    Args:
      preds: raw Detect levels `(B, na, ny, nx, nc + 5)`.
      targets: `(B, M, 5)` padded `[cls, cx, cy, w, h]`, xywh normalized.
      target_mask: `(B, M)` validity.
      anchors_per_stride: `(nl, na, 2)` anchors in grid units.

    Returns:
      `(box + obj + cls, {"box", "obj", "cls"})`, each gain applied.
    """
    dev = targets.device
    zero = torch.zeros((), device=dev)
    lbox, lobj, lcls = zero, zero, zero
    cp, cn = cfg.cp_cn

    for i, pi in enumerate(preds):
        pi = pi.float()
        B, na, ny, nx = pi.shape[:4]
        anchors = torch.as_tensor(anchors_per_stride[i], dtype=torch.float32, device=dev)
        c = build_targets(targets, target_mask, anchors, nx, ny, cfg.anchor_t)
        bidx, aidx, gj, gi, v_f = c.b, c.a, c.gj, c.gi, c.valid
        psub, pbox = candidate_boxes(pi, c)
        iou = bbox_iou(pbox, c.tbox, CIoU=True)
        vf = v_f.float()
        n_valid = vf.sum()
        lbox_i = ((1.0 - iou) * vf).sum() / n_valid.clamp(min=1.0)
        lbox = lbox + torch.where(n_valid > 0, lbox_i, 0.0)

        iou_t = torch.where(v_f, iou.detach().clamp(min=0.0), 0.0)
        lin = ((bidx * na + aidx) * ny + gj) * nx + gi
        tobj = torch.zeros(B * na * ny * nx, device=dev).scatter_reduce(
            0, lin, iou_t, reduce="amax").reshape(pi.shape[:4])
        obj_bce = _bce_logits(pi[..., 4], tobj, cfg.obj_pw)
        if cfg.fl_gamma > 0:
            obj_bce = obj_bce * _focal_factor(pi[..., 4], tobj, cfg.fl_gamma)
        lobj = lobj + obj_bce.mean() * cfg.balance[i]

        if nc > 1:
            pcls = psub[:, 5:]
            t = torch.full((v_f.shape[0], nc), cn, device=dev)
            # a class past the model's `nc` (a dataset mix whose labels outnumber
            # the names) sets no target, as the JAX scatter drops it
            t[torch.arange(v_f.shape[0], device=dev), c.cls.clamp(0, nc - 1)] = \
                torch.where(c.cls < nc, cp, cn)
            cls_bce = _bce_logits(pcls, t, cfg.cls_pw)
            if cfg.fl_gamma > 0:
                cls_bce = cls_bce * _focal_factor(pcls, t, cfg.fl_gamma)
            lcls_i = (cls_bce * vf[:, None]).sum() / (n_valid * nc).clamp(min=1.0)
            lcls = lcls + torch.where(n_valid > 0, lcls_i, 0.0)

    lbox, lobj, lcls = lbox * cfg.box, lobj * cfg.obj, lcls * cfg.cls
    return lbox + lobj + lcls, {"box": lbox, "obj": lobj, "cls": lcls}
