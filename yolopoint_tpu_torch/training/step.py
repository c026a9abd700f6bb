"""The joint training step on one device.

Counterpart of `yolopoint_tpu/training/step.py` (`LossWeights`,
`rescale_yolo_gains`, `losses_from_outputs`, `compute_losses`,
`make_train_step`, `make_val_step`), without `shard_map` and `remat`:

  augmentation (photometric + homographic warped pair, no gradient)
  -> train-mode forward(base), then forward(warped), which sees the
     BatchNorm statistics the first one updated
  -> detector loss x2 + YOLOv5 object loss + descriptor loss, in f32
  -> total = (det + det_warp) + lambda * desc + lambda_obj * obj
  -> backward -> non-finite guard -> optimizer (with accumulation) -> EMA.

Mixed precision is `torch.autocast` in the compute dtype around the two
forwards only; parameters, BatchNorm and the losses stay f32.

The val step (`make_val_step`) builds the views the same way, runs both
forwards in eval mode, the same losses, and decodes both views: keypoints
(K1, or K6 where the map is no tile multiple), descriptors (K3) and
multi-label box NMS at the val protocol's conf 0.001 and 30000 candidates
(K2 inside the exact tiled scan).

Randomness is drawn apart from the step (`draw_step`), so that a caller
can feed the same samples to two devices or to the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from yolopoint_tpu_torch.data.augmentation import build_training_views, draw_training_views
from yolopoint_tpu_torch.losses.descriptor import (
    descriptor_loss_sparse,
    draw_descriptor_samples,
    infonce_loss,
)
from yolopoint_tpu_torch.losses.detector import detector_loss, detector_loss_ce
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig, object_loss
from yolopoint_tpu_torch.models.detect import decode_levels
from yolopoint_tpu_torch.ops.heatmap import cell_valid_mask, cells_to_heatmap, labels_to_cells
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints
from yolopoint_tpu_torch.ops.nms import batched_box_nms
from yolopoint_tpu_torch.ops.sampling import sample_descriptors
from yolopoint_tpu_torch.training.ema import ema_update
from yolopoint_tpu_torch.training.state import TrainState

BATCH_KEYS = ("image", "points", "point_mask", "boxes", "box_mask")


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss weights and the sparse-loss sampling config."""

    lambda_desc: float = 0.1       # model.lambda_loss
    lambda_obj: float = 10.0       # model.lambda_loss_obj
    joint_training: bool = True
    desc_loss_type: str = "sparse"  # "sparse" | "infonce"
    det_loss_type: str = "bce"     # "bce" | "ce"
    num_samples_per_image: int = 1000
    num_masked_non_matches_per_match: int = 120


def rescale_yolo_gains(cfg: ObjectLossConfig, nc: int, img_size: int, nl: int = 3) -> ObjectLossConfig:
    """Train-time gain rescaling by the level count, classes and image size."""
    return dataclasses.replace(cfg, box=cfg.box * 3.0 / nl, cls=cfg.cls * nc / 80.0,
                               obj=cfg.obj * (img_size / 640.0) ** 2 * 3.0 / nl)


def draw_step(gen: torch.Generator, image_shape, aug_config: Mapping[str, Any],
              weights: LossWeights, cell: int = 8) -> dict:
    """Every random sample of one micro-step for images of `image_shape`
    `(B, H, W, C)`: `{"aug": ..., "desc": ...}`."""
    B, H, W, _ = image_shape
    draws = {"aug": draw_training_views(gen, tuple(image_shape), aug_config)}
    if weights.joint_training:
        draws["desc"] = draw_descriptor_samples(
            gen, B, H // cell, W // cell, weights.num_samples_per_image,
            weights.num_masked_non_matches_per_match)
    return draws


def losses_from_outputs(out, out_w, base, warped, desc_samples, obj_cfg: ObjectLossConfig,
                        weights: LossWeights, anchors_per_stride, nc: int):
    """All joint losses from the two forwards (NHWC `semi`/`desc`, raw
    Detect levels), reduced in f32. Returns `(total, aux)`."""
    det_fn = detector_loss_ce if weights.det_loss_type == "ce" else detector_loss
    loss_det = det_fn(out["semi"].float(), labels_to_cells(base.labels_2d),
                      cell_valid_mask(base.valid_mask))
    loss_det_warp = det_fn(out_w["semi"].float(), labels_to_cells(warped.labels_2d),
                           cell_valid_mask(warped.valid_mask))
    zero = torch.zeros((), device=loss_det.device)
    if "objects" in out and weights.lambda_obj > 0:
        loss_obj, obj_items = object_loss([p.float() for p in out["objects"]], base.boxes,
                                          base.box_mask, anchors_per_stride, obj_cfg, nc)
    else:
        loss_obj, obj_items = zero, {"box": zero, "obj": zero, "cls": zero}
    if weights.joint_training:
        desc_fn = infonce_loss if weights.desc_loss_type == "infonce" else descriptor_loss_sparse
        loss_desc = desc_fn(out["desc"].float(), out_w["desc"].float(), warped.valid_mask,
                            warped.inv_homography, desc_samples)
    else:
        loss_desc = zero
    total = (loss_det + loss_det_warp) + weights.lambda_desc * loss_desc \
        + weights.lambda_obj * loss_obj
    aux = {
        "loss": total,
        "loss_det": loss_det + loss_det_warp,
        "loss_desc": weights.lambda_desc * loss_desc,
        "loss_obj": weights.lambda_obj * loss_obj,
        **{f"obj_{k}": v for k, v in obj_items.items()},
    }
    return total, aux


def _nhwc(out: dict) -> dict:
    return dict(out, semi=out["semi"].permute(0, 2, 3, 1), desc=out["desc"].permute(0, 2, 3, 1))


def _views(batch: Mapping[str, torch.Tensor], draws: Mapping, aug_config: Mapping[str, Any]):
    with torch.no_grad():
        return build_training_views(
            batch["image"], batch["points"], batch["point_mask"], batch["boxes"],
            batch["box_mask"], aug_config, draws["aug"],
            crop_yx=batch.get("mosaic_crop_yx", batch.get("crop_yx")),
            mosaic="mosaic_crop_yx" in batch)


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    return torch.autocast(device.type, dtype=compute_dtype) \
        if compute_dtype != torch.float32 else contextlib.nullcontext()


def compute_losses(model: torch.nn.Module, batch: Mapping[str, torch.Tensor], draws: Mapping,
                   aug_config: Mapping[str, Any], obj_cfg: ObjectLossConfig, weights: LossWeights,
                   anchors_per_stride, nc: int, compute_dtype: torch.dtype = torch.float32,
                   on_phase: Optional[Callable[[str], None]] = None):
    """Augment, forward both views in train mode, and the losses.

    `batch` holds device tensors: image `(B, H, W, 3)` u8 or f32 in [0, 1],
    points `(B, N, 2)`, point_mask `(B, N)`, boxes `(B, M, 5)`, box_mask
    `(B, M)`. `on_phase("augment")` is called once the views are built.
    Returns `(total, aux)`.
    """
    base, warped = _views(batch, draws, aug_config)
    if on_phase is not None:
        on_phase("augment")
    model.train()
    with _autocast(base.image.device, compute_dtype):
        # NHWC views -> NCHW for the convolutions (one copy of each batch)
        out = _nhwc(model(base.image.permute(0, 3, 1, 2).contiguous()))
        out_w = _nhwc(model(warped.image.permute(0, 3, 1, 2).contiguous()))
    return losses_from_outputs(out, out_w, base, warped, draws.get("desc"), obj_cfg, weights,
                               anchors_per_stride, nc)


def _bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]


def make_train_step(model: torch.nn.Module, aug_config: Mapping[str, Any],
                    obj_cfg: ObjectLossConfig, weights: LossWeights, nc: int,
                    ema_decay: float = 0.9999, ema_tau: float = 2000.0, accum: int = 1,
                    compute_dtype: torch.dtype = torch.float32):
    """The train step `step(state, batch, draws, on_phase=None) -> aux`.

    It updates `state` in place (parameters, BatchNorm statistics, optimizer
    state, step count, EMA). A micro-step whose loss, gradients or new
    BatchNorm statistics are not all finite changes nothing, and reports
    `nonfinite_skip = 1`. The EMA counts optimizer updates (`step // accum`)
    and moves only on micro-steps that apply one. `on_phase` is called with
    "augment", "forward_backward" and "optimizer" as each phase is queued.
    """
    anchors_ps = model.Detect.anchors_per_stride()

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], draws: Mapping,
             on_phase: Optional[Callable[[str], None]] = None) -> dict:
        params = [p for p in state.model.parameters()]
        stats = _bn_buffers(state.model)
        saved_stats = [s.clone() for s in stats]
        for p in params:
            p.grad = None
        total, aux = compute_losses(state.model, batch, draws, aug_config, obj_cfg, weights,
                                    anchors_ps, nc, compute_dtype, on_phase)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if on_phase is not None:
            on_phase("forward_backward")
        checks = [torch.isfinite(total)] + [torch.isfinite(t).all() for t in grads + stats]
        finite = bool(torch.stack(checks).all())
        if finite:
            updated = state.optimizer.update(grads)
            state.step += 1
            if updated and state.ema_params is not None:
                ema_update(state.ema_params, dict(state.model.named_parameters()),
                           state.step // accum, decay=ema_decay, tau=ema_tau)
        else:
            torch._foreach_copy_(stats, saved_stats)
        for p in params:
            p.grad = None
        if on_phase is not None:
            on_phase("optimizer")
        aux = {k: v.detach() for k, v in aux.items()}
        aux["nonfinite_skip"] = torch.tensor(0.0 if finite else 1.0)
        return aux

    return step


def make_val_step(model: torch.nn.Module, aug_config: Mapping[str, Any], obj_cfg: ObjectLossConfig,
                  weights: LossWeights, nc: int, kpt_conf: float = 0.015, kpt_nms: int = 4,
                  kpt_topk: int = 1000, box_conf: float = 0.001, box_iou: float = 0.6,
                  max_det: int = 300, max_nms: int = 30000,
                  compute_dtype: torch.dtype = torch.float32):
    """The val step `val_step(params, batch, draws, on_phase=None) -> dict`.

    It builds the views from `draws` (`draw_step` under `aug_config`, the
    config's `data.val_augmentation`), runs both forwards in eval mode with
    `params` (a name -> tensor dict such as the EMA shadow; None: the
    model's own) and the model's BatchNorm statistics, computes the losses
    and decodes both views: heatmap -> `extract_keypoints` -> descriptors
    at the keypoints -> `batched_box_nms` on the decoded predictions
    (multi-label when `nc > 1`). Returns the JAX val step's keys: `losses`,
    `base` and `warped` (`heatmap`, `pts`, `scores`, `valid`, `desc`,
    `det`), `image`, `boxes`, `box_mask`, `labels_2d`, `homography`,
    `inv_homography`. `on_phase` is called with "views", "forward",
    "losses", then per view "keypoints", "descriptors" and "box_nms", as
    each phase is queued.
    """
    anchors_ps = model.Detect.anchors_per_stride()
    strides = model.Detect.strides

    def decode(out, mark):
        heat = cells_to_heatmap(out["semi"].float())
        pts, scores, valid = extract_keypoints(heat, kpt_conf, kpt_nms, kpt_topk)
        mark("keypoints")
        desc = sample_descriptors(out["desc"].float().contiguous(), pts)
        mark("descriptors")
        det = batched_box_nms(decode_levels(out["objects"], anchors_ps, strides),
                              conf_thres=box_conf, iou_thres=box_iou, max_det=max_det,
                              max_nms=max_nms, multi_label=nc > 1)
        mark("box_nms")
        return {"heatmap": heat, "pts": pts, "scores": scores, "valid": valid, "desc": desc,
                "det": det}

    @torch.no_grad()
    def val_step(params: Optional[Mapping[str, torch.Tensor]], batch: Mapping[str, torch.Tensor],
                 draws: Mapping, on_phase: Optional[Callable[[str], None]] = None) -> dict:
        mark = on_phase or (lambda name: None)
        base, warped = _views(batch, draws, aug_config)
        mark("views")
        model.eval()

        def forward(image):
            x = image.permute(0, 3, 1, 2).contiguous()
            return _nhwc(model(x) if params is None
                         else torch.func.functional_call(model, dict(params), (x,)))

        with _autocast(base.image.device, compute_dtype):
            out, out_w = forward(base.image), forward(warped.image)
        mark("forward")
        _, losses = losses_from_outputs(out, out_w, base, warped, draws.get("desc"), obj_cfg,
                                        weights, anchors_ps, nc)
        mark("losses")
        return {
            "losses": losses,
            "base": decode(out, mark),
            "warped": decode(out_w, mark),
            "image": base.image,
            "boxes": base.boxes,
            "box_mask": base.box_mask,
            "labels_2d": base.labels_2d,
            "homography": warped.homography,
            "inv_homography": warped.inv_homography,
        }

    return val_step
