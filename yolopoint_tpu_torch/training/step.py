"""The joint training step, on one device or data-parallel over ranks.

Counterpart of `yolopoint_tpu/training/step.py` (`LossWeights`,
`rescale_yolo_gains`, `losses_from_outputs`, `compute_losses`,
`make_train_step`, `make_val_step`, `make_multi_step`,
`make_device_multi_step`, `stack_batches`), without `remat`:

  augmentation (photometric + homographic warped pair, no gradient)
  -> train-mode forward(base), then forward(warped), which sees the
     BatchNorm statistics the first one updated
  -> detector loss x2 + YOLOv5 object loss + descriptor loss, in f32
  -> total = (det + det_warp) + lambda * desc + lambda_obj * obj
  -> backward -> [the mean over ranks] -> non-finite guard -> optimizer
     (with accumulation) -> EMA.

Data parallelism is the JAX step's `shard_map` branch: each rank runs the
step on its rows of the global batch with draws of its own, then one
coalesced all-reduce (`parallel.mesh.all_reduce_mean`) averages the
gradients, the scalars and the new BatchNorm running statistics, and the
non-finite guard decides on the averaged values, so every rank applies or
skips a micro-step together and the ranks' states stay equal. At world size
1 no collective is called.

`make_multi_step` / `make_device_multi_step` run K micro-steps a dispatch
over a stacked batch (or `(K, B)` rows into the device-resident set), each
with its own draws, and return the scalars stacked `(K,)`: the JAX `scan`
as a Python loop, not one CUDA graph.

Mixed precision is `torch.autocast` in the compute dtype around the two
forwards only; parameters, BatchNorm and the losses stay f32.

The val step (`make_val_step`) builds the views the same way, runs both
forwards in eval mode, the same losses, and decodes both views: keypoints
(K1, or K6 where the map is no tile multiple), descriptors (K3) and
multi-label box NMS at the val protocol's conf 0.001 and 30000 candidates
(K2 inside the exact tiled scan).

Randomness is drawn apart from the step (`draw_step`), so that a caller
can feed the same samples to two devices or to the JAX package.

A host-warped batch (`data.host_augment`: `precomputed_*` keys, a
zero-channel `image` stub) builds its views from the loader's warps, so no
image warp runs in the step. A model without a Detect head (YOLOPointDet,
SuperPointNet) has no object loss, and its val step decodes no boxes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.data.augmentation import (
    PRECOMPUTED_KEYS,
    build_training_views,
    draw_training_views,
    view_hw,
)
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
from yolopoint_tpu_torch.parallel.mesh import Mesh, all_reduce_mean
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
              weights: LossWeights, cell: int = 8, crop: bool = False,
              mosaic: bool = False, precomputed: bool = False) -> dict:
    """Every random sample of one micro-step for images of `image_shape`
    `(B, H, W, C)` (`draw_shape`): `{"aug": ..., "desc": ...}`. In `crop`
    mode (the batch has a crop corner; a `mosaic` batch always has one) the
    views, and so the descriptor map whose cells the loss draws, are the
    crop's; a `precomputed` (host-warped) batch draws no homographies."""
    B, H, W, _ = image_shape
    draws = {"aug": draw_training_views(gen, tuple(image_shape), aug_config, crop=crop,
                                        mosaic=mosaic, precomputed=precomputed)}
    if weights.joint_training:
        hc, wc = view_hw((H, W), aug_config, crop=crop, mosaic=mosaic)
        draws["desc"] = draw_descriptor_samples(
            gen, B, hc // cell, wc // cell, weights.num_samples_per_image,
            weights.num_masked_non_matches_per_match)
    return draws


def batch_mode(batch: Mapping[str, Any]) -> dict:
    """`draw_step`'s `crop`, `mosaic` and `precomputed` flags for a batch,
    from its keys."""
    mosaic = "mosaic_crop_yx" in batch
    return {"crop": mosaic or "crop_yx" in batch, "mosaic": mosaic,
            "precomputed": "precomputed_h1" in batch}


def draw_shape(batch: Mapping[str, Any]) -> tuple:
    """The `(B, H, W, C)` a batch's draws are made for: its frame, with the
    views' channel count for a host-warped batch (whose `image` is a
    zero-channel stub)."""
    B, H, W, C = batch["image"].shape
    if "precomputed_image_base" in batch:
        C = batch["precomputed_image_base"].shape[-1]
    return (B, H, W, C)


def precomputed_views(batch: Mapping[str, Any]) -> Optional[dict]:
    """The host-warp payload of a batch for `build_training_views`, or None."""
    if "precomputed_h1" not in batch:
        return None
    return {k: batch[f"precomputed_{k}"] for k in PRECOMPUTED_KEYS}


def anchors_of(model: torch.nn.Module):
    """The model's anchors per stride, or None for a family without a Detect head."""
    detect = getattr(model, "Detect", None)
    return None if detect is None else detect.anchors_per_stride()


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
            mosaic="mosaic_crop_yx" in batch, precomputed=precomputed_views(batch))


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
    `(B, M)`, and for a host-warped batch the `precomputed_*` views.
    `on_phase("augment")` is called once the views are built.
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
                    compute_dtype: torch.dtype = torch.float32, mesh: Optional[Mesh] = None):
    """The train step `step(state, batch, draws, on_phase=None) -> aux`.

    It updates `state` in place (parameters, BatchNorm statistics, optimizer
    state, step count, EMA). A micro-step whose loss, gradients or new
    BatchNorm statistics are not all finite changes nothing, and reports
    `nonfinite_skip = 1`. The EMA counts optimizer updates (`step // accum`)
    and moves only on micro-steps that apply one. `on_phase` is called with
    "augment", "forward_backward" and "optimizer" as each phase is queued.
    With a `mesh` of more than one rank, `batch` is this rank's rows and
    `draws` this rank's; the gradients, scalars and new BatchNorm
    statistics are averaged over the ranks before the guard (the JAX
    step's `pmean`s). Each micro-step is a `torch.profiler` range named
    "micro_step".
    """
    anchors_ps = anchors_of(model)
    data_parallel = mesh is not None and mesh.size > 1

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], draws: Mapping,
             on_phase: Optional[Callable[[str], None]] = None) -> dict:
        with torch.profiler.record_function("micro_step"):
            return _step(state, batch, draws, on_phase)

    def _step(state, batch, draws, on_phase):
        params = [p for p in state.model.parameters()]
        stats = _bn_buffers(state.model)
        saved_stats = [s.clone() for s in stats]
        for p in params:
            p.grad = None
        total, aux = compute_losses(state.model, batch, draws, aug_config, obj_cfg, weights,
                                    anchors_ps, nc, compute_dtype, on_phase)
        total.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if data_parallel:
            names = list(aux)
            scalars = torch.stack([aux[k].detach().float() for k in names])
            all_reduce_mean(grads + stats + [scalars], mesh)
            aux = dict(zip(names, scalars.unbind(0)))
            total = aux["loss"]
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
    (multi-label when `nc > 1`; a model without a Detect head has none).
    Returns the JAX val step's keys: `losses`, `base` and `warped`
    (`heatmap`, `pts`, `scores`, `valid`, `desc`, and `det` with a Detect
    head), `image`, `boxes`, `box_mask`, `labels_2d`, `homography`,
    `inv_homography`. `on_phase` is called with "views", "forward",
    "losses", then per view "keypoints", "descriptors" and (with a Detect
    head) "box_nms", as each phase is queued.
    """
    anchors_ps = anchors_of(model)

    def decode(out, mark):
        heat = cells_to_heatmap(out["semi"].float())
        pts, scores, valid = extract_keypoints(heat, kpt_conf, kpt_nms, kpt_topk)
        mark("keypoints")
        desc = sample_descriptors(out["desc"].float().contiguous(), pts)
        mark("descriptors")
        result = {"heatmap": heat, "pts": pts, "scores": scores, "valid": valid, "desc": desc}
        if "objects" in out:
            result["det"] = batched_box_nms(
                decode_levels(out["objects"], anchors_ps, model.Detect.strides),
                conf_thres=box_conf, iou_thres=box_iou, max_det=max_det, max_nms=max_nms,
                multi_label=nc > 1)
            mark("box_nms")
        return result

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


def stack_aux(auxes: list[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Micro-steps' scalars stacked `(K,)` in f32, on the device of their `loss`."""
    device = auxes[0]["loss"].device
    return {k: torch.stack([torch.as_tensor(a[k], dtype=torch.float32).to(device)
                            for a in auxes]) for k in auxes[0]}


def make_multi_step(step_fn, scan_steps: int):
    """K = `scan_steps` micro-steps of `step_fn` (`make_train_step`) in one
    dispatch: `multi(state, stacked_batch, draws) -> aux`, where every leaf of
    `stacked_batch` has a leading K dim (`stack_batches`) and `draws` holds
    each micro-step's draws in order (the JAX `fold_in(rng, i)` keys'
    counterpart). The micro-steps run in order on `state` (in place); `aux`
    holds their scalars stacked `(K,)`. A Python loop: the micro-steps are
    not captured in one CUDA graph."""

    def multi(state: TrainState, stacked_batch: Mapping[str, torch.Tensor],
              draws: list) -> dict:
        if len(draws) != scan_steps:
            raise ValueError(f"{len(draws)} draws for {scan_steps} micro-steps")
        return stack_aux([step_fn(state, {k: v[i] for k, v in stacked_batch.items()}, draws[i])
                          for i in range(scan_steps)])

    return multi


def make_device_multi_step(step_fn, scan_steps: int):
    """K micro-steps in one dispatch, each gathering its batch from the
    device-resident arrays (`data.device_data.DeviceDataLoader.
    resident_data`): `multi(state, data, idx, draws) -> aux`, with `idx`
    `(K, B)` integer rows into `data` (a rank's columns of the global rows
    under data parallelism) and `draws` as `make_multi_step` takes them."""

    def multi(state: TrainState, data: Mapping[str, torch.Tensor], idx, draws: list) -> dict:
        idx = torch.as_tensor(idx).long()
        if idx.shape[0] != scan_steps or len(draws) != scan_steps:
            raise ValueError(f"{idx.shape[0]} rows and {len(draws)} draws for {scan_steps} "
                             "micro-steps")
        auxes = []
        for i in range(scan_steps):
            rows = idx[i].to(next(iter(data.values())).device, non_blocking=True)
            auxes.append(step_fn(state, {k: torch.index_select(v, 0, rows)
                                         for k, v in data.items()}, draws[i]))
        return stack_aux(auxes)

    return multi


def stack_batches(batches) -> dict:
    """Same-shape batch dicts stacked on a new leading dim (numpy or torch)."""
    return {k: torch.stack([b[k] for b in batches]) if isinstance(batches[0][k], torch.Tensor)
            else np.stack([b[k] for b in batches]) for k in batches[0]}
