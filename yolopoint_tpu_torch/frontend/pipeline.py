"""The serving pipeline: forward + heatmap + keypoints + box NMS + descriptors.

Counterpart of `yolopoint_tpu/frontend/pipeline.py` (`preprocess_frame`,
`InferencePipeline`): the same config keys and the same fixed-shape outputs.
Images are NHWC `(B, H, W, C)` (uint8, or float in [0, 1]) with H, W
multiples of 32; the model runs NCHW. The decode runs on the device of the
model's outputs, through the kernels K1 (keypoint NMS), K2 (box NMS) and K3
(descriptor sampling) on the GPU and their plain versions on the CPU. The box
outputs (and `filter_pts_in_boxes`) exist only for a model whose outputs
hold `"objects"` (a Detect head); for `YOLOPointDet` and `SuperPointNet`
the result holds the keypoint and descriptor keys alone, as in the JAX
pipeline. `sharded()` serves a global batch data-parallel over the ranks of
a `parallel.mesh.Mesh`. `deploy_model` builds the model the serving entry
points (the demo, the serving-artifact CLI, the HPatches runner) run.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import fold_batch_norm, is_folded, load_weights
from yolopoint_tpu_torch.ops.heatmap import cells_to_heatmap
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints
from yolopoint_tpu_torch.ops.nms import fused_detect_nms
from yolopoint_tpu_torch.ops.resize import resize_like_cv2
from yolopoint_tpu_torch.ops.sampling import sample_descriptors
from yolopoint_tpu_torch.parallel.mesh import Mesh, all_gather_rows, make_mesh, shard_batch
from yolopoint_tpu_torch.utils.device import resolve_device


def preprocess_frame(
    img: np.ndarray, img_size: Optional[int] = None, stride: int = 32
) -> tuple[np.ndarray, tuple[int, int], float]:
    """Resize so the longer side is `img_size` (if given), then center-crop
    to a stride multiple. Returns (float image in [0, 1], (top, left) crop
    offset, resize ratio). The resize is `ops.resize`, OpenCV's
    `INTER_AREA` (shrinking) or `INTER_LINEAR` (enlarging) in torch, on the
    host."""
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    ratio = 1.0
    if img_size:
        ratio = img_size / max(h, w)
        if ratio != 1.0:
            size = (int(round(w * ratio)), int(round(h * ratio)))
            img = resize_like_cv2(torch.from_numpy(np.ascontiguousarray(img)), size, ratio).numpy()
            h, w = img.shape[:2]
    hc, wc = (h // stride) * stride, (w // stride) * stride
    top, left = (h - hc) // 2, (w - wc) // 2
    img = img[top:top + hc, left:left + wc]
    if img.ndim == 2:
        img = img[..., None]
    return np.ascontiguousarray(img, np.float32), (top, left), ratio


def _points_in_boxes(points: torch.Tensor, boxes: torch.Tensor, box_valid: torch.Tensor):
    """(B, N) True where a point lies inside any valid box."""
    x, y = points[..., 0:1], points[..., 1:2]  # (B, N, 1)
    inside = ((x >= boxes[:, None, :, 0]) & (x <= boxes[:, None, :, 2])
              & (y >= boxes[:, None, :, 1]) & (y <= boxes[:, None, :, 3]))
    return (inside & box_valid[:, None, :]).any(dim=2)


class InferencePipeline:
    """Forward + decode for NHWC image batches.

    Args:
      model: a model of `models.build_model` with its weights loaded.
      config: keypoint/box operating points, the JAX pipeline's keys:
        detection_threshold, nms, top_k, border_remove, conf_thresh,
        iou_thresh, max_det, max_nms, heatmap_dtype ("f32" | "bf16"),
        filter_pts_in_boxes, exact_descriptors (accepted; sampling is always
        the exact f32 K3), return_heatmap.
      compute_dtype: dtype of the conv stack (the model is cast to it).
      device: where the model runs; default the GPU.
    """

    def __init__(self, model: torch.nn.Module, config: Optional[Mapping[str, Any]] = None,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        cfg = dict(config or {})
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.model = model.to(device=self.device, dtype=compute_dtype).eval()
        self.conf_thresh = float(cfg.get("detection_threshold", 0.015))
        self.nms_radius = int(cfg.get("nms", 4))
        self.top_k = int(cfg.get("top_k", 1000))
        self.border = int(cfg.get("border_remove", 4))
        self.box_conf = float(cfg.get("conf_thresh", 0.25))
        self.box_iou = float(cfg.get("iou_thresh", 0.45))
        self.max_det = int(cfg.get("max_det", 300))
        self.max_nms = int(cfg.get("max_nms", 1024))
        bf16 = str(cfg.get("heatmap_dtype", "f32")).lower() in ("bf16", "bfloat16")
        self.heatmap_dtype = torch.bfloat16 if bf16 else torch.float32
        self.filter_pts_in_boxes = bool(cfg.get("filter_pts_in_boxes", False))
        self.return_heatmap = bool(cfg.get("return_heatmap", False))
        # decode tables of the box path, for a model with a Detect head
        detect = getattr(model, "Detect", None)
        self._anchors_ps, self._strides = (
            (detect.anchors_per_stride(), detect.strides) if detect is not None else (None, None))

    def forward(self, images: torch.Tensor) -> dict:
        """The model's raw outputs for an NHWC batch already on the device."""
        if images.dtype == torch.uint8:
            images = images.to(self.compute_dtype) / 255.0
        return self.model(images.to(self.compute_dtype).permute(0, 3, 1, 2))

    def decode(self, out: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        """Keypoints, boxes and descriptors from the model's raw outputs,
        on the device they lie on."""
        heat = cells_to_heatmap(out["semi"].float().permute(0, 2, 3, 1), dtype=self.heatmap_dtype)
        pts, scores, valid = extract_keypoints(
            heat, self.conf_thresh, self.nms_radius, self.top_k, self.border
        )
        result = {"keypoints": pts, "kp_scores": scores, "kp_valid": valid}
        if self.return_heatmap:
            result["heatmap"] = heat
        if "objects" in out:
            det = fused_detect_nms(
                out["objects"], self._anchors_ps, self._strides,
                conf_thres=self.box_conf, iou_thres=self.box_iou,
                max_det=self.max_det, max_nms=self.max_nms,
            )
            result.update(
                boxes=det["boxes"], box_scores=det["scores"], box_classes=det["classes"],
                box_valid=det["valid"], box_n_candidates=det["n_candidates"],
            )
            if self.filter_pts_in_boxes:
                result["kp_valid"] = valid & ~_points_in_boxes(pts, det["boxes"], det["valid"])
        desc = out["desc"].permute(0, 2, 3, 1).contiguous()
        result["descriptors"] = sample_descriptors(desc, pts)
        return result

    @torch.inference_mode()
    def __call__(self, images) -> dict[str, torch.Tensor]:
        """Run on a `(B, H, W, C)` batch (numpy or tensor, uint8 or float)."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        return self.decode(self.forward(images))

    def sharded(self, mesh: Optional[Mesh] = None):
        """Data-parallel serving: `fn(images)` runs this rank's rows of a
        global `(B, H, W, C)` batch (B a multiple of the world size) and
        all-gathers the fixed-shape outputs, so every rank returns the
        outputs of the whole batch. With equal weights and inputs they are
        `self(images)`'s. Every rank calls `fn` together. `mesh` defaults
        to the process group's (`parallel.mesh.make_mesh`)."""
        mesh = mesh or make_mesh(self.device)

        def fn(images) -> dict[str, torch.Tensor]:
            out = self(shard_batch(torch.as_tensor(images), mesh))
            return {k: all_gather_rows(v, mesh) for k, v in out.items()}

        return fn

    def process_frame(self, frame: np.ndarray, img_size: Optional[int] = None):
        """One frame: preprocess, run, and shift coordinates back into the
        original frame. Returns numpy arrays."""
        img, (top, left), ratio = preprocess_frame(frame, img_size)
        out = {k: v[0].float().cpu().numpy() if v.is_floating_point() else v[0].cpu().numpy()
               for k, v in self(img[None]).items()}
        out["keypoints"] = (out["keypoints"] + np.array([left, top])) / ratio
        if "boxes" in out:
            out["boxes"] = (out["boxes"] + np.array([left, top, left, top])) / ratio
        return out


def deploy_model(weights: Optional[str], model_name: str, version: str, nc: Optional[int],
                 f32: bool, device=None):
    """`(model on the CPU, compute dtype, names, nc)` of a serving entry
    point: the model of `weights`, anything `models.convert.load_weights`
    reads (a reference-schema checkpoint, a port run, an orbax run or
    checkpoint of the JAX package; architecture, version and names from its
    metadata; the number of names, or `nc` where it has none, or 1 where
    `nc` is None), read as a run on `device` reads it (default the GPU), or
    without `weights` `model_name`/`version` with `nc` (None: 80) classes
    under torch's default initialization at seed 0. BN folded and bf16
    unless `f32`."""
    names = None
    if weights:
        loaded = load_weights(weights, device)
        state, meta = loaded["state_dict"], loaded["meta"]
        names = meta.get("names")
        model_name = meta.get("model_name", model_name)
        version = meta.get("version", version)
        nc = max(len(names or []), 1) if nc is None else (len(names or []) or nc)
    else:
        nc = 80 if nc is None else nc
        torch.manual_seed(0)
        state = build_model(model_name, version, nc=nc, device="cpu").state_dict()
    if not f32 and not is_folded(state):
        state = fold_batch_norm(state)
    model = build_model(model_name, version, nc=nc, fused=is_folded(state), device="cpu")
    model.load_state_dict(state)
    return model, (torch.float32 if f32 else torch.bfloat16), names, nc
