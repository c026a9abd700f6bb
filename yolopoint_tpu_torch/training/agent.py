"""TrainAgent: a config dict -> model, optimizer, train and val steps, and loops.

Counterpart of `TrainAgent` in `yolopoint_tpu/training/agent.py`, on one
device: `__init__` builds the run from the YAML schema (model, bf16
compute, gain rescaling, loss selection, optimizer with accumulation to a
nominal batch of 64, EMA, the val step); `train(steps)` runs micro-steps
over any iterable of batch dicts; `validate(batches, epoch)` returns the
JAX agent's validation scalars. Checkpoints, the epoch loop, plots, the
metrics writer and the CLI are not ported yet.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from yolopoint_tpu_torch.evaluation.descriptor_eval import compute_homography_correctness
from yolopoint_tpu_torch.evaluation.detector_eval import batch_precision_recall, compute_repeatability
from yolopoint_tpu_torch.evaluation.yolo_eval import (
    ConfusionMatrix,
    ap_per_class,
    combined_fitness,
    fitness_yolo,
    process_batch,
)
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.ops.boxes import xywhn2xyxy
from yolopoint_tpu_torch.training.state import (
    REFERENCE_MODULE_ORDER,
    create_train_state,
    freeze_mask_from_spec,
    make_optimizer,
)
from yolopoint_tpu_torch.training.step import (
    BATCH_KEYS,
    LossWeights,
    draw_step,
    make_train_step,
    make_val_step,
    rescale_yolo_gains,
)
from yolopoint_tpu_torch.utils.device import resolve_device


def _get(config: Mapping, dotted: str, default=None):
    node: Any = config
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node


class TrainAgent:
    """Builds a training run from a reference-schema config dict.

    `train_loader` is any iterable of batch dicts (numpy or torch: image
    `(B, H, W, 3)` u8 or f32, points `(B, N, 2)`, point_mask `(B, N)`, boxes
    `(B, M, 5)`, box_mask `(B, M)`); its `len()`, where it has one, is the
    number of micro-steps per epoch of the LR schedule. `seed` seeds the
    model's initial weights and the augmentation draws.
    """

    def __init__(self, config: Mapping[str, Any], train_loader: Iterable, seed: int = 0,
                 device: str | torch.device | None = None):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.train_loader = train_loader
        self.names = list(config.get("names", []))
        self.nc = max(len(self.names), 1)
        model_cfg = config.get("model", {})
        tp = config.get("training_params", {})
        dtype_name = str(model_cfg.get("dtype", tp.get("dtype", "float32"))).lower()
        self.compute_dtype = torch.bfloat16 if dtype_name in ("bf16", "bfloat16") else torch.float32

        torch.manual_seed(seed)
        self.model = build_model(model_cfg.get("name", "YOLOPoint"), model_cfg.get("version", "s"),
                                 nc=self.nc, device=self.device).train()

        epochs = int(tp.get("epochs", 100))
        batch_size = int(tp.get("train_batch_size", 8))
        # nominal batch 64 by gradient accumulation
        self.accum = max(round(64 / batch_size), 1)
        # a loader without a length gets the JAX package's make_optimizer default
        steps_per_epoch = len(train_loader) if hasattr(train_loader, "__len__") else 1000
        trainable_mask = None
        if spec := config.get("freeze_layers"):
            names = [n for n, _ in self.model.named_parameters()]
            trainable_mask = freeze_mask_from_spec(
                names, str(spec), REFERENCE_MODULE_ORDER.get(model_cfg.get("name", "YOLOPoint")))
        self.optimizer = make_optimizer(
            self.model,
            learning_rate=float(tp.get("learning_rate", 1e-3)),
            lrf=float(tp.get("lrf", 0.1)),
            total_epochs=epochs,
            # the schedule counts optimizer updates, one per `accum` micro-steps
            steps_per_epoch=max(steps_per_epoch // self.accum, 1),
            grad_clip=float(tp["gradclip"]) if tp.get("gradclip") else None,
            accumulate_steps=self.accum,
            trainable_mask=trainable_mask,
            weight_decay=float(tp.get("weight_decay", 0.0)),
        )
        ema_cfg = tp.get("ema") or {}
        if not isinstance(ema_cfg, Mapping):
            ema_cfg = {"enable": bool(ema_cfg)}

        img_size = int(_get(config, "data.preprocessing.img_size", 640))
        sp = _get(config, "model.superpoint", {}) or {}
        yolo = _get(config, "model.yolo", {}) or {}
        obj_cfg = ObjectLossConfig(
            box=float(yolo.get("box", 0.05)), obj=float(yolo.get("obj", 1.0)),
            cls=float(yolo.get("cls", 0.5)), cls_pw=float(yolo.get("cls_pw", 1.0)),
            obj_pw=float(yolo.get("obj_pw", 1.0)), anchor_t=float(yolo.get("anchor_t", 4.0)),
            label_smoothing=float(yolo.get("label_smoothing", 0.0)),
            fl_gamma=float(yolo.get("fl_gamma", 0.0)),
        )
        self.obj_cfg = rescale_yolo_gains(obj_cfg, self.nc, img_size)
        sparse_cfg = sp.get("sparse_loss", {}) or {}
        sparse = sparse_cfg.get("params", sparse_cfg)
        # the reference's active descriptor loss is InfoNCE, hence the default
        desc_loss_type = str(sp.get("desc_loss", sparse_cfg.get("name", "infonce"))).lower()
        if desc_loss_type not in ("sparse", "infonce"):
            raise ValueError(f"desc_loss must be 'sparse' or 'infonce', got {desc_loss_type!r}")
        det_loss_type = str(sp.get("det_loss", "bce")).lower()
        if det_loss_type not in ("bce", "ce"):
            raise ValueError(f"det_loss must be 'bce' or 'ce', got {det_loss_type!r}")
        self.weights = LossWeights(
            lambda_desc=float(_get(config, "model.lambda_loss", 0.1)),
            lambda_obj=float(_get(config, "model.lambda_loss_obj", 10.0)),
            joint_training=bool(config.get("joint_training", True)),
            desc_loss_type=desc_loss_type,
            det_loss_type=det_loss_type,
            num_samples_per_image=int(sparse.get("num_samples_per_image", 1000)),
            num_masked_non_matches_per_match=int(sparse.get("num_masked_non_matches_per_match", 120)),
        )
        self.aug_config = _get(config, "data.augmentation", {}) or {}
        self.state = create_train_state(self.model, self.optimizer,
                                        ema=bool(ema_cfg.get("enable", False)))
        self.train_step = make_train_step(
            self.model, self.aug_config, self.obj_cfg, self.weights, self.nc,
            ema_decay=float(ema_cfg.get("decay", 0.9999)), ema_tau=float(ema_cfg.get("tau", 2000.0)),
            accum=self.accum, compute_dtype=self.compute_dtype,
        )
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        val_aug = _get(config, "data.val_augmentation", None)
        self.val_aug_config = val_aug if val_aug is not None else self.aug_config
        self.val_step = make_val_step(
            self.model, self.val_aug_config, self.obj_cfg, self.weights, self.nc,
            kpt_conf=float(sp.get("detection_threshold", 0.015)), kpt_nms=int(sp.get("nms", 4)),
            kpt_topk=int(sp.get("top_k", 1000)), box_conf=float(yolo.get("conf_thresh", 0.001)),
            box_iou=float(yolo.get("iou_thresh", 0.6)), compute_dtype=self.compute_dtype,
        )
        self.val_seed = int(config.get("val_seed", 42))
        self.extended_val_n = int(config.get("extended_val_sample_size", 10))

    def to_device(self, batch: Mapping[str, Any]) -> dict:
        """The batch's tensors on the agent's device."""
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS + ("crop_yx", "mosaic_crop_yx") if k in batch}

    def step(self, batch: Mapping[str, Any], on_phase=None) -> dict:
        """One micro-step on `batch`, with fresh draws from the agent's generator."""
        batch = self.to_device(batch)
        draws = draw_step(self.gen, tuple(batch["image"].shape), self.aug_config, self.weights)
        return self.train_step(self.state, batch, draws, on_phase)

    def train(self, steps: int, on_phase=None) -> list[dict]:
        """Run `steps` micro-steps over the loader (restarting it as needed);
        returns each step's losses as floats."""
        history: list[dict] = []
        while len(history) < steps:
            n_before = len(history)
            for batch in self.train_loader:
                aux = self.step(batch, on_phase)
                history.append({k: float(v) for k, v in aux.items()})
                if len(history) >= steps:
                    break
            if len(history) == n_before:
                raise ValueError("the train loader yielded no batch")
        return history

    def val_draws(self, batch_index: int, image_shape) -> dict:
        """The random samples of val batch `batch_index`: a generator seeded
        by `(val_seed, batch_index)`, so every validation sees the same views."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.val_seed * 1_000_003 + batch_index)
        return draw_step(gen, tuple(image_shape), self.val_aug_config, self.weights)

    def validate(self, batches: Iterable, epoch: int = 0, on_phase=None) -> dict[str, float]:
        """Validation over `batches` (batch dicts as `train` takes them): the
        val losses, point precision and recall of the base heatmap, the YOLO
        mAP stack at the protocol's conf 0.001, and on the first
        `extended_val_sample_size` images the repeatability and homography
        correctness linking the decoded base view to its warped pair. Uses
        the EMA weights where they exist. Returns the JAX agent's scalars
        (plots and the metrics writer are not ported). `on_phase` is passed
        to the val step and called with "host" once a batch's numbers are
        on the host and its metrics computed."""
        del epoch  # names the epoch in the JAX agent's plots and logs only
        iouv = np.linspace(0.5, 0.95, 10)
        stats, precs, recs = [], [], []
        reps, homos, matching, corner_dists = [], [], [], []
        loss_sums: dict[str, float] = {}
        n_batches = n_extended = 0
        self.confusion = ConfusionMatrix(self.nc)
        params = self.state.ema_params
        for bi, raw_batch in enumerate(batches):
            batch = self.to_device(raw_batch)
            draws = self.val_draws(bi, batch["image"].shape)
            out = _to_numpy(self.val_step(params, batch, draws, on_phase))
            n_batches += 1
            for k, v in out["losses"].items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            ev, evw = out["base"], out["warped"]
            B, H, W = ev["heatmap"].shape
            hom, inv_h = out["homography"], out["inv_homography"]
            for b in range(B):
                gts = out["boxes"][b][out["box_mask"][b].astype(bool)]
                labels = np.concatenate(
                    [gts[:, :1], xywhn2xyxy(torch.from_numpy(gts[:, 1:]), W, H).numpy()], axis=1
                ) if len(gts) else np.zeros((0, 5))
                dv = ev["det"]["valid"][b]
                dets = np.concatenate(
                    [ev["det"]["boxes"][b][dv], ev["det"]["scores"][b][dv, None],
                     ev["det"]["classes"][b][dv, None].astype(np.float32)], axis=1
                ) if dv.any() else np.zeros((0, 6))
                correct = process_batch(dets, labels, iouv)
                stats.append((correct, dets[:, 4], dets[:, 5], labels[:, 0]))
                self.confusion.process_batch(dets, labels)
                if n_extended < self.extended_val_n:
                    kp = np.concatenate([ev["pts"][b][ev["valid"][b]],
                                         ev["scores"][b][ev["valid"][b], None]], 1)
                    wkp = np.concatenate([evw["pts"][b][evw["valid"][b]],
                                          evw["scores"][b][evw["valid"][b], None]], 1)
                    rep, _ = compute_repeatability(kp, wkp, hom[b], inv_h[b], (H, W))
                    reps.append(rep)
                    hc = compute_homography_correctness(
                        kp, wkp, ev["desc"][b][ev["valid"][b]], evw["desc"][b][evw["valid"][b]],
                        inv_h[b], (H, W))
                    homos.append(hc["correctness"])
                    matching.append(hc["matching_score"])
                    if hc["mean_dist"] is not None:
                        corner_dists.append(hc["mean_dist"])
                    n_extended += 1
            pr = batch_precision_recall(ev["heatmap"], out["labels_2d"])
            precs.append(pr["precision"].mean())
            recs.append(pr["recall"].mean())
            if on_phase is not None:
                on_phase("host")

        mp = mr = map50 = map_ = 0.0
        if stats:
            correct, conf, pcls, tcls = (np.concatenate([s[i] for s in stats]) for i in range(4))
            if len(tcls) and len(conf):
                _, _, p, r, _, ap, _ = ap_per_class(correct, conf, pcls, tcls)
                mp, mr = float(p.mean()), float(r.mean())
                map50, map_ = float(ap[:, 0].mean()), float(ap.mean())
        rep = float(np.mean(reps)) if reps else 0.0
        homo = float(np.mean(homos)) if homos else 0.0
        scalars = {
            "precision": float(np.mean(precs)) if precs else 0.0,
            "recall": float(np.mean(recs)) if recs else 0.0,
            "repeatability": rep,
            "homography_correctness": homo,
            "matching_score": float(np.mean(matching)) if matching else 0.0,
            "homography_corner_dist": float(np.median(corner_dists)) if corner_dists else -1.0,
            "mAP50": map50, "mAP": map_, "box_p": mp, "box_r": mr,
            "fitness": combined_fitness(rep, homo, fitness_yolo(mp, mr, map50, map_)),
        }
        for k, v in loss_sums.items():
            scalars[k] = v / max(n_batches, 1)
        return scalars


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
