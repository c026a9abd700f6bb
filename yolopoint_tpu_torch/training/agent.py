"""TrainAgent: a config dict -> model, optimizer and train step, and a loop.

Counterpart of the part of `TrainAgent.__init__` in
`yolopoint_tpu/training/agent.py` that builds the training run from the
YAML schema (model, bf16 compute, gain rescaling, loss selection, optimizer
with accumulation to a nominal batch of 64, EMA), on one device, with a
`train(steps)` loop over any iterable of batch dicts. Validation,
checkpoints, plots and the CLI are not ported yet.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
from yolopoint_tpu_torch.models import build_model
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
