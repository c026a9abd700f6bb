"""TrainAgent: a config dict -> model, optimizer, train and val steps, and
the epoch loop.

Counterpart of `TrainAgent` in `yolopoint_tpu/training/agent.py`, on one
device. `__init__` builds the run from the YAML schema (model, bf16
compute, gain rescaling, loss selection, optimizer with accumulation to a
nominal batch of 64, EMA, the val step), the checkpoint manager and the
metrics writer, and applies `pretrained` (warm start, optionally
shrink-perturb) and `resume`. `train()` runs the epoch loop: validation
every `val_interval` epochs and at the last, early stopping, rolling and
best checkpoints, a `last` checkpoint on KeyboardInterrupt, `done.json`.
`train_steps(steps)` runs bare micro-steps; `validate(epoch)` returns the
JAX agent's validation scalars and writes them to `metrics.jsonl`.

`steps_per_dispatch` = K runs K micro-steps back to back and logs their
averaged scalars, the numbers of the JAX package's scanned dispatch (the
fewer than K left at an epoch's end run unlogged, as there); the
micro-steps are not fused into one launch (a CUDA graph would be). Plots
(`val_plots`) and the profiler window (`profile`) are not ported.
"""

from __future__ import annotations

import json
from pathlib import Path
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
from yolopoint_tpu_torch.models.convert import load_weights, merge_partial_variables
from yolopoint_tpu_torch.ops.boxes import xywhn2xyxy
from yolopoint_tpu_torch.training.checkpoint import CheckpointManager, load_run_variables
from yolopoint_tpu_torch.training.ema import EarlyStopping
from yolopoint_tpu_torch.training.state import (
    REFERENCE_MODULE_ORDER,
    create_train_state,
    freeze_mask_from_spec,
    make_optimizer,
    shrink_perturb,
)
from yolopoint_tpu_torch.training.step import (
    BATCH_KEYS,
    LossWeights,
    draw_step,
    make_train_step,
    make_val_step,
    rescale_yolo_gains,
)
from yolopoint_tpu_torch.utils.config import get as _get
from yolopoint_tpu_torch.utils.device import resolve_device
from yolopoint_tpu_torch.utils.logging import LOGGER, MetricsWriter, StepTimer


def should_save_checkpoint(epoch: int, epochs: int, best: bool, save_interval: int) -> bool:
    """Rolling-checkpoint cadence (`training_params.save_interval`): best and
    final epochs always save; otherwise every `save_interval`-th epoch."""
    return best or epoch == epochs - 1 or (epoch + 1) % save_interval == 0


class TrainAgent:
    """Drives training from a reference-schema config dict.

    `train_loader` is the host `DataLoader`, a `DeviceDataLoader`, or any
    iterable of batch dicts (numpy or torch: image `(B, H, W, 3)` u8 or f32,
    points `(B, N, 2)`, point_mask `(B, N)`, boxes `(B, M, 5)`, box_mask
    `(B, M)`); its `len()`, where it has one, is the number of micro-steps
    per epoch of the LR schedule. `val_loader` (optional) iterates the
    validation batches. The run directory `output_dir` receives the
    checkpoints, `metrics.jsonl` and `done.json`. `seed` seeds the model's
    initial weights and the augmentation draws, in generators of the agent's
    own (the caller's global generators are left as they were).
    """

    def __init__(self, config: Mapping[str, Any], output_dir: str | Path, train_loader: Iterable,
                 val_loader: Iterable | None = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.train_loader = train_loader
        self.val_loader = val_loader
        if config.get("val_plots"):
            raise NotImplementedError(
                "val_plots: the validation plots need matplotlib, which the machine that runs "
                "the port does not have; set val_plots: false")
        self.names = list(config.get("names", []))
        self.nc = max(len(self.names), 1)
        model_cfg = config.get("model", {})
        self.model_name = model_cfg.get("name", "YOLOPoint")
        self.version = model_cfg.get("version", "s")
        tp = config.get("training_params", {})
        dtype_name = str(model_cfg.get("dtype", tp.get("dtype", "float32"))).lower()
        self.compute_dtype = torch.bfloat16 if dtype_name in ("bf16", "bfloat16") else torch.float32

        fork_devices = [self.device.index or 0] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=fork_devices):
            torch.manual_seed(seed)
            self.model = build_model(self.model_name, self.version, nc=self.nc,
                                     device=self.device).train()

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
                names, str(spec), REFERENCE_MODULE_ORDER.get(self.model_name))
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
        self.epochs = epochs
        self.stopper = EarlyStopping(int(tp["patience"])) if tp.get("patience") else None
        self.val_interval = max(int(tp.get("val_interval", 1)), 1)
        self.save_interval = max(int(tp.get("save_interval", 1)), 1)
        self.steps_per_dispatch = max(int(tp.get("steps_per_dispatch", 1)), 1)

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

        self.ckpt = CheckpointManager(self.output_dir)
        self.metrics = MetricsWriter(self.output_dir)
        self.timer = StepTimer()
        self.best_fitness = -1.0
        self.global_step = 0
        self.start_epoch = 0
        self.pretrained_report = None
        if wp := config.get("pretrained"):
            self._load_pretrained(wp, seed)
        if config.get("resume"):
            restored, meta = self.ckpt.restore(self.state)
            if restored is not None:
                self.start_epoch = int(meta.get("epoch", 0)) + 1
                self.best_fitness = float(meta.get("best_fitness", -1.0))
                self.global_step = int(meta.get("global_step", self.state.step))
                LOGGER.info(f"resumed from epoch {self.start_epoch}")

    def _load_pretrained(self, path: str, seed: int) -> None:
        """Warm start: a reference-schema torch file (`models.convert.
        load_weights`) or a port run directory (`load_run_variables`, the EMA
        shadow preferred), merged by name and shape (`merge_partial_variables`:
        tensors whose shape changed, such as the Detect convolutions after a
        class-count change, keep their fresh initialization); then
        shrink-perturb where `shrink_perturb: {lam, sigma}` is configured,
        its noise from a generator seeded by `seed`. The EMA shadow restarts
        from the loaded parameters. `self.pretrained_report` keeps the merge
        report."""
        p = Path(path)
        source = load_run_variables(p) if p.is_dir() else load_weights(p)["state_dict"]
        merged, report = merge_partial_variables(self.model.state_dict(), source)
        self.model.load_state_dict(merged)
        self.pretrained_report = report
        if report["shape_mismatch"]:
            LOGGER.info(f"reinitialized {len(report['shape_mismatch'])} mismatched tensors "
                        f"(class count changed?): {report['shape_mismatch'][:4]}...")
        LOGGER.info(f"loaded weights from {p} ({len(report['loaded'])} tensors)")
        if sp := self.config.get("shrink_perturb"):
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            params = dict(self.model.named_parameters())
            new = shrink_perturb(params, gen, lam=float(sp.get("lam", 0.5)),
                                 sigma=float(sp.get("sigma", 0.01)))
            with torch.no_grad():
                for n, t in params.items():
                    t.copy_(new[n])
            LOGGER.info("applied shrink-perturb warm start")
        if self.state.ema_params is not None:
            with torch.no_grad():
                for n, t in self.model.named_parameters():
                    self.state.ema_params[n].copy_(t)

    def to_device(self, batch: Mapping[str, Any]) -> dict:
        """The batch's tensors on the agent's device."""
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in BATCH_KEYS + ("crop_yx", "mosaic_crop_yx") if k in batch}

    def step(self, batch: Mapping[str, Any], on_phase=None) -> dict:
        """One micro-step on `batch`, with fresh draws from the agent's generator."""
        batch = self.to_device(batch)
        draws = draw_step(self.gen, tuple(batch["image"].shape), self.aug_config, self.weights)
        return self.train_step(self.state, batch, draws, on_phase)

    def train_steps(self, steps: int, on_phase=None) -> list[dict]:
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

    # ---------------- the epoch loop ----------------

    def train(self) -> None:
        """Run the epoch loop; a KeyboardInterrupt saves a `last` checkpoint
        (at the current global step) before returning."""
        try:
            self._train_loop()
        except KeyboardInterrupt:
            self.ckpt.save(
                int(self.global_step), self.state,
                metadata={"interrupted": True, "global_step": self.global_step,
                          "best_fitness": self.best_fitness},
                best=False)
            LOGGER.info("interrupted — checkpoint saved")

    def _dispatch(self, batches: list) -> dict:
        """Micro-steps on `batches`, back to back; their scalars averaged."""
        auxes = []
        for batch in batches:
            auxes.append(self.step(batch))
            self.global_step += 1
        if len(auxes) == 1:
            return auxes[0]
        return {k: torch.stack([torch.as_tensor(a[k], dtype=torch.float32).to(self.device)
                                for a in auxes]).mean() for k in auxes[0]}

    def _log_dispatch(self, epoch: int, aux: Mapping[str, Any]) -> None:
        self.timer.tick()
        if self.global_step < self._next_log:
            return
        self._next_log = self.global_step + 50
        per_step = self.timer.mean / self.steps_per_dispatch
        scalars = {k_: float(v) for k_, v in aux.items()}
        if scalars.get("nonfinite_skip", 0.0) > 0:
            LOGGER.warning(f"e{epoch} s{self.global_step}: non-finite grads in the last "
                           "dispatch — update(s) skipped")
        scalars["step_time"] = per_step
        self.metrics.write(self.global_step, scalars, prefix="training/")
        LOGGER.info(f"e{epoch} s{self.global_step} loss={scalars['loss']:.4f} "
                    f"({per_step * 1e3:.0f} ms/step)")

    def _train_loop(self) -> None:
        self._next_log = 1  # log the first dispatch, then every 50 micro-steps
        k = self.steps_per_dispatch
        epoch = self.start_epoch - 1
        stopped_early = False
        for epoch in range(self.start_epoch, self.epochs):
            pending: list = []
            for batch in self.train_loader:
                pending.append(batch)
                if len(pending) < k:
                    continue
                self._log_dispatch(epoch, self._dispatch(pending))
                pending = []
            # an under-full dispatch at the end of the epoch: its micro-steps run
            # one by one, untimed and unlogged, as the JAX loop runs them
            for b in pending:
                self._dispatch([b])
            do_val = self.val_loader is not None and (
                (epoch + 1) % self.val_interval == 0 or epoch == self.epochs - 1)
            val_scalars = self.validate(epoch) if do_val else {}
            fitness = val_scalars.get("fitness", -1.0)
            best = fitness > self.best_fitness
            if best:
                self.best_fitness = fitness
            stop = do_val and self.stopper is not None and self.stopper(epoch, fitness)
            # an early stop saves even off the save cadence, so that the newest
            # rolling checkpoint is where training ended
            if stop or should_save_checkpoint(epoch, self.epochs, best, self.save_interval):
                self.ckpt.save(
                    epoch, self.state,
                    metadata={"epoch": epoch, "global_step": self.global_step,
                              "best_fitness": self.best_fitness, "names": self.names,
                              "version": self.version, "model_name": self.model_name,
                              "config": self.config},
                    fitness=fitness, best=best)
            if stop:
                LOGGER.info(f"early stopping at epoch {epoch}: no fitness improvement in the "
                            f"last {self.stopper.patience} epochs")
                stopped_early = True
                break
        # terminal marker, written only when the epoch loop finished
        (self.output_dir / "done.json").write_text(json.dumps({
            "last_epoch": int(epoch), "global_step": int(self.global_step),
            "best_fitness": float(self.best_fitness), "stopped_early": stopped_early}))

    def val_draws(self, batch_index: int, image_shape) -> dict:
        """The random samples of val batch `batch_index`: a generator seeded
        by `(val_seed, batch_index)`, so every validation sees the same views."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.val_seed * 1_000_003 + batch_index)
        return draw_step(gen, tuple(image_shape), self.val_aug_config, self.weights)

    def validate(self, epoch: int = 0, on_phase=None) -> dict[str, float]:
        """Validation over `self.val_loader` (batch dicts as the train loader
        gives them): the val losses, point precision and recall of the base
        heatmap, the YOLO mAP stack at the protocol's conf 0.001, and on the
        first `extended_val_sample_size` images the repeatability and
        homography correctness linking the decoded base view to its warped
        pair. Uses the EMA weights where they exist. Returns the JAX agent's
        scalars, writes them to `metrics.jsonl` under `validation/` at the
        current global step and logs them. `on_phase` is passed to the val
        step and called with "host" once a batch's numbers are on the host
        and its metrics computed."""
        iouv = np.linspace(0.5, 0.95, 10)
        stats, precs, recs = [], [], []
        reps, homos, matching, corner_dists = [], [], [], []
        loss_sums: dict[str, float] = {}
        n_batches = n_extended = 0
        self.confusion = ConfusionMatrix(self.nc)
        params = self.state.ema_params
        for bi, raw_batch in enumerate(self.val_loader):
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
        self.metrics.write(self.global_step, scalars, prefix="validation/")
        LOGGER.info(f"val e{epoch}: {scalars}")
        return scalars


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
