"""TrainAgent: a config dict -> model, optimizer, train and val steps, and
the epoch loop.

Counterpart of `TrainAgent` in `yolopoint_tpu/training/agent.py`, on one
device or data-parallel over the ranks of a `parallel.mesh.Mesh`.
`__init__` builds the run from the YAML schema (model, bf16 compute, gain
rescaling, loss selection, optimizer with accumulation to the JAX agent's
nominal batch, EMA, the val step), the checkpoint manager and the metrics
writer, and applies `pretrained` (warm start, optionally shrink-perturb)
and `resume`. `train()` runs the epoch loop: validation every
`val_interval` epochs and at the last, early stopping, rolling and best
checkpoints, a `last` checkpoint on KeyboardInterrupt, `done.json`.
`train_steps(steps)` runs bare micro-steps; `validate(epoch)` returns the
JAX agent's validation scalars and writes them to `metrics.jsonl`. Every
family `build_model` builds trains (`model.name`, `model.version`, with the
freeze specs counted in the family's `REFERENCE_MODULE_ORDER`); a family
without a Detect head has no object loss and validates without boxes.

`steps_per_dispatch` = K runs K micro-steps a dispatch through
`make_multi_step` (stacked batches) or `make_device_multi_step` (`(K, B)`
rows into the device-resident set) and logs their averaged scalars, as the
JAX package's scanned dispatch; a change of batch structure (mosaic keys)
flushes the pending micro-steps one by one, and so does the under-full tail
of an epoch. The micro-steps are a Python loop, not one CUDA graph.
`training_params.profile: {start_step, num_steps}` opens a `torch.profiler`
window at the first dispatch that starts at or after `start_step` and
closes it after the dispatch that reaches `start_step + num_steps`, once a
run; the trace goes to `<output_dir>/profile/rank<r>.json`, each micro-step
a "micro_step" range. A resumed run past `start_step` traces its first
dispatch, as the JAX agent does; where the directory holds an earlier
run's trace, that one is kept and the new one goes to
`rank<r>_steps<first>-<last>.json` (the JAX trace goes to a new directory
each time). `val_plots` (true, or a directory) makes `validate`
write up to 4 annotated val panels and `write_plots` the PR/F1/P/R curves
and the confusion matrix each val epoch, as the JAX agent does
(`evaluation/plots.py`, without matplotlib); true writes under
`<output_dir>/plots`.

Data parallelism (a `mesh` of more than one rank): the train loader gives
this rank's rows of each global batch (`train_batch_size` is the global
batch), each rank draws its augmentation from a generator seeded by (seed,
rank), and the step averages over the ranks (`training.step`). The nominal
batch rule is the JAX agent's, `accum = round(64 / (batch * world size))`:
as there, the loader's batch is split over the ranks, so the nominal batch
is 64 / world size. The parameters, buffers and EMA shadow are broadcast
from rank 0 once built, so a warm start reaches every rank alike. Rank 0
alone validates (the numbers of world size 1), writes checkpoints,
`metrics.jsonl` and `done.json`; the fitness is broadcast, so every rank
stops early together. Each rank logs an `epoch_timing` line a epoch (its
micro-steps, train seconds, the seconds it waited for the loader).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np
import torch

from yolopoint_tpu_torch.evaluation.descriptor_eval import compute_homography_correctness
from yolopoint_tpu_torch.evaluation.detector_eval import batch_precision_recall, compute_repeatability
from yolopoint_tpu_torch.evaluation.plots import (
    plot_confusion_matrix,
    plot_pr_curves,
    plot_val_panel,
)
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
from yolopoint_tpu_torch.parallel.mesh import Mesh, broadcast_tensors, shard_batch
from yolopoint_tpu_torch.training.checkpoint import CheckpointManager
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
    PRECOMPUTED_KEYS,
    LossWeights,
    batch_mode,
    draw_shape,
    draw_step,
    make_device_multi_step,
    make_multi_step,
    make_train_step,
    make_val_step,
    rescale_yolo_gains,
    stack_batches,
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
    own (the caller's global generators are left as they were). `mesh`
    (`parallel.mesh.initialize_multi_host`) makes the run data-parallel;
    its device is the agent's.
    """

    def __init__(self, config: Mapping[str, Any], output_dir: str | Path, train_loader: Iterable,
                 val_loader: Iterable | None = None, seed: int = 0,
                 device: str | torch.device | None = None, mesh: Mesh | None = None):
        self.config = dict(config)
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.mesh = mesh or Mesh(1, 0, self.device)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.names = list(config.get("names", []))
        self.nc = max(len(self.names), 1)
        self.confusion = self.last_curves = None  # of the last `validate`, for `write_plots`
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
        # the JAX agent's nominal batch: 64 over the world size, since the
        # loader's (global) batch is split over the ranks
        self.accum = accumulation_steps(batch_size, self.mesh.size)
        # a loader without a length gets the JAX package's make_optimizer default
        steps_per_epoch = len(train_loader) if hasattr(train_loader, "__len__") else 1000
        trainable_mask = None
        if spec := config.get("freeze_layers"):
            names = [n for n, _ in self.model.named_parameters()]
            trainable_mask = freeze_mask_from_spec(
                names, str(spec), REFERENCE_MODULE_ORDER.get(self.model_name))
            LOGGER.info(f"freezing {sum(not t for t in trainable_mask)} parameter tensors "
                        f"({spec!r})")
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
            accum=self.accum, compute_dtype=self.compute_dtype, mesh=self.mesh,
        )
        self.gen = torch.Generator(device=self.device).manual_seed(rank_seed(seed, self.mesh.rank))
        self.epochs = epochs
        self.stopper = EarlyStopping(int(tp["patience"])) if tp.get("patience") else None
        self.val_interval = max(int(tp.get("val_interval", 1)), 1)
        self.save_interval = max(int(tp.get("save_interval", 1)), 1)
        self.steps_per_dispatch = max(int(tp.get("steps_per_dispatch", 1)), 1)
        self.multi_step = make_multi_step(self.train_step, self.steps_per_dispatch)
        self.device_multi_step = make_device_multi_step(self.train_step, self.steps_per_dispatch)
        profile = tp.get("profile") or {}
        self.profile_start = int(profile.get("start_step", 10)) if profile else -1
        self.profile_stop = self.profile_start + int(profile.get("num_steps", 5)) if profile \
            else -1
        self._profiler = None
        self.profile_window = None  # (first, last) micro-step traced, once closed

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
        self.metrics = MetricsWriter(self.output_dir) if self.mesh.is_main else _NoMetrics()
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
        # one start on every rank, whatever each built or loaded
        ema = list(self.state.ema_params.values()) if self.state.ema_params is not None else []
        broadcast_tensors(list(self.model.parameters()) + list(self.model.buffers()) + ema,
                          self.mesh)

    def _load_pretrained(self, path: str, seed: int) -> None:
        """Warm start: anything `models.convert.load_weights` reads (a
        reference-schema torch file, a port run directory or an orbax run
        or checkpoint of the JAX package, the EMA shadow preferred), read as
        a run on the agent's device reads it, merged by name and shape
        (`merge_partial_variables`: tensors whose shape changed, such as the
        Detect convolutions after a class-count change, keep their fresh
        initialization); then shrink-perturb where `shrink_perturb: {lam,
        sigma}` is configured, its noise from a generator seeded by `seed`.
        The EMA shadow restarts from the loaded parameters.
        `self.pretrained_report` keeps the merge report."""
        p = Path(path)
        source = load_weights(p, self.device)["state_dict"]
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
        """The batch's tensors on the agent's device (the host-warp payload
        and the zero-channel `image` stub of a host-warped batch too)."""
        keys = BATCH_KEYS + ("crop_yx", "mosaic_crop_yx") + tuple(
            f"precomputed_{k}" for k in PRECOMPUTED_KEYS)
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in keys if k in batch}

    def step(self, batch: Mapping[str, Any], on_phase=None) -> dict:
        """One micro-step on `batch`, with fresh draws from the agent's generator."""
        batch = self.to_device(batch)
        draws = draw_step(self.gen, draw_shape(batch), self.aug_config, self.weights,
                          **batch_mode(batch))
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
            if not self.mesh.is_main:
                return
            self.ckpt.save(
                int(self.global_step), self.state,
                metadata={"interrupted": True, "global_step": self.global_step,
                          "best_fitness": self.best_fitness},
                best=False)
            LOGGER.info("interrupted — checkpoint saved")

    def _run_single(self, batch, rows: bool = False) -> dict:
        """One micro-step; `rows`: `batch` is global index rows into the
        device-resident set."""
        if rows:
            batch = self.train_loader.gather_row(shard_batch(batch, self.mesh))
        aux = self.step(batch)
        self.global_step += 1
        return aux

    def _run_stacked(self, pending: list, rows: bool = False) -> dict:
        """One dispatch of K micro-steps; their scalars averaged."""
        if rows:
            idx = shard_batch(np.stack(pending), self.mesh, leading_stack=True)  # (K, B/n)
            data = self.train_loader.resident_data
            shape = (idx.shape[1], *data["image"].shape[1:])
            draws = [draw_step(self.gen, shape, self.aug_config, self.weights, **batch_mode(data))
                     for _ in pending]
            aux = self.device_multi_step(self.state, data, idx, draws)
        else:
            batches = [self.to_device(b) for b in pending]
            draws = [draw_step(self.gen, draw_shape(b), self.aug_config, self.weights,
                               **batch_mode(b)) for b in batches]
            aux = self.multi_step(self.state, stack_batches(batches), draws)
        self.global_step += len(pending)
        return {k: v.mean() for k, v in aux.items()}

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
        if self.mesh.is_main:
            LOGGER.info(f"e{epoch} s{self.global_step} loss={scalars['loss']:.4f} "
                        f"({per_step * 1e3:.0f} ms/step)")

    def _profile_open(self) -> None:
        if self.profile_start < 0 or self.profile_window is not None or self._profiler \
                or self.global_step < self.profile_start:
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()
        self._profile_first = self.global_step

    def _profile_close(self, force: bool = False) -> None:
        if self._profiler is None or (self.global_step < self.profile_stop and not force):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = self.output_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        self.profile_window = (self._profile_first, self.global_step - 1)
        path = out / f"rank{self.mesh.rank}.json"
        if path.exists():  # an earlier run's window (this one resumed past it)
            path = out / f"rank{self.mesh.rank}_steps{self.profile_window[0]}-" \
                         f"{self.profile_window[1]}.json"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        LOGGER.info(f"profile: micro-steps {self._profile_first}-{self.global_step - 1} "
                    f"-> {path}")

    def _share_fitness(self, fitness: float) -> float:
        """Rank 0's fitness on every rank."""
        t = torch.tensor([fitness], dtype=torch.float64, device=self.device)
        broadcast_tensors([t], self.mesh)
        return float(t)

    def _train_loop(self) -> None:
        self._next_log = 1  # log the first dispatch, then every 50 micro-steps
        k = self.steps_per_dispatch
        # device-resident set and K > 1: dispatch (K, B) index rows
        rows = k > 1 and getattr(self.train_loader, "resident_data", None) is not None
        epoch = self.start_epoch - 1
        stopped_early = False
        for epoch in range(self.start_epoch, self.epochs):
            pending: list = []
            t_epoch, wait, first_step = time.perf_counter(), 0.0, self.global_step
            batches = iter(self.train_loader.epoch_rows() if rows else self.train_loader)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t0
                if batch is None:
                    break
                self._profile_open()
                if k == 1:
                    aux = self._run_single(batch)
                else:
                    # only batches of one structure stack (mosaic batches carry
                    # other keys): a change flushes the pending ones one by one
                    if pending and not rows and set(batch) != set(pending[0]):
                        for b in pending:
                            self._run_single(b)
                        pending = []
                    pending.append(batch)
                    if len(pending) < k:
                        continue
                    aux = self._run_stacked(pending, rows)
                    pending = []
                self._profile_close()
                self._log_dispatch(epoch, aux)
            # an under-full dispatch at the end of the epoch: its micro-steps run
            # one by one, untimed and unlogged, as the JAX loop runs them
            for b in pending:
                self._run_single(b, rows)
            self._profile_close()
            train_s = time.perf_counter() - t_epoch
            do_val = self.val_loader is not None and (
                (epoch + 1) % self.val_interval == 0 or epoch == self.epochs - 1)
            t_val = time.perf_counter()
            val_scalars = self.validate(epoch) if do_val and self.mesh.is_main else {}
            fitness = val_scalars.get("fitness", -1.0)
            if do_val:
                fitness = self._share_fitness(fitness)
            LOGGER.info("epoch_timing " + json.dumps({
                "rank": self.mesh.rank, "world": self.mesh.size, "epoch": epoch,
                "micro_steps": self.global_step - first_step, "train_s": train_s,
                "loader_wait_s": wait, "val_s": time.perf_counter() - t_val}))
            best = fitness > self.best_fitness
            if best:
                self.best_fitness = fitness
            stop = do_val and self.stopper is not None and self.stopper(epoch, fitness)
            # an early stop saves even off the save cadence, so that the newest
            # rolling checkpoint is where training ended
            if self.mesh.is_main and (
                    stop or should_save_checkpoint(epoch, self.epochs, best, self.save_interval)):
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
        self._profile_close(force=True)  # a window past the run's end
        # terminal marker, written only when the epoch loop finished
        if self.mesh.is_main:
            (self.output_dir / "done.json").write_text(json.dumps({
                "last_epoch": int(epoch), "global_step": int(self.global_step),
                "best_fitness": float(self.best_fitness), "stopped_early": stopped_early}))

    def val_draws(self, batch_index: int, image_shape, crop: bool = False,
                  mosaic: bool = False, precomputed: bool = False) -> dict:
        """The random samples of val batch `batch_index`: a generator seeded
        by `(val_seed, batch_index)`, so every validation sees the same views.
        `image_shape` is `draw_shape(batch)`; `crop` / `mosaic` /
        `precomputed` as `draw_step` takes them (`batch_mode`)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.val_seed * 1_000_003 + batch_index)
        return draw_step(gen, tuple(image_shape), self.val_aug_config, self.weights, crop=crop,
                         mosaic=mosaic, precomputed=precomputed)

    def validate(self, epoch: int = 0, on_phase=None) -> dict[str, float]:
        """Validation over `self.val_loader` (batch dicts as the train loader
        gives them): the val losses, point precision and recall of the base
        heatmap, the YOLO mAP stack at the protocol's conf 0.001 (left at 0
        for a family without a Detect head, which decodes no boxes), and on the
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
        n_batches = n_extended = n_panels = 0
        panels_dir = self.plots_dir()
        self.confusion = ConfusionMatrix(self.nc)
        params = self.state.ema_params
        for bi, raw_batch in enumerate(self.val_loader):
            batch = self.to_device(raw_batch)
            draws = self.val_draws(bi, draw_shape(batch), **batch_mode(batch))
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
                if "det" in ev:  # a family with a Detect head
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
                        inv_h[b], (H, W), device=self.device)
                    homos.append(hc["correctness"])
                    matching.append(hc["matching_score"])
                    if hc["mean_dist"] is not None:
                        corner_dists.append(hc["mean_dist"])
                    n_extended += 1
                    if panels_dir is not None and n_panels < 4:
                        det = ev.get("det") or {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                                                "classes": np.zeros(0), "valid": np.zeros(0, bool)}
                        plot_val_panel(
                            out["image"][b],
                            {k: (v[b] if "det" in ev else v) for k, v in det.items()},
                            self.names, panels_dir / f"e{epoch}_panel{n_panels}.png",
                            keypoints=kp[:, :2])
                        n_panels += 1
            pr = batch_precision_recall(ev["heatmap"], out["labels_2d"])
            precs.append(pr["precision"].mean())
            recs.append(pr["recall"].mean())
            if on_phase is not None:
                on_phase("host")

        mp = mr = map50 = map_ = 0.0
        self.last_curves = None
        if stats:
            correct, conf, pcls, tcls = (np.concatenate([s[i] for s in stats]) for i in range(4))
            if len(tcls) and len(conf):
                _, _, p, r, _, ap, _, curves = ap_per_class(correct, conf, pcls, tcls,
                                                            return_curves=True)
                mp, mr = float(p.mean()), float(r.mean())
                map50, map_ = float(ap[:, 0].mean()), float(ap.mean())
                self.last_curves = curves
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
        if panels_dir is not None:
            self.write_plots(panels_dir, epoch)
        LOGGER.info(f"val e{epoch}: {scalars}")
        return scalars

    def plots_dir(self) -> Path | None:
        """Where `val_plots` sends the plots: a string is the directory,
        another true value `<output_dir>/plots`; None when it is off."""
        vp = self.config.get("val_plots")
        if not vp:
            return None
        return Path(vp) if isinstance(vp, str) else self.output_dir / "plots"

    def write_plots(self, directory: Path, epoch: int) -> None:
        """The PR/F1/P/R curves of the last `validate` (where it had
        detections and labels) and its confusion matrix, into `directory`."""
        directory.mkdir(parents=True, exist_ok=True)
        if self.last_curves is not None:
            plot_pr_curves(self.last_curves, self.names, directory, prefix=f"e{epoch}_")
        if self.confusion is not None:
            plot_confusion_matrix(self.confusion.matrix, self.names,
                                  directory / f"e{epoch}_confusion.png")


def accumulation_steps(batch_size: int, world: int = 1) -> int:
    """Micro-steps a update: the JAX agent's `round(64 / (batch * world))`,
    at least 1 (`batch` the global batch, split over `world` ranks)."""
    return max(round(64 / (batch_size * max(world, 1))), 1)


def rank_seed(seed: int, rank: int) -> int:
    """The augmentation seed of `rank`: `seed` itself on rank 0 (a run of one
    process draws as before), a seed of (seed, rank) on the others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


class _NoMetrics:
    """The metrics writer of a rank other than 0: writes nothing."""

    def write(self, step, scalars, prefix: str = "") -> None:
        pass

    def close(self) -> None:
        pass


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
