"""Checkpoint save and restore in a torch format.

Counterpart of `yolopoint_tpu/training/checkpoint.py`, whose orbax format
the machine that runs the port cannot read or write. A checkpoint is one
`torch.save` file of CPU tensors, read back with `weights_only=True`:

    {"model": the model's state dict (parameters and BatchNorm buffers),
     "optimizer": {"count", "mini_step", "acc": [gradient accumulators],
                   "adamw": AdamW's state dict (moments, step counts)},
     "ema": the EMA shadow (name -> tensor) or None,
     "step": the state's micro-step count}

A run directory holds `ckpts/<step>.pt` (the newest `max_to_keep` of them),
`meta_<step>.json` beside every save, and `best.pt` with `best_meta.json`
for the newest best, as the JAX manager lays out its orbax directories.
`load_run_variables` reads a run's weights for warm starts and inference,
the EMA shadow preferred.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import torch

from yolopoint_tpu_torch.training.state import TrainState


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def state_payload(state: TrainState) -> dict:
    """The checkpoint payload of `state` (CPU copies)."""
    opt = state.optimizer
    return {
        "model": _cpu(state.model.state_dict()),
        "optimizer": {"count": int(opt.count), "mini_step": int(opt.mini_step),
                      "acc": _cpu(list(opt.acc)), "adamw": _cpu(opt.adamw.state_dict())},
        "ema": _cpu(state.ema_params) if state.ema_params is not None else None,
        "step": int(state.step),
    }


@torch.no_grad()
def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Copy `payload` into `state` in place (shapes must match) and return it."""
    device = next(state.model.parameters()).device
    state.model.load_state_dict(payload["model"])
    opt, saved = state.optimizer, payload["optimizer"]
    opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
    for a, v in zip(opt.acc, saved["acc"]):
        a.copy_(v)
    opt.adamw.load_state_dict(saved["adamw"])
    if state.ema_params is not None and payload.get("ema") is not None:
        for n, t in state.ema_params.items():
            t.copy_(payload["ema"][n].to(device))
    state.step = int(payload["step"])
    return state


def _read(path: Path) -> dict:
    return torch.load(str(path), map_location="cpu", weights_only=True)


class CheckpointManager:
    """Rolling train checkpoints plus best-fitness tracking."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.ckpt_dir = self.directory / "ckpts"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_path = self.directory / "best.pt"

    def steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.ckpt_dir.glob("*.pt") if p.stem.isdigit())

    def save(self, step: int, state: TrainState, metadata: Optional[dict[str, Any]] = None,
             fitness: Optional[float] = None, best: bool = False) -> None:
        payload = state_payload(state)
        path = self.ckpt_dir / f"{int(step)}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(payload, str(tmp))
        tmp.replace(path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.ckpt_dir / f"{old}.pt").unlink()
        meta = dict(metadata or {})
        if fitness is not None:
            meta["fitness"] = float(fitness)
        (self.directory / f"meta_{int(step)}.json").write_text(json.dumps(meta, default=str))
        if best:  # only the newest best is kept
            tmp = self.best_path.with_suffix(".tmp")
            torch.save(payload, str(tmp))
            tmp.replace(self.best_path)
            (self.directory / "best_meta.json").write_text(json.dumps(meta, default=str))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None):
        """Restore checkpoint `step` (default: the latest) into `state`;
        returns `(state, meta)`, or `(None, None)` when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        load_payload(state, _read(self.ckpt_dir / f"{int(step)}.pt"))
        meta_path = self.directory / f"meta_{int(step)}.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return state, meta

    def restore_best(self, state: TrainState):
        if not self.best_path.exists():
            return None, None
        load_payload(state, _read(self.best_path))
        meta_path = self.directory / "best_meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return state, meta


def load_run_variables(path: str | Path, prefer_ema: bool = True) -> dict[str, torch.Tensor]:
    """A port training run's weights as a model state dict (CPU tensors),
    the EMA shadow in place of the parameters where there is one. `path`
    is a run directory (its `best.pt`, else its latest `ckpts/<step>.pt`),
    a `ckpts` directory, or a checkpoint file."""
    p = Path(path).resolve()
    if p.is_dir():
        ckpts = p if p.name == "ckpts" else p / "ckpts"
        if (p / "best.pt").exists():
            p = p / "best.pt"
        else:
            steps = sorted(int(f.stem) for f in ckpts.glob("*.pt") if f.stem.isdigit())
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {ckpts}")
            p = ckpts / f"{steps[-1]}.pt"
    payload = _read(p)
    state_dict = dict(payload["model"])
    if prefer_ema and payload.get("ema"):
        state_dict.update(payload["ema"])
    return state_dict
