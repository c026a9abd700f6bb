"""One-command synthetic bootstrap on the port: the MagicPoint -> SuperPoint
training method, the counterpart of the JAX package's `tools/bootstrap.py`
with its stages, skip rules, flags and defaults.

Stages (each skipped when its output exists, unless `--fresh`):
  1. joint synthetic-shapes pretraining   -> <runs>/<run>/best.pt
  2. homographic-adaptation pseudo-labels -> <runs>/<run>/export/*.npz
  3. retraining on the pseudo-labels      -> <runs>/<run>_pseudo/best.pt
  3.5 the HPatches protocol on both models -> <run dir>/hpatches.json
      (when `--hpatches_data` exists; render it with
      `python -m yolopoint_tpu_torch.tools.synthetic_hpatches`)
  4. the summary of the runs              -> <runs>/RESULTS_torch.json

  python -m yolopoint_tpu_torch.tools.bootstrap [--run synth_r2] [--fresh] \
      [--config configs/synthetic.yaml] [--device cuda]

The stages run the port's CLIs one after another, each in a subprocess:
`yolopoint_tpu_torch.training.cli`, `.export.cli --action train` and
`.evaluation.hpatches_runner --json`, all with `--device`; a run is the
port's layout (`best.pt`, `best_meta.json`, `done.json`, `ckpts/`), and the
exporter, the HPatches runner and the warm start read it with
`models.convert.load_weights`. Stage 3 trains on a snapshot of the pseudo
config with `data.generation.points_dir` pointed at stage 2's files, written
as `<runs>/<run>/pseudo_config.yml` by `utils.config.save_config`. Relative
paths are taken from the repository root. The JAX tool's last step, copying
orbax checkpoints into `artifacts/`, has no counterpart.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Sequence

ROOT = Path(__file__).resolve().parents[2]


def sh(args: Sequence[str]) -> None:
    """Run one stage's command in a subprocess from the repository root."""
    print(f"[bootstrap] $ {' '.join(args)}", flush=True)
    subprocess.run(list(args), cwd=ROOT, check=True)


def stage1_done(run_dir: Path) -> bool:
    # `done.json` is written when the epoch loop completes; a run without it
    # counts as done where its best checkpoint and its meta exist
    return (run_dir / "done.json").exists() or (
        (run_dir / "best.pt").is_file() and (run_dir / "best_meta.json").exists())


def stage2_done(run_dir: Path, n_expected: int) -> bool:
    exp = run_dir / "export"
    return exp.is_dir() and len(list(exp.glob("*.npz"))) >= n_expected


def _path(p: str) -> Path:
    return ROOT / p  # an absolute `p` stays as it is


def main(argv=None, run: Callable[[Sequence[str]], None] = sh) -> dict:
    """Run the stages that are not done; `run` runs one stage's command (a
    `python -u -m <module> ...` argument list). Returns each stage's seconds,
    0 for a stage that was skipped."""
    from yolopoint_tpu_torch.utils.config import load_config, parse_yaml, save_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="synth_r2")
    ap.add_argument("--runs_dir", default="runs")
    ap.add_argument("--config", default="configs/synthetic.yaml")
    ap.add_argument("--export_config", default="configs/synthetic_export.yaml")
    ap.add_argument("--pseudo_config", default="configs/synthetic_pseudo.yaml")
    ap.add_argument("--fresh", action="store_true",
                    help="rerun every stage even if its output exists")
    ap.add_argument("--hpatches_data", default="datasets/hpatches_synth",
                    help="HPatches-layout set of stage 3.5 (skipped where it is missing)")
    ap.add_argument("--device", default="cuda", help="torch device of every stage")
    args = ap.parse_args(argv)

    runs_dir = _path(args.runs_dir)
    run_dir = runs_dir / args.run
    py = sys.executable
    dev = ["--device", args.device]
    seconds = {}

    def stage(name: str, cmd: Sequence[str]) -> None:
        t0 = time.perf_counter()
        run(cmd)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        print(f"[bootstrap] {name}: {seconds[name]:.1f} s", flush=True)

    # ---- stage 1: synthetic-shapes joint pretraining ----
    seconds["pretrain"] = 0.0
    if args.fresh or not stage1_done(run_dir):
        cmd = [py, "-u", "-m", "yolopoint_tpu_torch.training.cli",
               "--config", str(_path(args.config)), "--exper_name", args.run,
               "--output_dir", str(runs_dir), *dev]
        if run_dir.joinpath("ckpts").is_dir() and not args.fresh:
            cmd.append("--resume")
        stage("pretrain", cmd)
    else:
        print(f"[bootstrap] stage 1 done ({run_dir}/best.pt exists)", flush=True)

    # ---- stage 2: pseudo-label export (homographic adaptation) ----
    length = (load_config(_path(args.export_config)).get("data") or {}).get("length") or {}
    n_train = int(length.get("train", 1024))
    seconds["export"] = 0.0
    if args.fresh or not stage2_done(run_dir, n_train):
        stage("export", [py, "-u", "-m", "yolopoint_tpu_torch.export.cli",
                         "--config", str(_path(args.export_config)), "--action", "train",
                         "--weights", str(run_dir),
                         "--output", str(run_dir / "export"), *dev])
    else:
        print(f"[bootstrap] stage 2 done ({n_train} npz present)", flush=True)

    # ---- stage 3: retrain on pseudo-labels ----
    pseudo_run = f"{args.run}_pseudo"
    pseudo_dir = runs_dir / pseudo_run
    seconds["retrain"] = 0.0
    if args.fresh or not stage1_done(pseudo_dir):
        # the pseudo config's generation.points_dir must name THIS run's
        # stage-2 export: a snapshot of the config with it rewritten
        pseudo_cfg = parse_yaml(_path(args.pseudo_config).read_text())
        pseudo_cfg.setdefault("data", {}).setdefault("generation", {})[
            "points_dir"] = str(run_dir / "export")
        cfg_snapshot = run_dir / "pseudo_config.yml"
        save_config(pseudo_cfg, cfg_snapshot)
        stage("retrain", [py, "-u", "-m", "yolopoint_tpu_torch.training.cli",
                          "--config", str(cfg_snapshot), "--exper_name", pseudo_run,
                          "--output_dir", str(runs_dir),
                          "--pretrained", str(run_dir), *dev])
    else:
        print(f"[bootstrap] stage 3 done ({pseudo_dir}/best.pt exists)", flush=True)

    # ---- stage 3.5: the HPatches protocol on both trained models ----
    hp_data = _path(args.hpatches_data)
    seconds["hpatches"] = 0.0
    if hp_data.is_dir():
        for d in (run_dir, pseudo_dir):
            out = d / "hpatches.json"
            if (args.fresh or not out.exists()) and (d / "best.pt").is_file():
                stage("hpatches", [py, "-u", "-m", "yolopoint_tpu_torch.evaluation.hpatches_runner",
                                   "--data", str(hp_data), "--weights", str(d),
                                   "--json", str(out), *dev])
    else:
        print(f"[bootstrap] no {hp_data}, skipping HPatches eval", flush=True)

    # ---- stage 4: the summary ----
    seconds["summary"] = 0.0
    stage("summary", [py, "-u", "-m", "yolopoint_tpu_torch.tools.summarize_run",
                      "--runs", str(runs_dir)])
    return seconds


if __name__ == "__main__":
    main()
