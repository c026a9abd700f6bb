"""Summarize the port's finished training runs into one JSON file, as the
JAX package's `tools/summarize_run.py` does for its runs.

Reads each `<runs>/<name>/metrics.jsonl` (the port's `MetricsWriter`),
picks the validation record of best fitness and the first one, and adds the
run's `hpatches.json` where the HPatches runner wrote one:

  python -m yolopoint_tpu_torch.tools.summarize_run [--runs runs] [--out FILE]

The default `--out` is `<runs>/RESULTS_torch.json`, beside the runs it
summarizes (the repository root's `RESULTS.json` is the JAX package's).
Relative paths are taken from the repository root.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KEEP = [
    "repeatability", "homography_correctness", "matching_score",
    "mAP50", "mAP", "precision", "recall", "fitness",
    "loss", "loss_det", "loss_desc", "loss_obj",
]


def summarize(run_dir: Path) -> dict | None:
    """The run's summary, or None without validation records."""
    mf = run_dir / "metrics.jsonl"
    if not mf.exists():
        return None
    best, first, n_val = None, None, 0
    for line in mf.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "validation/fitness" not in rec:
            continue
        n_val += 1
        if first is None:
            first = rec
        if best is None or rec["validation/fitness"] >= best["validation/fitness"]:
            best = rec
    if best is None:
        return None

    def pick(rec):
        return {k: round(float(rec[f"validation/{k}"]), 4)
                for k in KEEP if f"validation/{k}" in rec}

    out = {
        "best": pick(best),
        "best_step": int(best.get("step", -1)),
        "first_val": pick(first),
        "n_val_epochs": n_val,
    }
    hp = run_dir / "hpatches.json"
    if hp.exists():
        try:
            out["hpatches"] = json.loads(hp.read_text())
        except json.JSONDecodeError:
            pass
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="runs")
    ap.add_argument("--out", default=None, help="default: <runs>/RESULTS_torch.json")
    args = ap.parse_args(argv)

    runs_dir = ROOT / args.runs
    out = {}
    if runs_dir.is_dir():
        for d in sorted(runs_dir.iterdir()):
            s = summarize(d) if d.is_dir() else None
            if s is not None:
                out[d.name] = s
    dest = ROOT / args.out if args.out else runs_dir / "RESULTS_torch.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
