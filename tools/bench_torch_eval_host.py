#!/usr/bin/env python3
"""The two evaluation paths whose time is on the host, for one or more
checkouts of the repository in one call: `chip_smoke.val` (`TrainAgent.validate`,
YOLOPoint-S 640 px, B = 8, 4 timed batches) and `chip_smoke.hpatches` (the
HPatches runner's CLI on 10 written pairs, YOLOPoint-n 256x320, seeded
weights). Each checkout runs in its own process in the order given, so
`--repo A --repo B --repo B --repo A` compares two trees on the same card
in turns. Prints one JSON line a turn (ms a val batch and its CUDA-event
host part, ms a HPatches pair, and the host splits where the checkout's
`chip_smoke` records them), then the card's name and power limit.

    python3 tools/bench_torch_eval_host.py --repo _checkout/parent --repo . \\
        --repo . --repo _checkout/parent

A checkout needs `chip_smoke.py` and `yolopoint_tpu_torch/` (its kernels are
built in its own tree). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# off the path: `tools/profile.py` would shadow the standard `profile`
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]

TURN = """
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r})
import chip_smoke
from yolopoint_tpu_torch import set_determinism
from yolopoint_tpu_torch.ops import _build
set_determinism()
_build.build()
_build.library()
val, _ = chip_smoke.val(seed=0)
with tempfile.TemporaryDirectory() as tmp:
    root, weights = Path(tmp) / "hpatches", Path(tmp) / "yolopoint_n.pt"
    pairs = chip_smoke.write_hpatches_scenes(root, seed=0)
    chip_smoke.save_reference_weights(weights, seed=0)
    hp, _ = chip_smoke.hpatches(0, root, weights, pairs)
print(json.dumps({{
    "repo": {repo!r},
    "val_ms_per_batch_p50": val["ms_per_batch_p50"], "val_ms_per_batch_all": val["ms_per_batch_all"],
    "val_host_ms_p50": val["split_ms_p50"]["host"],
    "val_host_split_ms_per_batch_mean": val.get("host_split_ms_per_batch_mean"),
    "val_homography_correctness": val["scalars"]["homography_correctness"],
    "hpatches_ms_per_pair_p50": hp["ms_per_pair_p50"], "hpatches_ms_per_pair_all": hp["ms_per_pair_all"],
    "hpatches_host_split_ms_per_pair_mean": hp.get("host_split_ms_per_pair_mean"),
    "hpatches_metrics": hp["metrics"]}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", action="append", required=True,
                    help="a checkout to run (repeat; in the order given)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    for repo in args.repo:
        path = str(Path(repo).resolve())
        proc = subprocess.run([sys.executable, "-c", TURN.format(repo=path)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
