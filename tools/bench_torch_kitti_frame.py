#!/usr/bin/env python3
"""The KITTI frame (`chip_smoke.serve_kitti`: YOLOPointv52-S, a 375x1242
frame at `img_size` 960, the host resize, one request, the point tracker)
with the host's BLAS thread pool as it comes and with it cut to one thread
(`OPENBLAS_NUM_THREADS=1`), in turns: default, one, one, default. Each turn
is its own process (the pool's size is read when numpy loads); prints one
JSON line a turn, then the card's name and power limit.

    python3 tools/bench_torch_kitti_frame.py [--frames 12]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

TURN = """
import json, os, sys
sys.path.insert(0, {repo!r})
import chip_smoke
from yolopoint_tpu_torch import set_determinism
set_determinism()
line, _ = chip_smoke.serve_kitti(0, frames={frames})
print(json.dumps({{"openblas_threads": os.environ.get("OPENBLAS_NUM_THREADS", "default"),
                  "ms_p50": line["ms_p50"], "ms_all": line["ms_all"],
                  "tracks_alive": line["tracks_alive"]}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke

    for threads in ("default", "1", "1", "default"):
        env = dict(os.environ)
        env.pop("OPENBLAS_NUM_THREADS", None)
        if threads != "default":
            env["OPENBLAS_NUM_THREADS"] = threads
        proc = subprocess.run([sys.executable, "-c", TURN.format(repo=str(REPO),
                                                                 frames=args.frames)],
                              env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
