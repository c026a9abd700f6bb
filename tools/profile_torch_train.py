#!/usr/bin/env python3
"""Where a training micro-step's time goes on the GPU, for the PyTorch port.

Runs `TrainAgent` on the training config of `configs/synthetic_s640.yaml`
(YOLOPoint-S, nc=5, 640x640, B=32, bf16 autocast, accum 2; the config and
the seeded uint8 batches of `chip_smoke.py`) and profiles, with
`torch.profiler`, a steady window of whole micro-steps, of the augmentation
alone (draws + both views) and of the two forwards + losses + backward
alone on fixed views. Prints one JSON line per stage: host wall time per step, device
kernel time per step, the device's busy share, kernels per step, and the
kernel groups that take the most device time; then the card's name and
power limit.

    python3 tools/profile_torch_train.py [--steps 4]

The profiler adds host overhead, so wall times here run above the ones
`chip_smoke.py` measures without it; device kernel times are unaffected.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import chip_smoke
    from profile_torch_serve import profile_stage
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.data import build_training_views
    from yolopoint_tpu_torch.training import TrainAgent, draw_step
    from yolopoint_tpu_torch.training.step import losses_from_outputs

    set_determinism()
    cfg = chip_smoke.s640_train_config()
    B, (H, W) = cfg["training_params"]["train_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = chip_smoke.SeededBatches(3, B, H, W, len(cfg["names"]),
                                      cfg["data"]["length"]["train"], "cuda")
    run_dir = tempfile.TemporaryDirectory()  # the agent's run directory, removed at exit
    agent = TrainAgent(cfg, run_dir.name, loader, seed=0, device="cuda")
    batch = loader.batches[0]
    draws = draw_step(agent.gen, tuple(batch["image"].shape), agent.aug_config, agent.weights)
    keys = ("image", "points", "point_mask", "boxes", "box_mask")

    def augment():
        d = draw_step(agent.gen, tuple(batch["image"].shape), agent.aug_config, agent.weights)
        with torch.no_grad():
            return build_training_views(*(batch[k] for k in keys), agent.aug_config, d["aug"])

    with torch.no_grad():
        base, warped = build_training_views(*(batch[k] for k in keys), agent.aug_config,
                                            draws["aug"])
    anchors = agent.model.Detect.anchors_per_stride()

    def forward(img):
        out = agent.model(img.permute(0, 3, 1, 2).contiguous())
        return dict(out, semi=out["semi"].permute(0, 2, 3, 1),
                    desc=out["desc"].permute(0, 2, 3, 1))

    def forward_backward():
        with torch.autocast("cuda", dtype=agent.compute_dtype):
            out, out_w = forward(base.image), forward(warped.image)
        total, _ = losses_from_outputs(out, out_w, base, warped, draws["desc"], agent.obj_cfg,
                                       agent.weights, anchors, agent.nc)
        total.backward()
        agent.model.zero_grad(set_to_none=True)

    stages = {"micro_step": lambda: agent.step(batch), "augment": augment,
              "forward_backward": forward_backward}
    for stage, fn in stages.items():
        line = {"stage": stage, "batch": B, "input": [H, W],
                **profile_stage(fn, args.steps)}
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
