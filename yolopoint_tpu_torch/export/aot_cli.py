"""Serving-artifact export CLI.

Counterpart of `yolopoint_tpu/export/aot_cli.py`, with its flags and
`--device`:

  python -m yolopoint_tpu_torch.export.aot_cli --out yps.pt2 \
      [--weights best.pth.tar] [--model YOLOPoint --version s --nc 80] \
      [--height 640 --width 640 --batch 1] [--config configs/inference.yaml] \
      [--f32] [--device cuda]

Writes a self-contained `torch.export` artifact (`export/aot.py`; the
parameters baked in) bound to the device it was exported on (default the
GPU). The default is the deploy path: BN folded into the convolutions and a
bf16 fused model; `--f32` exports the f32 model. Without `--weights` the
model is torch's default initialization at seed 0 (a smoke test). Load it
with `yolopoint_tpu_torch.export.aot.load_serving_artifact`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Export an AOT serving artifact")
    p.add_argument("--out", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--model", default="YOLOPoint")
    p.add_argument("--version", default="s")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=640)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--f32", action="store_true", help="f32 conv stack (default bf16 fused)")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from yolopoint_tpu_torch.export.aot import save_serving_artifact
    from yolopoint_tpu_torch.frontend.pipeline import deploy_model
    from yolopoint_tpu_torch.utils.config import load_config
    from yolopoint_tpu_torch.utils.logging import LOGGER

    op_config = {}
    if args.config:
        cfg = load_config(args.config)
        model_cfg = cfg.get("model", {}) or {}
        op_config = dict(model_cfg.get("superpoint", {}) or {})
        op_config.update(model_cfg.get("yolo", {}) or {})
    if not args.weights:
        LOGGER.info("no weights given — exporting torch's default initialization (smoke test)")
    model, dtype, _, _ = deploy_model(args.weights, args.model, args.version, args.nc, args.f32,
                                      args.device)
    save_serving_artifact(
        args.out, model, None, op_config,
        batch=args.batch, height=args.height, width=args.width,
        compute_dtype=dtype, device=args.device,
    )
    LOGGER.info(f"wrote serving artifact to {args.out}")


if __name__ == "__main__":
    main()
