"""Detection evaluation of a checkpoint on a dataset split.

Counterpart of `yolopoint_tpu/evaluation/detect_cli.py`: the device runs
the forward (eval mode) and the val protocol's box NMS (box decode, then
`ops.nms.batched_box_nms` at conf 0.001 / IoU 0.6, multi-label, the
candidate cap 30000: the exact tiled scan over K2); the host builds the
batches and accumulates the mAP statistics (`evaluation/yolo_eval.py`).
Speed is reported per image as the JAX CLI reports it: "pre" (the host's
batch build) and "inference_nms" (forward and NMS, to a synchronize).

    python -m yolopoint_tpu_torch.evaluation.detect_cli --config configs/kitti.yaml \
        --weights FILE [--batch 16] [--conf 0.001] [--iou 0.6] [--split val] \
        [--data-root datasets] [--out results.json] [--bf16] [--device cuda]

`--weights` is a reference-schema torch file (`models.convert.load_weights`),
a run of the port's trainer (its directory, `best.pt` or a
`ckpts/<step>.pt`; the EMA shadow preferred, the model's name and version
from `best_meta.json` beside it), or an orbax run or checkpoint directory of
the JAX package, as the JAX CLI takes it (EMA preferred, read without JAX).
The device defaults to the GPU; `cpu` runs the plain versions of the
kernels.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def load_eval_weights(path: str | Path, device=None) -> tuple[dict, dict]:
    """`(state_dict, meta)` of a weights file, a port run or a JAX-package
    run (see the module), read as a run on `device` reads it."""
    from yolopoint_tpu_torch.models.convert import load_weights
    from yolopoint_tpu_torch.training.checkpoint import load_run_variables

    p = Path(path)
    run_file = p.is_file() and "model_state_dict" not in torch.load(
        str(p), map_location="cpu", weights_only=True)
    if not run_file:
        loaded = load_weights(p, device)
        return loaded["state_dict"], loaded["meta"]
    meta_path = p.parent / "best_meta.json"
    if not meta_path.exists() and p.parent.name == "ckpts":
        meta_path = p.parent.parent / "best_meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return load_run_variables(p), meta


def make_eval_program(model: torch.nn.Module, conf_thres: float, iou_thres: float,
                      max_det: int, nc: int, max_nms: int = 30000,
                      compute_dtype: torch.dtype = torch.float32):
    """`program(images)`: forward in eval mode and the val protocol's box
    NMS on `(B, H, W, 3)` f32 images on the model's device; returns the
    detections (`boxes`, `scores`, `classes`, `valid`, ...) as tensors."""
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops.nms import batched_box_nms

    anchors_ps = model.Detect.anchors_per_stride()
    strides = model.Detect.strides
    device = next(model.parameters()).device
    autocast = torch.autocast(device.type, dtype=compute_dtype) \
        if compute_dtype != torch.float32 else torch.autocast(device.type, enabled=False)

    @torch.no_grad()
    def program(images: torch.Tensor) -> dict:
        model.eval()
        with autocast:
            out = model(images.permute(0, 3, 1, 2).contiguous())
        pred = decode_levels(out["objects"], anchors_ps, strides)
        return batched_box_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                               max_det=max_det, multi_label=nc > 1, max_nms=max_nms)

    return program


def evaluate_detection(program, loader, names, device: str | torch.device | None = None,
                       verbose: bool = True) -> dict:
    """mAP@[.5:.95], per-class AP and speed over a val loader of padded
    `{image, boxes (cxcywh normalized), box_mask}` batches (shuffle off):
    every image scored once (the wrapped rows of the last batch skipped).
    `device`: where the batches go (default: the GPU)."""
    from yolopoint_tpu_torch.evaluation.yolo_eval import (
        ConfusionMatrix,
        ap_per_class,
        fitness_yolo,
        process_batch,
    )
    from yolopoint_tpu_torch.ops.boxes import xywhn2xyxy
    from yolopoint_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    iouv = np.linspace(0.5, 0.95, 10)
    confusion = ConfusionMatrix(nc=max(len(names), 1))
    stats = []
    n_images = 0
    n_unique = getattr(loader, "total", None)
    pre_s = infer_s = 0.0
    t_host = time.perf_counter()
    for batch in loader:
        images = batch["image"]
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        B, H, W = images.shape[:3]
        x = torch.from_numpy(images).to(device)
        pre_s += time.perf_counter() - t_host

        t0 = time.perf_counter()
        det = {k: v.cpu().numpy() for k, v in program(x).items()}
        infer_s += time.perf_counter() - t0

        for b in range(B):
            if n_unique is not None and n_images >= n_unique:
                break  # wrapped duplicate rows of the final partial batch
            gts = batch["boxes"][b][batch["box_mask"][b].astype(bool)]
            labels = np.concatenate(
                [gts[:, :1], xywhn2xyxy(torch.from_numpy(gts[:, 1:]), W, H).numpy()], axis=1
            ) if len(gts) else np.zeros((0, 5))
            dv = det["valid"][b]
            dets = np.concatenate(
                [det["boxes"][b][dv], det["scores"][b][dv, None],
                 det["classes"][b][dv, None].astype(np.float32)], axis=1
            ) if dv.any() else np.zeros((0, 6))
            correct = process_batch(dets, labels, iouv)
            stats.append((correct, dets[:, 4], dets[:, 5], labels[:, 0]))
            confusion.process_batch(dets, labels)
            n_images += 1
        t_host = time.perf_counter()

    mp = mr = map50 = map_ = 0.0
    per_class = {}
    if stats:
        correct = np.concatenate([s[0] for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pcls = np.concatenate([s[2] for s in stats])
        tcls = np.concatenate([s[3] for s in stats])
        if len(tcls) and len(conf):
            _, _, p, r, f1, ap, classes, _ = ap_per_class(correct, conf, pcls, tcls,
                                                          return_curves=True)
            mp, mr = float(p.mean()), float(r.mean())
            map50, map_ = float(ap[:, 0].mean()), float(ap.mean())
            for i, c in enumerate(classes):
                c = int(c)
                per_class[names[c] if c < len(names) else str(c)] = {
                    "precision": float(p[i]), "recall": float(r[i]),
                    "ap50": float(ap[i, 0]), "ap": float(ap[i].mean()),
                }
    results = {
        "images": n_images,
        "precision": mp, "recall": mr, "mAP50": map50, "mAP": map_,
        "fitness_yolo": fitness_yolo(mp, mr, map50, map_),
        "per_class": per_class,
        "speed_ms_per_image": {
            "pre": round(1e3 * pre_s / max(n_images, 1), 3),
            "inference_nms": round(1e3 * infer_s / max(n_images, 1), 3),
        },
    }
    if verbose:
        print(f"{'class':>16} {'P':>8} {'R':>8} {'mAP50':>8} {'mAP':>8}")
        print(f"{'all':>16} {mp:8.4f} {mr:8.4f} {map50:8.4f} {map_:8.4f}")
        for name, row in per_class.items():
            print(f"{name:>16} {row['precision']:8.4f} {row['recall']:8.4f} "
                  f"{row['ap50']:8.4f} {row['ap']:8.4f}")
        sp = results["speed_ms_per_image"]
        print(f"Speed: {sp['pre']:.1f}ms pre-process, "
              f"{sp['inference_nms']:.1f}ms inference+NMS per image ({n_images} images)")
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="YOLOPoint detection val (PyTorch port)")
    parser.add_argument("--config", required=True, help="reference-schema YAML")
    parser.add_argument("--weights", required=True,
                        help="reference-schema .pt/.pth(.tar), or a port run / checkpoint")
    parser.add_argument("--split", default="val", choices=["val", "train"])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--conf", type=float, default=0.001)
    parser.add_argument("--iou", type=float, default=0.6)
    parser.add_argument("--max-det", type=int, default=300)
    parser.add_argument("--data-root", default="datasets")
    parser.add_argument("--out", default=None, help="write results JSON here")
    parser.add_argument("--bf16", action="store_true", help="bf16 autocast (deploy precision)")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.data.loader import DataLoader
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.models.convert import is_folded
    from yolopoint_tpu_torch.utils.config import load_config, resolve_sub_configs
    from yolopoint_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    names = list(config.get("names", []))
    nc = max(len(names), 1)
    state, meta = load_eval_weights(args.weights, device)
    model_cfg = config.get("model", {})
    model = build_model(meta.get("model_name", model_cfg.get("name", "YOLOPoint")),
                        meta.get("version", model_cfg.get("version", "s")), nc=nc,
                        fused=is_folded(state), device="cpu")
    model.load_state_dict(state)
    model = model.to(device).eval()

    sets = [build_dataset(c["data"], args.split, names, args.data_root, device=device)
            for c in resolve_sub_configs(config, Path(args.config).parent)]
    # ceil: the final partial batch too (its wrapped rows are skipped), so
    # every image scores once
    total = sum(len(s) for s in sets)
    loader = DataLoader(sets, args.batch, shuffle=False,
                        steps_per_epoch=max(-(-total // args.batch), 1))
    program = make_eval_program(model, args.conf, args.iou, args.max_det, nc=nc,
                                compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    results = evaluate_detection(program, loader, names, device=device)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
        print(f"[detect_cli] wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
