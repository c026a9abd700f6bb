"""Pseudo-label export CLI: walk a dataset split, adapt each image by N
homographies, write `{name}.npz` with `pts (K, 3) [x, y, prob]`. On the
card the warps run on the device (K4); on a CPU run on the host
(`homography_adaptation_host`, numpy), as the JAX CLI warps on the host off
the TPU.

Counterpart of `yolopoint_tpu/export/cli.py`, with the same flags plus
`--device` (default the GPU; `cpu` runs the plain versions of the kernels):

  python -m yolopoint_tpu_torch.export.cli --config configs/synthetic_export.yaml \
      [--action train|val] [--output DIR] [--data_root datasets] \
      [--weights FILE] [--seed 0] [--device cuda]

The model is `model.name` (default `YOLOPointDet`) at `model.version`, in f32
with BN unfolded (folded if the weights file holds it folded). `--weights`
(or the config's `pretrained`) is a reference-schema torch file, a port
training run, or an orbax run or checkpoint directory of the JAX package
(`models.convert.load_weights`); without one the model keeps torch's
initialization under `--seed`. Images come from the port's `build_dataset`
through its `iter_export` (no crop, no mosaic): `synthetic_shapes` renders
them; KITTI, COCO, Campus and image folders read JPEG and PNG files
(`configs/coco_export.yaml` reads COCO's `.jpg`), resized so the longer
side is `img_size` and padded to a /32 canvas.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser(description="Export keypoint pseudo-labels")
    parser.add_argument("--config", required=True)
    parser.add_argument("--action", default="train", choices=["train", "val"])
    parser.add_argument("--output", default=None)
    parser.add_argument("--data_root", default="datasets")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    import torch

    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.export.homography_adaptation import export_pseudo_labels
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.models.convert import is_folded, load_weights
    from yolopoint_tpu_torch.utils.config import get as cfg_get
    from yolopoint_tpu_torch.utils.config import load_config
    from yolopoint_tpu_torch.utils.device import resolve_device
    from yolopoint_tpu_torch.utils.logging import LOGGER

    config = load_config(args.config)
    export_cfg = config.get("export", {})
    weights = args.weights or config.get("pretrained")
    out_dir = Path(args.output or export_cfg.get("output_dir", "points_out"))
    device = resolve_device(args.device)

    model_cfg = config.get("model", {})
    names = config.get("names", [])
    name, version = model_cfg.get("name", "YOLOPointDet"), model_cfg.get("version", "s")
    nc = max(len(names), 1)
    if weights:
        state = load_weights(weights, device)["state_dict"]
        model = build_model(name, version, nc=nc, fused=is_folded(state), device="cpu")
        model.load_state_dict(state)
        LOGGER.info(f"loaded weights from {weights}")
    else:  # random weights: still runs (a pipeline smoke test)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            model = build_model(name, version, nc=nc, device="cpu")
        LOGGER.info("no weights given: exporting with random initialization")
    model = model.to(device).eval()

    # iter_export bypasses crop and mosaic: the split name only picks the images
    ds = build_dataset(config["data"], action=args.action, names=names, root=args.data_root,
                       device=device)
    sp = cfg_get(config, "model.superpoint", {}) or {}
    paths = export_pseudo_labels(
        model, ds.iter_export(), out_dir, seed=args.seed,
        num_homographies=int(export_cfg.get("num_homographies", 100)),
        conf_thresh=float(sp.get("detection_threshold", 0.015)),
        nms_radius=int(sp.get("nms", 4)),
        top_k=int(sp.get("top_k", 1000)),
        hom_params=export_cfg.get("homography") or {},
        erosion_radius=int(export_cfg.get("erosion_radius", 3)),
    )
    LOGGER.info(f"exported {len(paths)} pseudo-label files -> {out_dir}")
    return paths


if __name__ == "__main__":
    main()
