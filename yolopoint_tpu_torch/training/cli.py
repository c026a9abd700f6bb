r"""Training CLI, the counterpart of `yolopoint_tpu/training/cli.py`:

    python -m yolopoint_tpu_torch.training.cli --config configs/synthetic_s640.yaml \
        --exper_name run --output_dir logs [--resume] [--pretrained FILE] [--device cuda]

Reads the YAML config (`utils.config`, no PyYAML), builds the datasets and
loaders, snapshots the merged config into `<output_dir>/<exper_name>/config.yml`
and runs `TrainAgent.train()`. The device defaults to the GPU and a missing
GPU raises; `--device cpu` runs the plain PyTorch path. The augmentation
warp always runs on the device: a config with `host_warp: true` raises.
With `data.device_resident: auto` (the default) or `true`, the training set
is put on the device when the feed is plain (no mosaic) and it takes less
than 6e9 bytes, its rendered arrays cached under
`<data_root>/_device_cache`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

DEVICE_RESIDENT_LIMIT = 6e9  # bytes, as the JAX package's CLI


def build_agent(argv=None):
    """Parse the CLI's arguments and build the wired `TrainAgent` (loaders,
    device-resident feed, run directory) without starting the epoch loop."""
    parser = argparse.ArgumentParser(description="Train YOLOPoint with the PyTorch port")
    parser.add_argument("--config", required=True)
    parser.add_argument("--exper_name", default="exp")
    parser.add_argument("--model", default=None)
    parser.add_argument("--version", default=None)
    parser.add_argument("--output_dir", default="logs")
    parser.add_argument("--data_root", default="datasets")
    parser.add_argument("--debug", action="store_true",
                        help="truncate datasets + force val split (overfit test)")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--pretrained", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader, dataset_nbytes
    from yolopoint_tpu_torch.data.loader import DataLoader
    from yolopoint_tpu_torch.training.agent import TrainAgent
    from yolopoint_tpu_torch.utils.config import load_config, resolve_sub_configs, save_config
    from yolopoint_tpu_torch.utils.device import resolve_device
    from yolopoint_tpu_torch.utils.logging import LOGGER

    device = resolve_device(args.device)
    overrides = {}
    if args.model or args.version:
        overrides["model"] = {}
        if args.model:
            overrides["model"]["name"] = args.model
        if args.version:
            overrides["model"]["version"] = args.version
    if args.resume:
        overrides["resume"] = True
    if args.pretrained:
        overrides["pretrained"] = args.pretrained

    config = load_config(args.config, overrides)
    names = config.get("names", [])
    aug_cfg = (config.get("data") or {}).get("augmentation") or {}
    if aug_cfg.get("host_warp"):
        raise NotImplementedError(
            "host_warp: true warps the training views on the host with the JAX package's "
            "native warp, which is not ported; the port warps on the device (remove host_warp)")

    sub_cfgs = resolve_sub_configs(config, Path(args.config).parent)
    tp = config.get("training_params", {})
    train_sets = [build_dataset(c["data"], "train", names, args.data_root, args.debug)
                  for c in sub_cfgs]
    val_sets = [build_dataset(c["data"], "val", names, args.data_root, args.debug)
                for c in sub_cfgs]
    train_loader = DataLoader(train_sets, int(tp.get("train_batch_size", 8)), shuffle=True,
                              seed=args.seed)
    dev_res = (config.get("data") or {}).get("device_resident", "auto")
    if dev_res is True or dev_res == "auto":
        feed_plain = not train_loader.mosaic_prob
        fits = dataset_nbytes(train_sets, train_loader.max_points,
                              train_loader.max_boxes) < DEVICE_RESIDENT_LIMIT
        if (feed_plain and fits) if dev_res == "auto" else True:
            train_loader = DeviceDataLoader(
                train_loader, device, cache_dir=str(Path(args.data_root) / "_device_cache"))
        else:
            LOGGER.info(f"device_resident=auto: keeping host loader "
                        f"(plain_feed={feed_plain}, fits={fits})")
    val_loader = DataLoader(val_sets, int(tp.get("val_batch_size", 8)), shuffle=False,
                            seed=args.seed)

    output_dir = Path(args.output_dir) / args.exper_name
    output_dir.mkdir(parents=True, exist_ok=True)
    save_config(config, output_dir / "config.yml")
    LOGGER.info(f"training {config.get('model', {}).get('name')} -> {output_dir}")
    return TrainAgent(config, output_dir, train_loader, val_loader, seed=args.seed, device=device)


def main(argv=None):
    agent = build_agent(argv)
    agent.train()  # a KeyboardInterrupt saves a `last` checkpoint
    return agent


if __name__ == "__main__":
    main()
