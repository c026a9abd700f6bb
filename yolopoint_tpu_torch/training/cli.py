r"""Training CLI, the counterpart of `yolopoint_tpu/training/cli.py`:

    python -m yolopoint_tpu_torch.training.cli --config configs/synthetic_s640.yaml \
        --exper_name run --output_dir logs [--resume] [--pretrained FILE] [--device cuda]

Data-parallel, one process a rank:

    torchrun --nproc_per_node N -m yolopoint_tpu_torch.training.cli --config ... \
        [--backend gloo]

The process group is joined from torchrun's environment before the agent
is built (`parallel.mesh.initialize_multi_host`; without that environment
the run is one process, world size 1): NCCL on the GPU, gloo on the
CPU. NCCL cannot put two ranks on one GPU, so ranks that share a card
raise unless `--backend gloo` asks for gloo, whose collectives stage the
card's tensors through the host (a test setup). Each
rank logs its world size and rank, loads its rows of every global batch
(`train_batch_size`) with `(cores - 2) / local ranks` loader threads (at
most 16) and as many torch threads as its share of the cores (both logged,
`threads {"rank": r, "torch": n, "loader": m}`), and
logs its kernel launches and the peak bytes it allocated on the other
cards (`other_cards {"rank": r, "peak_bytes": {card: n}}`, 0 where it kept
to its own) when training ends; rank 0 alone writes the run directory's
files.

Reads the YAML config (`utils.config`, no PyYAML), builds the datasets
(synthetic shapes, or COCO / KITTI / Campus / image folders of JPEG or PNG
files under `--data_root`; a `data.sub_configs` mix such as
`configs/concat_datasets.yaml` samples its datasets with length-normalized
weights) and loaders, snapshots the merged config into
`<output_dir>/<exper_name>/config.yml` and runs `TrainAgent.train()`. The
device defaults to the GPU and a missing GPU raises; `--device cpu` runs
the plain PyTorch path (and decodes images in numpy).

The augmentation warp runs on the host (`data.host_augment`: the loader's
threads warp the views, the step runs no image warp) or in the step on the
device, by the JAX CLI's rule (`warp_path`): `data.augmentation.host_warp`
where the config sets it, else the host when the host has 4 or more cores
to hide the warps behind the step. The host warp is compiled host code on a
GPU run and its numpy twin on a CPU run. The path is logged as
`augmentation warp path: host (compiled|numpy)` or `device (step)`.
With `data.device_resident: auto` (the default) or `true`, the training set
is put on the device when the feed is plain (no host warp, no mosaic) and
it takes less than 6e9 bytes, its arrays cached under
`<data_root>/_device_cache`. The
config's `pretrained` (or `--pretrained`) is the warm start, with
`shrink_perturb` and `freeze_layers` applied by the agent.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import Any, Mapping

DEVICE_RESIDENT_LIMIT = 6e9  # bytes, as the JAX package's CLI
HOST_WARP_MIN_CORES = 4  # fewer cores cannot hide the warps behind the step


def warp_path(aug_cfg: Mapping[str, Any], device) -> tuple[bool, str]:
    """`(host_warp, label)`: whether the views are warped on the host, and
    the path as the CLI logs it. `host_warp` is the config's where it is
    set, else whether the host has `HOST_WARP_MIN_CORES` cores (the host
    warp runs compiled on a GPU run, a run without it raises, and on a CPU
    run its numpy twin stands in)."""
    import torch

    host = bool(aug_cfg.get("host_warp", (os.cpu_count() or 1) >= HOST_WARP_MIN_CORES))
    form = "numpy" if torch.device(device).type == "cpu" else "compiled"
    return host, f"host ({form})" if host else "device (step)"


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
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process-group backend (default: nccl on cuda, gloo on cpu); "
                             "gloo lets ranks share a card")
    args = parser.parse_args(argv)

    import torch

    from yolopoint_tpu_torch.data.datasets import build_dataset
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader, dataset_nbytes
    from yolopoint_tpu_torch.data.loader import DataLoader
    from yolopoint_tpu_torch.parallel.mesh import barrier, initialize_multi_host
    from yolopoint_tpu_torch.training.agent import TrainAgent
    from yolopoint_tpu_torch.utils.config import load_config, resolve_sub_configs, save_config
    from yolopoint_tpu_torch.utils.device import resolve_device
    from yolopoint_tpu_torch.utils.logging import LOGGER

    mesh = initialize_multi_host(device=resolve_device(args.device).type, backend=args.backend)
    device = mesh.device
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    cores = os.cpu_count() or 4
    if local_world > 1:  # the host's cores shared by its ranks
        torch.set_num_threads(max(cores // local_world, 1))
    LOGGER.info(f"rank {mesh.rank} of world size {mesh.size} on {device}"
                + (f" ({mesh.backend})" if mesh.backend else ""))
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
    host_warp, label = warp_path(aug_cfg, device)
    host_cfg = aug_cfg if host_warp else None
    if mesh.is_main:
        LOGGER.info(f"augmentation warp path: {label}")

    sub_cfgs = resolve_sub_configs(config, Path(args.config).parent)
    tp = config.get("training_params", {})
    train_sets = [build_dataset(c["data"], "train", names, args.data_root, args.debug, device)
                  for c in sub_cfgs]
    val_sets = [build_dataset(c["data"], "val", names, args.data_root, args.debug, device)
                for c in sub_cfgs]
    train_loader = DataLoader(train_sets, int(tp.get("train_batch_size", 8)), shuffle=True,
                              seed=args.seed, host_augment_config=host_cfg, device=str(device),
                              mesh=mesh, local_world=local_world)
    LOGGER.info("threads " + json.dumps({"rank": mesh.rank, "torch": torch.get_num_threads(),
                                         "loader": train_loader.num_workers}))
    dev_res = (config.get("data") or {}).get("device_resident", "auto")
    if dev_res is True or dev_res == "auto":
        feed_plain = host_cfg is None and not train_loader.mosaic_prob
        fits = dataset_nbytes(train_sets, train_loader.max_points,
                              train_loader.max_boxes) < DEVICE_RESIDENT_LIMIT
        if (feed_plain and fits) if dev_res == "auto" else True:
            # rank 0 renders and caches the set; the other ranks read its cache
            if not mesh.is_main:
                barrier(mesh)
            train_loader = DeviceDataLoader(
                train_loader, device, cache_dir=str(Path(args.data_root) / "_device_cache"),
                mesh=mesh)
            if mesh.is_main:
                barrier(mesh)
        else:
            LOGGER.info(f"device_resident=auto: keeping host loader "
                        f"(plain_feed={feed_plain}, fits={fits})")
    val_aug = (config.get("data") or {}).get("val_augmentation") or aug_cfg
    val_loader = DataLoader(val_sets, int(tp.get("val_batch_size", 8)), shuffle=False,
                            seed=args.seed, host_augment_config=val_aug if host_warp else None,
                            device=str(device), local_world=local_world)

    output_dir = Path(args.output_dir) / args.exper_name
    output_dir.mkdir(parents=True, exist_ok=True)
    if mesh.is_main:
        save_config(config, output_dir / "config.yml")
        LOGGER.info(f"training {config.get('model', {}).get('name')} -> {output_dir}")
    return TrainAgent(config, output_dir, train_loader, val_loader, seed=args.seed, device=device,
                      mesh=mesh)


def main(argv=None):
    """Build the agent and train; each rank then logs its kernel launches
    (`kernel_launches {"rank": r, ...}`) and its peak bytes on the other
    cards (`other_cards`), and the process group is left."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.parallel.mesh import foreign_card_bytes, shutdown
    from yolopoint_tpu_torch.utils.logging import LOGGER

    try:
        agent = build_agent(argv)
        agent.train()  # a KeyboardInterrupt saves a `last` checkpoint
        LOGGER.info("kernel_launches " + json.dumps({"rank": agent.mesh.rank,
                                                     **_build.launch_counts}))
        LOGGER.info("other_cards " + json.dumps({"rank": agent.mesh.rank,
                                                 "peak_bytes": foreign_card_bytes(agent.mesh)}))
    finally:
        shutdown()
    return agent


if __name__ == "__main__":
    main()
