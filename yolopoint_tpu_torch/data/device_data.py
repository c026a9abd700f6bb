"""Device-resident dataset: the whole training set lives in GPU memory as
fixed-shape tensors, and each batch is gathered on the device by index.

Counterpart of `yolopoint_tpu/data/device_data.py`. With the set resident,
a micro-step's host-to-device traffic is a `(B,)` index vector instead of
the image batch (about 39 MB of uint8 at B=32, 640x640). `build_host_arrays`
renders every sample once into padded numpy arrays and caches
deterministic generators (the synthetic renderer) as `.npy` files under a
key of their configuration; `DeviceDataLoader` wraps a host `DataLoader`,
keeps its epoch schedule (the same shuffle rng) and gathers each batch
with `torch.index_select` on the resident tensors. Under data parallelism
every rank keeps the whole set on its own card and gathers its rows of each
global batch (`mesh`).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np
import torch

from yolopoint_tpu_torch.parallel.mesh import Mesh, shard_batch
from yolopoint_tpu_torch.utils.device import resolve_device
from yolopoint_tpu_torch.utils.logging import LOGGER

ARRAY_KEYS = ("image", "points", "point_mask", "boxes", "box_mask")


def _dataset_cache_key(datasets, max_points, max_boxes):
    """A digest of the generators' identity for the on-disk array cache:
    only datasets that are pure functions of their config (the synthetic
    renderer) are cacheable; anything else gives None. The same key as the
    JAX package's for the same datasets."""
    parts = [f"v1|{max_points}|{max_boxes}"]
    for d in datasets:
        attrs = ("seed", "action", "hw", "primitives", "blur_prob")
        if any(not hasattr(d, a) for a in attrs) or not hasattr(d, "points_dir"):
            return None
        pd = d.points_dir
        pd_sig = ""
        if pd is not None:
            try:  # re-exported pseudo-labels at the same path -> new key
                pd_sig = f"{pd}:{max(os.path.getmtime(os.path.join(pd, f)) for f in os.listdir(pd))}"
            except (OSError, ValueError):
                pd_sig = str(pd)
        parts.append("|".join(str(getattr(d, a)) for a in attrs) + f"|{len(d)}|{pd_sig}")
    return hashlib.sha1("||".join(parts).encode()).hexdigest()[:16]


def build_host_arrays(
    datasets: Sequence[Any],
    max_points: int = 256,
    max_boxes: int = 64,
    cache_dir: str | None = None,
) -> dict[str, np.ndarray]:
    """Every sample of `datasets` in one set of fixed-shape padded arrays
    (images keep their dtype; labels f32 with validity masks).
    Deterministic generators are cached under `cache_dir/<key>/` as `.npy`
    files (images memory-mapped when read back)."""
    key = _dataset_cache_key(datasets, max_points, max_boxes) if cache_dir else None
    if key is not None:
        cdir = Path(cache_dir) / key
        if all((cdir / f"{k}.npy").exists() for k in ARRAY_KEYS):
            LOGGER.info(f"device dataset: loading cached arrays from {cdir}")
            return {k: np.load(cdir / f"{k}.npy", mmap_mode="r" if k == "image" else None)
                    for k in ARRAY_KEYS}
    samples_total = sum(len(d) for d in datasets)
    first = datasets[0].get(0)
    H, W, C = first["image"].shape
    data = {
        "image": np.zeros((samples_total, H, W, C), first["image"].dtype),
        "points": np.zeros((samples_total, max_points, 2), np.float32),
        "point_mask": np.zeros((samples_total, max_points), bool),
        "boxes": np.zeros((samples_total, max_boxes, 5), np.float32),
        "box_mask": np.zeros((samples_total, max_boxes), bool),
    }
    i = 0
    overflow_pts = overflow_boxes = 0
    for ds in datasets:
        for j in range(len(ds)):
            s = ds.get(j)
            data["image"][i] = s["image"]
            pts = np.asarray(s.get("points", np.zeros((0, 2), np.float32)))
            overflow_pts += max(len(pts) - max_points, 0)
            pts = pts[:max_points]
            data["points"][i, : len(pts)] = pts[:, :2]
            data["point_mask"][i, : len(pts)] = True
            boxes = np.asarray(s.get("boxes", np.zeros((0, 5), np.float32)))
            overflow_boxes += max(len(boxes) - max_boxes, 0)
            boxes = boxes[:max_boxes]
            data["boxes"][i, : len(boxes)] = boxes
            data["box_mask"][i, : len(boxes)] = True
            i += 1
    if overflow_pts or overflow_boxes:
        LOGGER.warning(
            f"device dataset: truncated {overflow_pts} points / "
            f"{overflow_boxes} boxes beyond the ({max_points}, {max_boxes}) pad")
    if key is not None:
        cdir = Path(cache_dir) / key
        cdir.mkdir(parents=True, exist_ok=True)
        for k, v in data.items():
            np.save(cdir / f"{k}.npy", v)
        LOGGER.info(f"device dataset: cached arrays -> {cdir}")
    return data


def dataset_nbytes(datasets: Sequence[Any], max_points: int = 256, max_boxes: int = 64) -> int:
    """Device memory `build_host_arrays` output takes (renders one sample)."""
    n = sum(len(d) for d in datasets)
    first = datasets[0].get(0)
    H, W, C = first["image"].shape
    per = (H * W * C * first["image"].dtype.itemsize
           + max_points * (2 * 4 + 1) + max_boxes * (5 * 4 + 1))
    return n * per


class DeviceDataLoader:
    """Iterates like the wrapped host `DataLoader` (same epoch schedule from
    the same rng) but gathers each batch on `device` from resident tensors:
    this rank's rows of it under a `mesh` of more than one rank. Mosaic
    batches and crop keys are not supported."""

    def __init__(self, base, device: str | torch.device | None = None,
                 cache_dir: str | None = None, mesh: Mesh | None = None):
        if base.host_augment_config is not None or base.mosaic_prob:
            raise ValueError("DeviceDataLoader: host-warp/mosaic loaders unsupported")
        self.base = base
        self.device = resolve_device(device)
        self.batch_size = base.batch_size
        self.steps_per_epoch = base.steps_per_epoch
        self.mesh = mesh
        host = build_host_arrays(base.datasets, base.max_points, base.max_boxes,
                                 cache_dir=cache_dir)
        self.nbytes = sum(v.nbytes for v in host.values())
        # np.array copies the read-only memory map of a cached image array
        self.resident_data = {k: torch.from_numpy(np.array(v)).to(self.device)
                              for k, v in host.items()}
        del host
        LOGGER.info(
            f"device-resident dataset: {len(base.datasets)} dataset(s), "
            f"{self.resident_data['image'].shape[0]} samples, "
            f"{self.nbytes / 1e9:.2f} GB on {self.device}")

    def __len__(self) -> int:
        return self.steps_per_epoch

    def sample_batch(self) -> dict[str, Any]:
        return self.base.sample_batch()

    def epoch_rows(self) -> np.ndarray:
        """One epoch's global batch index rows, `(steps_per_epoch, B)` int32,
        from the wrapped loader's schedule rng."""
        idxs = self.base._epoch_indices()
        return np.asarray(idxs[: self.steps_per_epoch * self.batch_size], np.int32).reshape(
            -1, self.batch_size)

    def gather_row(self, row: np.ndarray) -> dict[str, torch.Tensor]:
        """The samples at indices `row`, gathered on the device."""
        idx = torch.as_tensor(np.asarray(row, np.int64)).to(self.device, non_blocking=True)
        return {k: torch.index_select(v, 0, idx) for k, v in self.resident_data.items()}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        for row in self.epoch_rows():
            yield self.gather_row(row if self.mesh is None else shard_batch(row, self.mesh))
