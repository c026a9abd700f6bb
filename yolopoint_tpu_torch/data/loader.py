"""Batching loader: weighted multi-dataset sampling, fixed-shape collate and
thread prefetch.

Counterpart of `yolopoint_tpu/data/loader.py` with the same numpy epoch
schedule, so that one seed gives the same batches in both packages:

* several datasets are sampled with length-normalized weights
  (`length_normalized_weights`, `rng.choice` with replacement), one dataset
  by a permutation of its indices;
* `pad_collate` stacks samples into padded `(B, max_points, 2)` /
  `(B, max_boxes, 5)` arrays with validity masks, keeping the image dtype
  (uint8 stays uint8 up to the device);
* batches are decoded by a thread pool with `prefetch` batches in flight;
* mosaic is decided per batch (`mosaic_prob`, the largest of the
  datasets').

Batches are numpy; the agent moves them to its device. The host-warp views
(`host_augment_config`) are not ported: a loader given one raises.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Sequence

import numpy as np


def length_normalized_weights(sizes: Sequence[int]) -> np.ndarray:
    """Per-sample weights so each dataset contributes equally per epoch."""
    weights = np.concatenate([np.full(n, 1.0 / n) for n in sizes])
    return weights / weights.sum()


def pad_collate(
    samples: Sequence[dict[str, Any]],
    max_points: int = 1024,
    max_boxes: int = 128,
) -> dict[str, Any]:
    """Stack samples into fixed-shape arrays + masks (and their `names`)."""
    B = len(samples)
    H, W, C = samples[0]["image"].shape
    batch = {
        "image": np.zeros((B, H, W, C), samples[0]["image"].dtype),
        "points": np.zeros((B, max_points, 2), np.float32),
        "point_mask": np.zeros((B, max_points), bool),
        "boxes": np.zeros((B, max_boxes, 5), np.float32),
        "box_mask": np.zeros((B, max_boxes), bool),
    }
    crop_key = next((k for k in ("crop_yx", "mosaic_crop_yx") if k in samples[0]), None)
    if crop_key:
        batch[crop_key] = np.zeros((B, 2), np.float32)
    names = []
    for i, s in enumerate(samples):
        batch["image"][i] = s["image"]
        pts = np.asarray(s.get("points", np.zeros((0, 2))))[:max_points]
        batch["points"][i, : len(pts)] = pts[:, :2]
        batch["point_mask"][i, : len(pts)] = True
        boxes = np.asarray(s.get("boxes", np.zeros((0, 5))))[:max_boxes]
        batch["boxes"][i, : len(boxes)] = boxes
        batch["box_mask"][i, : len(boxes)] = True
        if crop_key:
            batch[crop_key][i] = s[crop_key]
        names.append(s.get("name", str(i)))
    batch["names"] = names
    return batch


class DataLoader:
    """Multi-dataset weighted-sampling loader with thread prefetch."""

    def __init__(
        self,
        datasets: Sequence[Any],
        batch_size: int,
        shuffle: bool = True,
        max_points: int = 1024,
        max_boxes: int = 128,
        seed: int = 0,
        prefetch: int = 2,
        steps_per_epoch: Optional[int] = None,
        num_workers: Optional[int] = None,
        host_augment_config: Optional[dict] = None,
    ):
        if host_augment_config is not None:
            raise NotImplementedError(
                "host-warp augmentation (data.augmentation.host_warp) is not ported; the port "
                "warps on the device (ROADMAP.md, Queue 1 item 5)")
        self.datasets = list(datasets)
        self.sizes = [len(d) for d in self.datasets]
        self.total = sum(self.sizes)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_points = max_points
        self.max_boxes = max_boxes
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers or min(max((os.cpu_count() or 4) - 2, 2), 16)
        self.steps_per_epoch = steps_per_epoch or max(self.total // batch_size, 1)
        self.weights = length_normalized_weights(self.sizes) if len(self.datasets) > 1 else None
        self.host_augment_config = None
        self._offsets = np.cumsum([0] + self.sizes)
        self.mosaic_prob = max(
            (float(getattr(d, "mosaic_prob", 0.0) or 0.0) for d in self.datasets),
            default=0.0,
        ) if shuffle else 0.0

    def __len__(self) -> int:
        return self.steps_per_epoch

    def sample_batch(self) -> dict[str, Any]:
        """One synchronously built B=1 batch for shape probing: no thread
        pool, no prefetch, no epoch schedule consumed."""
        return pad_collate([self._fetch(0, False)], self.max_points, self.max_boxes)

    def _fetch(self, global_idx: int, mosaic: bool) -> dict[str, Any]:
        d = int(np.searchsorted(self._offsets, global_idx, side="right") - 1)
        return self.datasets[d].get(global_idx - self._offsets[d], mosaic=mosaic)

    def _epoch_indices(self) -> np.ndarray:
        n = self.steps_per_epoch * self.batch_size
        if self.shuffle:
            if self.weights is not None:
                return self.rng.choice(self.total, size=n, replace=True, p=self.weights)
            return self.rng.permutation(self.total)[:n] if n <= self.total else \
                self.rng.choice(self.total, size=n, replace=True)
        return np.arange(n) % self.total

    def __iter__(self) -> Iterator[dict[str, Any]]:
        idxs = self._epoch_indices()
        rows = idxs[: self.steps_per_epoch * self.batch_size].reshape(-1, self.batch_size)
        mosaic_flags = (
            self.rng.random(len(rows)) < self.mosaic_prob
            if self.mosaic_prob else np.zeros(len(rows), bool)
        )
        with ThreadPoolExecutor(self.num_workers) as ex:

            def submit(bi):
                return [ex.submit(self._fetch, int(i), bool(mosaic_flags[bi]))
                        for i in rows[bi]]

            depth = min(self.prefetch + 1, len(rows))
            pending = [submit(bi) for bi in range(depth)]
            for bi in range(len(rows)):
                futs = pending.pop(0)
                nxt = bi + depth
                if nxt < len(rows):
                    pending.append(submit(nxt))
                samples = [f.result() for f in futs]
                yield pad_collate(samples, self.max_points, self.max_boxes)
