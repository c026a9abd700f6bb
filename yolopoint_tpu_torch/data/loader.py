"""Batching loader: weighted multi-dataset sampling, fixed-shape collate and
thread prefetch.

Counterpart of `yolopoint_tpu/data/loader.py` with the same numpy epoch
schedule, so that one seed gives the same batches in both packages:

* several datasets are sampled with length-normalized weights
  (`length_normalized_weights`, `rng.choice` with replacement), one dataset
  by a permutation of its indices;
* `pad_collate` stacks samples into padded `(B, max_points, 2)` /
  `(B, max_boxes, 5)` arrays with validity masks, keeping the image dtype
  (uint8 stays uint8 up to the device). Samples of different image shapes
  (a mix of datasets whose static shapes differ, such as KITTI's crop
  canvas and COCO's letterbox in `configs/concat_datasets.yaml`) are put
  top-left on a canvas of the largest height and width, padded with 114
  as the letterbox pads, their boxes renormalized to it; a sample without
  the batch's crop corner gets (0, 0). The JAX package's collate raises
  there, so its loader cannot draw such a mix;
* batches are decoded by a thread pool with `prefetch` batches in flight;
* mosaic is decided per batch (`mosaic_prob`, the largest of the
  datasets');
* each sample draws its crop corner and mosaic tiles from its own
  `np.random.RandomState`, seeded by (seed, epoch, batch, slot), so worker
  threads never share a stream (the JAX loader's datasets draw from the
  global `np.random`, which its threads share).

Batches are numpy; the agent moves them to its device. With a
`host_augment_config` (the `data.augmentation` subtree) each batch also gets
the host-warp payload (`data.host_augment.host_warp_views`), its samples
warped in the loader's thread pool, from the JAX loader's numpy streams:
`default_rng(seed + 7919)` across the epochs of a shuffled loader, a fresh
one every epoch of an unshuffled (val) loader, `default_rng(seed)` in
`sample_batch`. Each batch's seeds are drawn in batch order as it is
queued, so its warps are prefetched with it (the JAX loader warps a batch
when it is asked for, behind the asynchronous dispatch of the step before;
the port's step waits for its device work). `device` picks the numpy (CPU)
or the compiled host warp.

Under data parallelism (`mesh` of more than one rank) every rank draws the
same epoch schedule from the same seed and loads, decodes and host-warps
only its own rows of each global batch (`parallel.mesh.rank_rows`): the
host work splits with the world size, and each sample keeps the stream and
warp seed of its global slot, so the rows do not depend on the world size.
`batch_size` stays the global batch; a rank's batches hold
`batch_size / world size` rows.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional, Sequence

import numpy as np

from yolopoint_tpu_torch.data.host_augment import host_warp_views
from yolopoint_tpu_torch.parallel.mesh import Mesh, rank_rows


def length_normalized_weights(sizes: Sequence[int]) -> np.ndarray:
    """Per-sample weights so each dataset contributes equally per epoch."""
    weights = np.concatenate([np.full(n, 1.0 / n) for n in sizes])
    return weights / weights.sum()


def pad_collate(
    samples: Sequence[dict[str, Any]],
    max_points: int = 1024,
    max_boxes: int = 128,
) -> dict[str, Any]:
    """Stack samples into fixed-shape arrays + masks (and their `names`);
    samples of different image shapes on a shared canvas."""
    B = len(samples)
    shapes = [s["image"].shape for s in samples]
    H, W = max(h for h, _, _ in shapes), max(w for _, w, _ in shapes)
    C, dtype = shapes[0][2], samples[0]["image"].dtype
    mixed = any(sh[:2] != (H, W) for sh in shapes)
    # the letterbox's grey, in the samples' scale (uint8, or float in [0, 1])
    fill = np.uint8(114) if dtype == np.uint8 else np.asarray(np.float32(114) / np.float32(255),
                                                              dtype)
    batch = {
        "image": np.full((B, H, W, C), fill, dtype) if mixed else np.zeros((B, H, W, C), dtype),
        "points": np.zeros((B, max_points, 2), np.float32),
        "point_mask": np.zeros((B, max_points), bool),
        "boxes": np.zeros((B, max_boxes, 5), np.float32),
        "box_mask": np.zeros((B, max_boxes), bool),
    }
    held = samples if mixed else samples[:1]
    crop_key = next((k for k in ("crop_yx", "mosaic_crop_yx") if any(k in s for s in held)),
                    None)
    if crop_key:
        batch[crop_key] = np.zeros((B, 2), np.float32)
    names = []
    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        batch["image"][i, :h, :w] = s["image"]
        pts = np.asarray(s.get("points", np.zeros((0, 2))))[:max_points]
        batch["points"][i, : len(pts)] = pts[:, :2]
        batch["point_mask"][i, : len(pts)] = True
        boxes = np.asarray(s.get("boxes", np.zeros((0, 5))))[:max_boxes]
        if mixed and len(boxes):  # normalized to the sample's frame: to the canvas
            boxes = boxes * np.array([1, w / W, h / H, w / W, h / H], np.float32)
        batch["boxes"][i, : len(boxes)] = boxes
        batch["box_mask"][i, : len(boxes)] = True
        if crop_key and crop_key in s:
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
        device: str = "cuda",
        mesh: Optional[Mesh] = None,
        local_world: int = 1,
    ):
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
        # the host's cores less 2, shared by its `local_world` ranks
        self.num_workers = num_workers or min(
            max(((os.cpu_count() or 4) - 2) // local_world, 2), 16)
        self.steps_per_epoch = steps_per_epoch or max(self.total // batch_size, 1)
        self.weights = length_normalized_weights(self.sizes) if len(self.datasets) > 1 else None
        self.host_augment_config = host_augment_config
        self.device = device
        self._host_rng = np.random.default_rng(seed + 7919)
        self._offsets = np.cumsum([0] + self.sizes)
        self.mosaic_prob = max(
            (float(getattr(d, "mosaic_prob", 0.0) or 0.0) for d in self.datasets),
            default=0.0,
        ) if shuffle else 0.0
        self.epoch = 0  # iterations begun: one seed component of the samples' streams
        self.rows = slice(None) if mesh is None else rank_rows(batch_size, mesh.size, mesh.rank)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def sample_batch(self) -> dict[str, Any]:
        """One synchronously built B=1 batch for shape probing: no thread
        pool, no prefetch, no epoch schedule consumed."""
        batch = pad_collate([self._fetch(0, False, np.random.RandomState(self.seed))],
                            self.max_points, self.max_boxes)
        if self.host_augment_config is not None:
            batch = host_warp_views(batch, self.host_augment_config,
                                    np.random.default_rng(self.seed), device=self.device)
        return batch

    def sample_rng(self, epoch: int, batch: int, slot: int) -> np.random.RandomState:
        """The stream of sample `slot` of batch `batch` in iteration `epoch`."""
        return np.random.RandomState([self.seed, epoch, batch, slot])

    def _fetch(self, global_idx: int, mosaic: bool,
               rng: np.random.RandomState) -> dict[str, Any]:
        d = int(np.searchsorted(self._offsets, global_idx, side="right") - 1)
        return self.datasets[d].get(global_idx - self._offsets[d], mosaic=mosaic, rng=rng)

    def _epoch_indices(self) -> np.ndarray:
        n = self.steps_per_epoch * self.batch_size
        if self.shuffle:
            if self.weights is not None:
                return self.rng.choice(self.total, size=n, replace=True, p=self.weights)
            return self.rng.permutation(self.total)[:n] if n <= self.total else \
                self.rng.choice(self.total, size=n, replace=True)
        return np.arange(n) % self.total

    def __iter__(self) -> Iterator[dict[str, Any]]:
        epoch, self.epoch = self.epoch, self.epoch + 1
        # an unshuffled (val) loader warps the same views every epoch
        host_rng = self._host_rng if self.shuffle else np.random.default_rng(self.seed + 7919)
        idxs = self._epoch_indices()
        rows = idxs[: self.steps_per_epoch * self.batch_size].reshape(-1, self.batch_size)
        mosaic_flags = (
            self.rng.random(len(rows)) < self.mosaic_prob
            if self.mosaic_prob else np.zeros(len(rows), bool)
        )
        # one thread assembles the batches in order (collate, then the host
        # warps, whose per-sample work goes back to the pool), so batches in
        # flight are warped ahead of the step
        with ThreadPoolExecutor(self.num_workers) as ex, ThreadPoolExecutor(1) as assembler:

            def submit(bi):
                slots = range(len(rows[bi]))[self.rows]  # this rank's slots
                futs = [ex.submit(self._fetch, int(rows[bi][slot]), bool(mosaic_flags[bi]),
                                  self.sample_rng(epoch, bi, slot))
                        for slot in slots]
                seeds = None if self.host_augment_config is None else \
                    host_rng.integers(2**31, size=len(rows[bi]))[self.rows]
                return assembler.submit(self._assemble, futs, seeds, ex)

            depth = min(self.prefetch + 1, len(rows))
            pending = [submit(bi) for bi in range(depth)]
            for bi in range(len(rows)):
                fut = pending.pop(0)
                nxt = bi + depth
                if nxt < len(rows):
                    pending.append(submit(nxt))
                yield fut.result()

    def _assemble(self, futs, seeds, executor) -> dict[str, Any]:
        """A batch from its samples' futures, with the host-warp payload
        from `seeds` where they are given."""
        batch = pad_collate([f.result() for f in futs], self.max_points, self.max_boxes)
        if seeds is not None:
            batch = host_warp_views(batch, self.host_augment_config, None, executor=executor,
                                    device=self.device, seeds=seeds)
        return batch
