"""The port's dataset sanity checks (`yolopoint_tpu_torch/data/sanity.py`)
against the JAX package's, on the CPU: `overlay_sample` bit for bit on
seeded samples (grey and colour, with and without a valid mask, points and
boxes leaving the frame), `point_count_stats` equal on the same dataset, and
`check_homography_roundtrip` below 1e-3 px through the port's own sampler
and warp, the same number for the same seed."""

import numpy as np
import pytest
import torch

from yolopoint_tpu.data import sanity as jax_sanity
from yolopoint_tpu_torch.data import sanity

torch.set_num_threads(1)


def sample(rng, channels, masked):
    H, W = int(rng.integers(20, 60)), int(rng.integers(20, 80))
    out = {"image": rng.random((H, W, channels)).astype(np.float32),
           "points": rng.uniform(-5, [W + 5, H + 5], (30, 2)).astype(np.float32),
           "point_mask": rng.random(30) < 0.8,
           "boxes": np.concatenate([rng.integers(0, 3, (5, 1)), rng.uniform(0, 1, (5, 2)),
                                    rng.uniform(0.05, 0.8, (5, 2))], 1).astype(np.float32),
           "box_mask": rng.random(5) < 0.8}
    if masked:
        out["valid_mask"] = (rng.random((H, W)) < 0.7).astype(np.float32)
    return out


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_overlay_equals_jax(channels, masked):
    rng = np.random.default_rng(channels * 2 + masked)
    for _ in range(10):
        s = sample(rng, channels, masked)
        np.testing.assert_array_equal(sanity.overlay_sample(s), jax_sanity.overlay_sample(s))
    bare = {"image": rng.random((16, 16, channels)).astype(np.float32)}
    np.testing.assert_array_equal(sanity.overlay_sample(bare), jax_sanity.overlay_sample(bare))


class _Dataset:
    def __init__(self, counts):
        self.counts = counts

    def __len__(self):
        return len(self.counts)

    def get(self, i):
        return {"points": np.zeros((self.counts[i], 2))}


def test_point_count_stats_equal_jax():
    ds = _Dataset([0, 3, 7, 0, 12, 5, 9])
    assert sanity.point_count_stats(ds) == jax_sanity.point_count_stats(ds)
    assert sanity.point_count_stats(ds, max_samples=3) == jax_sanity.point_count_stats(ds, 3)
    assert sanity.point_count_stats(_Dataset([])) == jax_sanity.point_count_stats(_Dataset([]))


def test_homography_roundtrip():
    err = sanity.check_homography_roundtrip(64, 96, n=20, seed=3)
    assert 0 <= err < 1e-3
    assert sanity.check_homography_roundtrip(64, 96, n=20, seed=3) == err
    assert sanity.check_homography_roundtrip(64, 96, n=20, seed=4) != err
