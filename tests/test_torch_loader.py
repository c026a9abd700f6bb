"""The port's loaders (`yolopoint_tpu_torch.data.loader`, `.device_data`)
against the JAX package's over the same synthetic-shapes config:

* `pad_collate` of the same samples is equal (dtypes, padding, masks, names);
* `DataLoader`'s epoch indices and batches are equal for one dataset
  (a shuffled permutation) and for two datasets (length-normalized weighted
  sampling), over two epochs, and for the unshuffled val loader;
* `build_host_arrays` is equal, its `.npy` cache reads back equal (and the
  JAX package reads the port's cache under the same key);
* `DeviceDataLoader` (device `cpu`) yields the JAX `epoch_rows` schedule
  and the host loader's batches, gathered from its resident tensors;
* a host-warp loader for a GPU run raises where its compiled host warp
  cannot be built (the host-warp streams themselves:
  `tests/test_torch_host_views.py`).
"""

import types

import numpy as np
import pytest
import torch

from yolopoint_tpu.data import device_data as jax_device_data
from yolopoint_tpu.data import loader as jax_loader
from yolopoint_tpu.data.synthetic import SyntheticShapes as JaxShapes
from yolopoint_tpu_torch.data import device_data, loader
from yolopoint_tpu_torch.data.synthetic import SyntheticShapes

torch.set_num_threads(1)

NAMES = ["polygon", "star", "ellipse", "checkerboard", "cube"]


def cfg(seed, length=10, hw=(48, 64)):
    return {"dataset": "synthetic_shapes", "preprocessing": {"resize": list(hw)},
            "length": {"train": length, "val": 4}, "generation": {"seed": seed}}


def datasets(cls, seeds, action="train"):
    return [cls(cfg(s, 10 + 3 * i), action, NAMES) for i, s in enumerate(seeds)]


def same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "names":
            assert list(a[k]) == list(b[k])
        else:
            got = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
            assert got.dtype == a[k].dtype and np.array_equal(got, a[k]), k


def test_pad_collate_equals_jax():
    ds = SyntheticShapes(cfg(3), "train", NAMES)
    samples = [ds.get(i) for i in range(5)]
    same_batch(jax_loader.pad_collate(samples, 16, 4), loader.pad_collate(samples, 16, 4))
    np.testing.assert_array_equal(jax_loader.length_normalized_weights([3, 7, 2]),
                                  loader.length_normalized_weights([3, 7, 2]))


@pytest.mark.parametrize("seeds", [(3,), (3, 8)], ids=["one_dataset", "two_weighted"])
def test_data_loader_equals_jax(seeds):
    kw = dict(batch_size=4, shuffle=True, seed=11, max_points=32, max_boxes=8, num_workers=2)
    want = jax_loader.DataLoader(datasets(JaxShapes, seeds), **kw)
    got = loader.DataLoader(datasets(SyntheticShapes, seeds), **kw)
    assert len(want) == len(got) and (want.weights is None) == (len(seeds) == 1)
    for _ in range(2):  # two epochs: the schedule rng advances alike
        batches_w, batches_g = list(want), list(got)
        assert len(batches_w) == len(batches_g) == len(got)
        for a, b in zip(batches_w, batches_g):
            same_batch(a, b)
    np.testing.assert_array_equal(want._epoch_indices(), got._epoch_indices())
    same_batch(want.sample_batch(), got.sample_batch())


def test_val_loader_equals_jax():
    kw = dict(batch_size=3, shuffle=False, seed=0, max_points=32, max_boxes=8)
    want = jax_loader.DataLoader(datasets(JaxShapes, (4,), "val"), **kw)
    got = loader.DataLoader(datasets(SyntheticShapes, (4,), "val"), **kw)
    for a, b in zip(want, got):
        same_batch(a, b)


def test_build_host_arrays_and_cache(tmp_path):
    want = jax_device_data.build_host_arrays(datasets(JaxShapes, (3, 8)), 32, 8)
    got = device_data.build_host_arrays(datasets(SyntheticShapes, (3, 8)), 32, 8,
                                        cache_dir=str(tmp_path))
    same_batch(want, got)
    key = device_data._dataset_cache_key(datasets(SyntheticShapes, (3, 8)), 32, 8)
    assert key == jax_device_data._dataset_cache_key(datasets(JaxShapes, (3, 8)), 32, 8)
    assert sorted(p.name for p in (tmp_path / key).iterdir()) == sorted(
        f"{k}.npy" for k in device_data.ARRAY_KEYS)
    cached = device_data.build_host_arrays(datasets(SyntheticShapes, (3, 8)), 32, 8,
                                           cache_dir=str(tmp_path))
    assert isinstance(cached["image"], np.memmap)
    same_batch(want, {k: np.asarray(v) for k, v in cached.items()})
    from_jax = jax_device_data.build_host_arrays(datasets(JaxShapes, (3, 8)), 32, 8,
                                                 cache_dir=str(tmp_path))
    same_batch(want, {k: np.asarray(v) for k, v in from_jax.items()})
    assert device_data.dataset_nbytes(datasets(SyntheticShapes, (3, 8)), 32, 8) == \
        jax_device_data.dataset_nbytes(datasets(JaxShapes, (3, 8)), 32, 8) == \
        sum(v.nbytes for v in want.values())


def test_device_data_loader_rows_and_batches(tmp_path):
    kw = dict(batch_size=4, shuffle=True, seed=5, max_points=32, max_boxes=8)
    host = jax_loader.DataLoader(datasets(JaxShapes, (3, 8)), **kw)
    dev = device_data.DeviceDataLoader(loader.DataLoader(datasets(SyntheticShapes, (3, 8)), **kw),
                                       device="cpu", cache_dir=str(tmp_path))
    assert len(dev) == len(host) and dev.resident_data["image"].dtype == torch.uint8
    rows_jax = jax_loader.DataLoader(datasets(JaxShapes, (3, 8)), **kw)
    fake = types.SimpleNamespace(base=rows_jax, steps_per_epoch=len(rows_jax), batch_size=4)
    for _ in range(2):
        want_rows = jax_device_data.DeviceDataLoader.epoch_rows(fake)
        got_rows = dev.epoch_rows()
        assert got_rows.dtype == np.int32 and np.array_equal(want_rows, got_rows)
        for row, hb in zip(got_rows, host):
            hb.pop("names")
            same_batch(hb, dev.gather_row(row))
    fresh = device_data.DeviceDataLoader(
        loader.DataLoader(datasets(SyntheticShapes, (3, 8)), **kw), device="cpu")
    for hb, b in zip(jax_loader.DataLoader(datasets(JaxShapes, (3, 8)), **kw), fresh):
        hb.pop("names")
        same_batch(hb, b)


def test_host_warp_raises(monkeypatch):
    """A GPU run's host warp is the compiled host code, with no numpy
    fallback: where it cannot be built, the loader raises."""
    from yolopoint_tpu_torch.ops import _build

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", no_build)
    ld = loader.DataLoader(datasets(SyntheticShapes, (3,)), 2,
                           host_augment_config={"homographic": {"enable": True}})
    assert ld.device == "cuda"
    with pytest.raises(RuntimeError, match="nvcc"):
        next(iter(ld))
