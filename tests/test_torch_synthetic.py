"""The port's synthetic-shapes renderer (`yolopoint_tpu_torch.data.synthetic`,
drawn with `data/raster.py`) against the JAX package's (drawn with `cv2`):
the same `(seed, split, index)` gives bit-equal images, points and boxes.

* 64 triples at 120x160 with `shapes_per_image` 1 and with 4;
* 4 triples at 640x640 with 4 shapes (the s640 setting);
* each primitive alone (`primitives=[name]`), 16 triples each;
* `SyntheticShapes.get` (class map with dropped classes, `points_dir`
  pseudo-labels, the RAM cache returning copies) and `iter_export`.
"""

import numpy as np
import pytest

from yolopoint_tpu.data import synthetic as jax_synthetic
from yolopoint_tpu_torch.data import synthetic as port_synthetic


def triples(n, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 1000)), "train" if i % 2 else "val", int(rng.integers(0, 100000)))
            for i in range(n)]


def assert_same_render(seed, split, idx, H, W, **kw):
    want = jax_synthetic.render_sample(jax_synthetic._rng_for(seed, split, idx), H, W, **kw)
    got = port_synthetic.render_sample(port_synthetic._rng_for(seed, split, idx), H, W, **kw)
    for name, a, b in zip(("image", "points", "boxes"), want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, seed, split, idx)
        assert np.array_equal(a, b), f"{name} differs at {(seed, split, idx)}"


@pytest.mark.parametrize("n_shapes", [1, 4])
def test_render_sample_bit_equal_120x160(n_shapes):
    for seed, split, idx in triples(64, n_shapes):
        assert_same_render(seed, split, idx, 120, 160, n_shapes=n_shapes)


def test_render_sample_bit_equal_s640():
    for seed, split, idx in triples(4, 640):
        assert_same_render(seed, split, idx, 640, 640, n_shapes=4)


@pytest.mark.parametrize("primitive", [n for n, _ in jax_synthetic.PRIMITIVES])
def test_each_primitive_alone(primitive):
    for seed, split, idx in triples(16, len(primitive)):
        assert_same_render(seed, split, idx, 96, 128, primitives=[primitive], blur_prob=0.5)


CFG = {"dataset": "synthetic_shapes", "preprocessing": {"resize": [96, 128]},
       "length": {"train": 12, "val": 4}, "generation": {"seed": 5, "shapes_per_image": 2}}


def same_sample(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("action", ["train", "val"])
def test_dataset_get_equals_jax(action):
    names = ["cube", "polygon", "star"]  # ellipse and checkerboard boxes are dropped
    jds = jax_synthetic.SyntheticShapes(CFG, action, names)
    pds = port_synthetic.SyntheticShapes(CFG, action, names)
    assert len(jds) == len(pds) and np.array_equal(jds.cls_map, pds.cls_map)
    for i in range(len(jds)):
        same_sample(jds.get(i), pds.get(i))
    for (jn, ji), (pn, pi) in zip(jds.iter_export(), pds.iter_export()):
        assert jn == pn and np.array_equal(ji, pi)


def test_points_dir_and_cache_isolation(tmp_path):
    cfg = dict(CFG, generation={"seed": 5, "points_dir": str(tmp_path)})
    rng = np.random.default_rng(0)
    for i in range(12):
        np.savez(tmp_path / f"synth_train_{i:06d}.npz",
                 pts=rng.uniform(0, 90, (7, 3)).astype(np.float32))
    for action in ("train", "val"):
        jds = jax_synthetic.SyntheticShapes(cfg, action)
        pds = port_synthetic.SyntheticShapes(cfg, action)
        for i in (0, 3):
            same_sample(jds.get(i), pds.get(i))
    pds = port_synthetic.SyntheticShapes(CFG, "train")
    first = pds.get(2)
    first["points"][:] = -1  # a consumer mutates its copy
    assert 2 in pds._cache and not np.array_equal(pds.get(2)["points"], first["points"])
