"""The host-warp pseudo-label export against the JAX package's, on the
CPU, with the trained YOLOPoint-n of `tests/test_torch_export.py` in both
packages:

* `homography_adaptation_host` with given homographies and with a seeded
  `np.random.Generator` (the same `sample_homography_np` draws) against
  the JAX function: the same keypoints, scores within 5e-6 plus 2^-19
  relative (`tests/test_torch_export.py`'s tolerance; the warps are the
  same bytes, the heatmaps the two packages' forwards);
* `export_pseudo_labels` with its defaults in both packages, nothing
  patched: both warp on the host off their accelerator, from
  `default_rng(seed)`, and write the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_export import KW, PARAMS, _image, _same_keypoints, models  # noqa: F401
from yolopoint_tpu.data import native as jnative
from yolopoint_tpu.export.homography_adaptation import \
    export_pseudo_labels as jax_export_pseudo_labels
from yolopoint_tpu.export.homography_adaptation import \
    homography_adaptation_host as jax_homography_adaptation_host
from yolopoint_tpu.ops.heatmap import cells_to_heatmap as jax_cells_to_heatmap
from yolopoint_tpu_torch.export import homography_adaptation as port_ha
from yolopoint_tpu_torch.export import export_pseudo_labels
from yolopoint_tpu_torch.ops.homography import sample_homography_np

torch.set_num_threads(1)


def jax_forward(jmodel):
    return jax.jit(lambda v, im: jax_cells_to_heatmap(
        jmodel.apply(v, im, train=False)["semi"].astype(jnp.float32)))


@pytest.mark.parametrize("draws", ["given", "seeded"])
def test_host_adaptation_matches_jax(models, draws):
    assert jnative.available()
    jmodel, variables, model = models
    image = _image(31, 64, 96)
    if draws == "given":
        homs = np.stack([np.eye(3)] + [sample_homography_np(
            (2.0, 2.0), shift=-1.0, seed=s, **PARAMS) for s in range(5)])
        kw = dict(homographies=homs)
        rngs = (None, None)
    else:
        kw = dict(num_homographies=6)
        rngs = (np.random.default_rng(3), np.random.default_rng(3))
    want = jax_homography_adaptation_host(jmodel, variables, image, rngs[0], chunk=4,
                                          _forward=jax_forward(jmodel), **kw, **KW)
    got = port_ha.homography_adaptation_host(model, image, rngs[1], chunk=4, **kw, **KW)
    assert got[0].dtype == np.float32 and got[2].sum() > 5
    _same_keypoints(*got, *want)


def test_default_exports_take_the_same_path(models, tmp_path):
    jmodel, variables, model = models
    images = {f"img_{i}": _image(200 + i, 64, 64) for i in range(2)}
    assert port_ha.default_host_warp(torch.device("cpu"))
    jax_export_pseudo_labels(jmodel, variables, images, tmp_path / "jax", seed=4,
                             num_homographies=4, **KW)
    paths = export_pseudo_labels(model, images, tmp_path / "port", seed=4, num_homographies=4,
                                 **KW)
    assert sorted(p.name for p in paths) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for p in paths:
        got, want = np.load(p)["pts"], np.load(tmp_path / "jax" / p.name)["pts"]
        ones = np.ones(len(got), bool)
        _same_keypoints(got[:, :2], got[:, 2], ones, want[:, :2], want[:, 2],
                        np.ones(len(want), bool))
