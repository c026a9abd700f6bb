"""Pseudo-label export by homographic adaptation: the port against the JAX
package on the CPU, with the trained YOLOPoint-n of
`artifacts/synth_r5_pseudo_ext/best` carried across (converted in-process
as `tools/jax_checkpoint_to_torch.py` converts it) and the JAX package's
own homography draws fed to the port (`sample_homography_batch(fold_in(
PRNGKey(seed), i), N - 1, ...)` after the identity). 64-128 px, N = 4, 8.

Tolerances:
  aggregate heatmap  within 5e-6 of the JAX steps' (measured up to 6.4e-7:
                     `torch.linalg.inv` and `jnp.linalg.inv` differ in the
                     last bits, and the warps back are bilinear);
  keypoints          the same points; scores within the aggregate's 5e-6
                     plus 2^-19 relative (the port's keys at tile-aligned
                     shapes, K1's function; the JAX CPU path is exact);
                     decoded by the port from the JAX aggregate, the same
                     points with scores within 2^-19 relative;
  export files       the same names, the same points, probabilities as the
                     keypoints' scores.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from yolopoint_tpu.export.homography_adaptation import \
    export_pseudo_labels as jax_export_pseudo_labels
from yolopoint_tpu.export.homography_adaptation import \
    homography_adaptation_batch as jax_homography_adaptation_batch
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import load_weights as jax_load_weights
from yolopoint_tpu.models.convert import variables_to_torch_state_dict
from yolopoint_tpu.ops.geometry import compute_valid_mask as jax_compute_valid_mask
from yolopoint_tpu.ops.geometry import warp_image as jax_warp_image
from yolopoint_tpu.ops.heatmap import cells_to_heatmap as jax_cells_to_heatmap
from yolopoint_tpu.ops.homography import sample_homography_batch as jax_sample_homography_batch
from yolopoint_tpu_torch.export import (aggregate_heatmap, draw_homographies,
                                        export_pseudo_labels, homography_adaptation_batch,
                                        image_generator)
from yolopoint_tpu_torch.models import build_model, reference_to_state_dict
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "artifacts" / "synth_r5_pseudo_ext" / "best"
PARAMS = chip_smoke.EXPORT_HOMOGRAPHIC
SCORE_RTOL = 2.0 ** -19
KW = dict(conf_thresh=0.015, nms_radius=4, top_k=1000, hom_params=PARAMS, erosion_radius=3)


@pytest.fixture(scope="module")
def models():
    loaded = jax_load_weights(RUN)
    meta, variables = loaded["meta"], loaded["variables"]
    nc = len(meta["names"])
    model = build_model("YOLOPoint", meta["version"], nc=nc, device="cpu")
    model.load_state_dict(reference_to_state_dict(variables_to_torch_state_dict(variables)))
    return jax_build_model("YOLOPoint", meta["version"], nc=nc), variables, model


def _image(seed, H, W):
    """Flat grey rectangles on a grey background, as float in [0, 1], 3 channels."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 0.2, np.float32)
    for _ in range(8):
        y0, x0 = rng.integers(0, H - H // 4, 2)
        h, w = rng.integers(H // 8, H // 3, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1)
    return np.repeat(img[..., None], 3, axis=2)


def _jax_homographies(seed, i, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
    draws = np.asarray(jax_sample_homography_batch(key, n - 1, **PARAMS))
    return key, np.concatenate([np.eye(3, dtype=np.float32)[None], draws])


def _jax_aggregate(jmodel, variables, image, homs):
    """The JAX function's aggregate, step for step."""
    N, (H, W) = homs.shape[0], image.shape[:2]
    Hs = jnp.asarray(homs)
    inv = jnp.linalg.inv(Hs)
    imgs = jax_warp_image(jnp.broadcast_to(jnp.asarray(image), (N, H, W, 3)), Hs)
    masks = jax_compute_valid_mask((H, W), Hs, erosion_radius=3)
    heat = jax_cells_to_heatmap(jmodel.apply(variables, imgs, train=False)["semi"]) * masks
    back = jax_warp_image(heat[..., None], inv)[..., 0].sum(0)
    return np.array(back / jnp.maximum(jax_warp_image(masks[..., None], inv)[..., 0].sum(0),
                                         1e-6))


def _same_keypoints(pts, scores, valid, want_pts, want_scores, want_valid, atol=5e-6):
    got = {tuple(p): s for p, s in zip(np.asarray(pts)[valid], np.asarray(scores)[valid])}
    want = {tuple(p): s for p, s in zip(np.asarray(want_pts)[want_valid],
                                        np.asarray(want_scores)[want_valid])}
    assert got.keys() == want.keys() and len(got) > 0
    for p, s in want.items():
        assert abs(got[p] - s) <= SCORE_RTOL * abs(s) + atol, p


@pytest.mark.parametrize("size,n", [(64, 4), (128, 8)])
def test_adaptation_matches_jax(models, size, n):
    jmodel, variables, model = models
    image = _image(size + n, size, size)
    key, homs = _jax_homographies(7, 0, n)
    want = jax_homography_adaptation_batch(jmodel, variables, jnp.asarray(image), key,
                                           num_homographies=n, **KW)
    pts, scores, valid = homography_adaptation_batch(
        model, torch.from_numpy(image), homographies=torch.from_numpy(homs), **KW)
    _same_keypoints(pts.numpy(), scores.numpy(), valid.numpy(), *map(np.asarray, want))

    agg_jax = _jax_aggregate(jmodel, variables, image, homs)
    with torch.inference_mode():
        agg = aggregate_heatmap(model, torch.from_numpy(image), torch.from_numpy(homs), 3)
    np.testing.assert_allclose(agg.numpy(), agg_jax, rtol=0, atol=5e-6)
    decoded = extract_keypoints(torch.from_numpy(agg_jax)[None], 0.015, 4, 1000)
    _same_keypoints(*(t[0].numpy() for t in decoded), *map(np.asarray, want), atol=0.0)


def test_export_files_match_jax(models, tmp_path):
    jmodel, variables, model = models
    seed, n, size = 3, 4, 96
    images = {f"img_{i}": _image(100 + i, size, size) for i in range(3)}
    jax_export_pseudo_labels(jmodel, variables, images, tmp_path / "jax", seed=seed,
                             host_warp=False, num_homographies=n, **KW)
    homs = [_jax_homographies(seed, i, n)[1] for i in range(len(images))]
    paths = export_pseudo_labels(model, images, tmp_path / "port", seed=seed, homographies=homs,
                                 num_homographies=n, **KW)
    assert sorted(p.name for p in paths) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for p in paths:
        got, want = np.load(p)["pts"], np.load(tmp_path / "jax" / p.name)["pts"]
        assert got.shape[1] == want.shape[1] == 3 and got.dtype == want.dtype
        _same_keypoints(got[:, :2], got[:, 2], np.ones(len(got), bool),
                        want[:, :2], want[:, 2], np.ones(len(want), bool))


def test_each_image_has_its_own_generator():
    def draws(seed, i):
        return draw_homographies(image_generator(seed, i, "cpu"), 5, PARAMS)

    a = draws(0, 1)
    assert torch.equal(a, draws(0, 1))
    assert torch.equal(a[0], torch.eye(3))
    for other in (draws(0, 2), draws(1, 1), draws(1, 0)):
        assert not torch.equal(a[1:], other[1:])
