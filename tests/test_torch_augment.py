"""The port's photometric and homographic augmentation against the JAX
package, on the CPU, with the JAX package's own random draws replayed
(`tests/torch_replay.py`) into the port's apply functions.

Tolerances: images within 1e-5 (photometric ops, `homographic_augment`) and
2e-5 (`build_training_views`); label maps, valid masks, point and box masks
equal; warped points and boxes within 1e-4 px. The 2e-5: the warped pair's
source coordinates are rounded in another order than XLA's fused (FMA)
arithmetic, and one f32 ulp of a coordinate (7.6e-6 px at 64-127 px) across
a full-range u8 edge moves a bilinear sample by as much; the JAX package's
own jitted and eager runs of the same views differ by 7.5e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_replay import photometric_draws, training_view_draws
from yolopoint_tpu.data import augmentation as jaug
from yolopoint_tpu.data import photometric as jphot
from yolopoint_tpu.ops.homography import sample_homography_batch as jax_sample
from yolopoint_tpu_torch.data import augmentation as taug
from yolopoint_tpu_torch.data import photometric as tphot

torch.set_num_threads(1)

S640_PHOTOMETRIC = {  # configs/synthetic_s640.yaml, data.augmentation.photometric.params
    "random_brightness": {"max_abs_change": 50},
    "random_contrast": {"strength_range": [0.5, 1.5]},
    "additive_gaussian_noise": {"stddev_range": [0, 10]},
    "additive_speckle_noise": {"prob_range": [0, 0.0035]},
    "motion_blur": {"max_kernel_size": 3},
    "GaussianBlur": {"sigma": 0.2},
}
OPS = {
    **{k: {k: v} for k, v in S640_PHOTOMETRIC.items()},
    "speckle_dense": {"additive_speckle_noise": {"prob_range": [0.05, 0.2]}},
    "motion_blur_5": {"motion_blur": {"max_kernel_size": 5}},
    "GaussianBlur_wide": {"GaussianBlur": {"sigma": 1.5}},
    "add_elementwise": {"add_elementwise": {"value": [-10, 10]}},
    "add": {"add": {"value": [-20, 20]}},
    "channel_shuffle": {"channel_shuffle": 0.5},
    "hsv": {"hsv": [0.1, 0.5, 0.4]},
    "additive_shade": {"additive_shade": {"nb_ellipses": 8, "transparency_range": [-0.5, 0.8]}},
    "s640_full": S640_PHOTOMETRIC,
}
AUG = {  # configs/synthetic_s640.yaml, data.augmentation (photometric, homographic, warped_pair)
    "photometric": {"enable": True, "params": S640_PHOTOMETRIC,
                    "params_light": {"random_brightness": {"max_abs_change": 20},
                                     "random_contrast": {"strength_range": [0.7, 1.3]}}},
    "homographic": {"enable": True, "valid_border_margin": 3,
                    "params": {"perspective": True, "scaling": True, "rotation": True,
                               "translation": True, "patch_ratio": 0.85,
                               "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
                               "scaling_amplitude": 0.2, "max_angle": 1.57}},
    "warped_pair": {"valid_border_margin": 3,
                    "params": {"perspective": True, "scaling": True, "rotation": True,
                               "translation": True, "patch_ratio": 0.85}},
}


def batch(B=2, H=64, W=96, N=48, M=6, seed=0, u8=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8) if u8 else \
        rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    boxes = np.concatenate([rng.integers(0, 5, (B, M, 1)), rng.uniform(0.3, 0.7, (B, M, 2)),
                            rng.uniform(0.15, 0.45, (B, M, 2))], -1).astype(np.float32)
    return {"image": img,
            "points": rng.uniform(0, min(H, W) - 1, (B, N, 2)).astype(np.float32),
            "point_mask": rng.uniform(size=(B, N)) < 0.9,
            "boxes": boxes, "box_mask": rng.uniform(size=(B, M)) < 0.9}


def as_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("op", sorted(OPS))
def test_photometric_op_matches_jax(op):
    params = OPS[op]
    img = batch(u8=False)["image"]
    key = jax.random.PRNGKey(sorted(OPS).index(op))
    ref = np.asarray(jax.jit(lambda k, x: jphot.photometric_augment(k, x, params))(key, img))
    draws = photometric_draws(key, img.shape, params)
    got = tphot.photometric_augment(torch.from_numpy(img), params, draws).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_photometric_blurs_with_support_mask_match_jax():
    params = {"motion_blur": {"max_kernel_size": 3}, "GaussianBlur": {"sigma": 1.0}}
    img = batch(u8=False)["image"]
    support = np.zeros(img.shape[:3], np.float32)
    support[:, 5:50, 10:80] = 1.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jphot.photometric_augment(key, img, params, jnp.asarray(support)))
    got = tphot.photometric_augment(torch.from_numpy(img), params,
                                    photometric_draws(key, img.shape, params),
                                    torch.from_numpy(support)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def assert_views_equal(got, ref, hw, image_atol=1e-5):
    H, W = hw
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image), atol=image_atol, rtol=0)
    np.testing.assert_array_equal(got.labels_2d.numpy(), np.asarray(ref.labels_2d))
    np.testing.assert_array_equal(got.valid_mask.numpy(), np.asarray(ref.valid_mask))
    np.testing.assert_array_equal(got.point_mask.numpy(), np.asarray(ref.point_mask))
    np.testing.assert_array_equal(got.box_mask.numpy(), np.asarray(ref.box_mask))
    pm = np.asarray(ref.point_mask)
    np.testing.assert_allclose(got.points.numpy()[pm], np.asarray(ref.points)[pm], atol=1e-4)
    scale = np.array([1.0, W, H, W, H], np.float32)
    bm = np.asarray(ref.box_mask)
    np.testing.assert_allclose((got.boxes.numpy() * scale)[bm], (np.asarray(ref.boxes) * scale)[bm],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.homography.numpy(), np.asarray(ref.homography), atol=1e-6)
    np.testing.assert_allclose(got.inv_homography.numpy(), np.asarray(ref.inv_homography),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("crop", [False, True])
def test_homographic_augment_matches_jax(crop):
    b = batch(u8=False, seed=1)
    hom = jax_sample(jax.random.PRNGKey(3), 2, **AUG["homographic"]["params"])
    crop_yx = np.array([[8, 12], [0, 30]], np.int32) if crop else None
    crop_hw = (48, 64) if crop else None

    def jfn(h, img, pts, pm, bx, bm, cyx):
        return jaug.homographic_augment(None, img, pts, pm, bx, bm, homography=h,
                                        valid_border_margin=3, crop_yx=cyx, crop_hw=crop_hw)

    ref = jax.jit(jfn)(hom, b["image"], b["points"], b["point_mask"], b["boxes"], b["box_mask"],
                       crop_yx)
    t = as_torch(b)
    got = taug.homographic_augment(t["image"], t["points"], t["point_mask"], t["boxes"],
                                   t["box_mask"], torch.from_numpy(np.asarray(hom)),
                                   valid_border_margin=3,
                                   crop_yx=None if crop_yx is None else torch.from_numpy(crop_yx),
                                   crop_hw=crop_hw)
    assert_views_equal(got, ref, crop_hw or (64, 96))


@pytest.mark.parametrize("variant", ["s640", "flip_no_light"])
def test_build_training_views_matches_jax(variant):
    config = copy.deepcopy(AUG)
    if variant == "flip_no_light":
        config["photometric"].pop("params_light")
        config["homographic"]["flipping"] = {"horizontal": 0.5, "vertical": 0.5}
        config["warped_pair"]["photometric"] = {"params": {"random_brightness":
                                                           {"max_abs_change": 30}}}
    b = batch(seed=2)
    key = jax.random.PRNGKey(11)
    ref_base, ref_warp = jax.jit(lambda k, i, p, pm, bx, bm: jaug.build_training_views(
        k, i, p, pm, bx, bm, config))(key, b["image"], b["points"], b["point_mask"],
                                      b["boxes"], b["box_mask"])
    draws = training_view_draws(key, b["image"].shape, config)
    t = as_torch(b)
    base, warped = taug.build_training_views(t["image"], t["points"], t["point_mask"],
                                             t["boxes"], t["box_mask"], config, draws)
    assert_views_equal(base, ref_base, (64, 96), image_atol=2e-5)
    assert_views_equal(warped, ref_warp, (64, 96), image_atol=2e-5)
    assert warped.valid_mask.sum() > 0 and base.labels_2d.sum() > 0


# configs/kitti.yaml's crop chain, cut to the test's frame: the crop, the
# flips and the gentler mosaic warp; the mosaic batch is a (2h, 2w) canvas
KITTI_AUG = copy.deepcopy(AUG)
KITTI_AUG["homographic"].update({
    "cropHW": [48, 64], "flipping": {"horizontal": 0.5},
    "mosaic": {"params": {"perspective": True, "scaling": True, "rotation": True,
                          "translation": True, "patch_ratio": 0.85, "max_angle": 0.3}}})


@pytest.mark.parametrize("mode", ["crop", "mosaic", "mosaic_pair_params", "mosaic_no_homography"])
def test_build_training_views_crop_and_mosaic_match_jax(mode):
    """The crop chain (`crop_yx`) and the mosaic path (canvas tile mask,
    the mosaic's homography parameters, the centre crop) against JAX."""
    config = copy.deepcopy(KITTI_AUG)
    mosaic = mode.startswith("mosaic")
    if mode == "mosaic_pair_params":
        config["warped_pair"]["mosaic_params"] = {"patch_ratio": 0.9, "max_angle": 0.2}
    if mode == "mosaic_no_homography":  # a mosaic still warps by H1
        config["homographic"]["enable"] = False
    H, W = (96, 128) if mosaic else (64, 96)
    b = batch(H=H, W=W, seed=4)
    crop_yx = np.array([[H // 4, W // 4]] * 2, np.float32) if mosaic else \
        np.array([[8, 12], [0, 30]], np.float32)
    key = jax.random.PRNGKey(23)
    ref_base, ref_warp = jax.jit(lambda k, i, p, pm, bx, bm, c: jaug.build_training_views(
        k, i, p, pm, bx, bm, config, crop_yx=c, mosaic=mosaic))(
        key, b["image"], b["points"], b["point_mask"], b["boxes"], b["box_mask"], crop_yx)
    draws = training_view_draws(key, b["image"].shape, config, crop=True, mosaic=mosaic)
    t = as_torch(b)
    base, warped = taug.build_training_views(t["image"], t["points"], t["point_mask"],
                                             t["boxes"], t["box_mask"], config, draws,
                                             crop_yx=torch.from_numpy(crop_yx), mosaic=mosaic)
    hw = (H // 2, W // 2) if mosaic else (48, 64)
    assert base.image.shape[1:3] == warped.image.shape[1:3] == hw
    assert_views_equal(base, ref_base, hw, image_atol=2e-5)
    assert_views_equal(warped, ref_warp, hw, image_atol=2e-5)
    assert warped.valid_mask.sum() > 0 and base.labels_2d.sum() > 0


def test_mosaic_canvas_mask_matches_jax():
    for hw in ((96, 128), (7, 9), (576, 1792)):
        np.testing.assert_array_equal(taug.mosaic_canvas_mask(hw).numpy(),
                                      np.asarray(jaug.mosaic_canvas_mask(hw)))


def test_unported_paths_raise():
    """The host-warp (`precomputed`) path is ported
    (`tests/test_torch_host_views.py`); a payload without its views raises."""
    t = as_torch(batch())
    args = (t["image"], t["points"], t["point_mask"], t["boxes"], t["box_mask"], AUG, {})
    with pytest.raises(KeyError, match="image_base"):
        taug.build_training_views(*args, precomputed={"h1": torch.eye(3)[None]})
