"""The host-warp training views against the JAX package, on the CPU:

* `host_warp_views` (numpy form) gives the JAX function's payload bit for
  bit from the same `np.random.Generator`, in plain, crop, mosaic and
  crop + mosaic mode, with flips, with `homographic.enable` false and under
  the s640 val augmentation; `one_image` also for a mosaic canvas without
  a crop (the valid-source branch);
* the loaders' host-warp streams: the port's `DataLoader` with a
  `host_augment_config` yields the JAX loader's payloads over two shuffled
  epochs, the same payload every epoch of an unshuffled loader, and
  `sample_batch`'s;
* a crop corner past the frame's last window is clamped into it, as the
  device path clamps it (the JAX host path fails there);
* `build_training_views(precomputed=...)` on the JAX payload, with the JAX
  package's own draws replayed (`tests/torch_replay.py`), against the JAX
  function, at `tests/test_torch_augment.py`'s tolerances (images 2e-5;
  labels, masks equal; points and boxes 1e-4 px).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_augment import AUG, KITTI_AUG, as_torch, assert_views_equal, batch
from tests.test_torch_loader import NAMES, cfg
from tests.torch_replay import training_view_draws
from yolopoint_tpu.data import augmentation as jaug
from yolopoint_tpu.data import native as jnative
from yolopoint_tpu.data import loader as jax_loader
from yolopoint_tpu.data.host_augment import _one_image as jax_one_image
from yolopoint_tpu.data.host_augment import host_warp_views as jax_host_warp_views
from yolopoint_tpu.data.synthetic import SyntheticShapes as JaxShapes
from yolopoint_tpu_torch.data import augmentation as taug
from yolopoint_tpu_torch.data import host_augment, loader
from yolopoint_tpu_torch.data.native import NUMPY_WARP
from yolopoint_tpu_torch.data.synthetic import SyntheticShapes
from yolopoint_tpu_torch.training.step import precomputed_views
from yolopoint_tpu_torch.utils.config import load_config

torch.set_num_threads(1)

S640 = load_config("configs/synthetic_s640.yaml")["data"]
NO_HOMOGRAPHY = copy.deepcopy(AUG)
NO_HOMOGRAPHY["homographic"].update(enable=False,
                                    flipping={"horizontal": 0.5, "vertical": 0.5})
MODES = {  # name: (config, frame (H, W), crop key)
    "plain": (AUG, (64, 96), None),
    "flips_no_homography": (NO_HOMOGRAPHY, (64, 96), None),
    "val": (S640["val_augmentation"], (64, 96), None),
    "crop": (KITTI_AUG, (64, 96), "crop_yx"),
    "mosaic": (AUG, (96, 128), "mosaic_crop_yx"),
    "crop_mosaic": (KITTI_AUG, (96, 128), "mosaic_crop_yx"),
}


def mode_batch(mode, B=3, seed=0):
    config, (H, W), key = MODES[mode]
    b = batch(B=B, H=H, W=W, seed=seed)
    if key == "crop_yx":
        hc, wc = config["homographic"]["cropHW"]
        rng = np.random.default_rng(seed + 1)
        b[key] = np.stack([rng.integers(0, H - hc + 1, B), rng.integers(0, W - wc + 1, B)],
                          -1).astype(np.float32)
    elif key == "mosaic_crop_yx":
        b[key] = np.array([[H // 4, W // 4]] * B, np.float32)
    return config, b


def same_payload(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", sorted(MODES))
def test_payload_is_bit_equal(mode):
    assert jnative.available()  # the reference warps with the JAX native library
    config, b = mode_batch(mode)
    for seed in range(3):
        want = jax_host_warp_views(b, config, np.random.default_rng(seed))
        got = host_augment.host_warp_views(b, config, np.random.default_rng(seed), device="cpu")
        same_payload(got, want)
        assert got["image"].shape == (*b["image"].shape[:3], 0)
        assert got["precomputed_valid_base"].sum() > 0


def test_mosaic_canvas_without_crop_is_bit_equal():
    img = np.random.default_rng(3).uniform(0, 1, (64, 96, 3)).astype(np.float32)
    canvas = host_augment._mosaic_canvas_np((64, 96))
    for seed in range(3):
        want = jax_one_image(img, AUG, seed, None, None, canvas)
        got = host_augment.one_image(NUMPY_WARP, img, AUG, seed, None, None, canvas)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def host_loader(cls, module, shuffle, **kw):
    ds = [cls(cfg(4, 8), "train", NAMES)]
    return module.DataLoader(ds, 2, shuffle=shuffle, seed=5, host_augment_config=AUG, **kw)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "unshuffled"])
def test_loader_streams_equal_jax(shuffle):
    ours = host_loader(SyntheticShapes, loader, shuffle, device="cpu")
    theirs = host_loader(JaxShapes, jax_loader, shuffle)
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            g.pop("names"), w.pop("names")
            same_payload(g, w)
        epochs.append(got)
    first, second = epochs
    assert np.array_equal(first[0]["precomputed_h1"], second[0]["precomputed_h1"]) != shuffle
    g, w = ours.sample_batch(), theirs.sample_batch()
    g.pop("names"), w.pop("names")
    same_payload(g, w)


@pytest.mark.parametrize("mode", ["plain", "crop", "crop_mosaic"])
def test_build_training_views_precomputed_matches_jax(mode):
    config, b = mode_batch(mode, B=2, seed=4)
    payload = jax_host_warp_views(b, config, np.random.default_rng(9))
    crop_key = MODES[mode][2]
    mosaic = crop_key == "mosaic_crop_yx"
    pre = precomputed_views(payload)
    key = jax.random.PRNGKey(17)
    crop = None if crop_key is None else payload[crop_key]
    ref_base, ref_warp = jax.jit(lambda k, i, p, pm, bx, bm, c, pr: jaug.build_training_views(
        k, i, p, pm, bx, bm, config, crop_yx=c, mosaic=mosaic, precomputed=pr))(
        key, payload["image"], b["points"], b["point_mask"], b["boxes"], b["box_mask"], crop,
        pre)
    shape = (*payload["image"].shape[:3], 3)
    draws = training_view_draws(key, shape, config, crop=crop_key is not None, mosaic=mosaic,
                                precomputed=True)
    t = as_torch(dict(b, image=payload["image"]))
    base, warped = taug.build_training_views(
        t["image"], t["points"], t["point_mask"], t["boxes"], t["box_mask"], config, draws,
        crop_yx=None if crop is None else torch.from_numpy(crop), mosaic=mosaic,
        precomputed={k: torch.from_numpy(v) for k, v in pre.items()})
    hw = pre["image_base"].shape[1:3]
    assert base.image.shape[1:3] == warped.image.shape[1:3] == hw
    assert_views_equal(base, ref_base, hw, image_atol=2e-5)
    assert_views_equal(warped, ref_warp, hw, image_atol=2e-5)
    assert warped.valid_mask.sum() > 0 and base.labels_2d.sum() > 0


def test_crop_window_clamped_as_the_device_path():
    """A crop corner past `(Hf - hc, Wf - wc)` (a dataset mix's KITTI corner
    in a batch whose config sets no `cropHW`, so that the crop is the whole
    frame) crops the window clamped into the frame, as the device path's
    `_crop_images` does; the JAX host path fails there. Under identity
    homographies the views are the clamped windows of the frame."""
    identity = {"homographic": {"enable": False, "cropHW": [40, 64]},
                "warped_pair": {"params": {"perspective": False, "scaling": False,
                                           "rotation": False, "translation": False,
                                           "patch_ratio": 1.0}}}
    for aug, corner, hw in ((identity, (30, 40), (40, 64)),
                            ({k: v for k, v in identity.items() if k != "homographic"},
                             (7, 9), (64, 96))):
        b = batch(B=2, H=64, W=96, seed=5)
        b["crop_yx"] = np.array([corner, (0, 0)], np.float32)
        got = host_augment.host_warp_views(b, aug, np.random.default_rng(0), device="cpu")
        want = taug._crop_images(torch.from_numpy(b["image"]), torch.from_numpy(b["crop_yx"]),
                                 hw).numpy()
        assert got["precomputed_image_base"].shape == (2, *hw, 3)
        np.testing.assert_array_equal(got["precomputed_h1"], np.broadcast_to(np.eye(3), (2, 3, 3)))
        np.testing.assert_array_equal(got["precomputed_h2"], np.broadcast_to(np.eye(3), (2, 3, 3)))
        np.testing.assert_array_equal(got["precomputed_image_base"], want)
        np.testing.assert_array_equal(got["precomputed_image_pair"], want)
