"""The host-warp path's pixel functions and homography sampler against the
JAX package, on the CPU:

* `warp_perspective_f32` (bilinear and nearest) and `warp_coverage_f32`,
  numpy and compiled (`ops/csrc/host_image.cpp` built here with g++ and the
  kernel build's host flags), bit for bit equal to the JAX package's
  functions of those names, the C++ of `native/libyp_preprocess.so` built
  with `-O3 -march=native` (whose FMAs both forms reproduce): homographies
  of `sample_homography_np` under the s640 parameters, border-heavy ones
  (artifacts allowed, 0.5 translation overflow, the inverses), C in
  {1, 2, 3, 17}, frames of the resize tests' sizes up to 640 px;
* `erode`, numpy and compiled, equal to `cv2.erode` with the ellipse
  kernels of radii 1-5 (the JAX package's `_erode` where `cv2` imports);
* `sample_homography_np`, equal in float64 over seeds and over every
  homography parameter set of `configs/`, the crop branch included.

Each comparison first asserts that the JAX package's native library is
loaded, so that the reference is the C++, not its numpy fallback.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from yolopoint_tpu.data import native as jnative
from yolopoint_tpu.data.host_augment import _erode as jax_erode
from yolopoint_tpu.ops.homography import perspective_transform_np as jax_perspective_transform
from yolopoint_tpu.ops.homography import sample_homography_np as jax_sample_np
from yolopoint_tpu_torch.data import native
from yolopoint_tpu_torch.ops.geometry import ellipse_kernel
from yolopoint_tpu_torch.ops.homography import sample_homography_np
from yolopoint_tpu_torch.utils.config import load_config

REPO = Path(__file__).resolve().parents[1]
S640 = load_config(REPO / "configs" / "synthetic_s640.yaml")["data"]["augmentation"]
SIZES = ((13, 17), (64, 96), (97, 131), (240, 320), (290, 960), (640, 640))  # the resize tests


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled twin is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-march=native",
                    "-shared", "-o", str(out), str(src)], check=True, capture_output=True,
                    timeout=120)
    return ctypes.CDLL(str(out))


def homographies(count: int):
    """s640 draws, border-heavy draws and inverses (normalized, float64)."""
    params = S640["homographic"]["params"]
    for seed in range(count):
        h = sample_homography_np((2.0, 2.0), shift=-1.0, seed=seed, **params)
        yield h
        yield sample_homography_np((2.0, 2.0), shift=-1.0, seed=seed, **dict(
            params, allow_artifacts=True, translation_overflow=0.5))
        yield np.linalg.inv(h)


def bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("channels", [1, 2, 3, 17])
def test_warp_is_bit_equal(host_lib, hw, channels):
    assert jnative.available()
    rng = np.random.default_rng(channels)
    img = rng.uniform(0, 1, (*hw, channels)).astype(np.float32)
    n = 1 if hw[0] * hw[1] > 100_000 else 3
    for i, h in enumerate(homographies(n)):
        for mode in ("bilinear", "nearest"):
            want = bits(jnative.warp_perspective_f32(img, h, mode))
            np.testing.assert_array_equal(bits(native.warp_perspective_f32(img, h, mode)), want,
                                          err_msg=f"numpy {mode} {i}")
            np.testing.assert_array_equal(
                bits(native.warp_perspective_f32_compiled(img, h, mode, lib=host_lib)), want,
                err_msg=f"compiled {mode} {i}")


def test_warp_of_a_2d_mask(host_lib):
    assert jnative.available()
    mask = (np.random.default_rng(2).uniform(size=(97, 131)) < 0.8).astype(np.float32)
    for h in homographies(2):
        want = jnative.warp_perspective_f32(mask, h, mode="nearest")
        assert want.shape == (97, 131)
        np.testing.assert_array_equal(native.warp_perspective_f32(mask, h, "nearest"), want)
        np.testing.assert_array_equal(
            native.warp_perspective_f32_compiled(mask, h, "nearest", lib=host_lib), want)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_coverage_is_bit_equal(host_lib, hw):
    assert jnative.available()
    for h in homographies(4):
        want = jnative.warp_coverage_f32(hw, h)
        assert want.sum() > 0
        np.testing.assert_array_equal(bits(native.warp_coverage_f32(hw, h)), bits(want))
        np.testing.assert_array_equal(
            bits(native.warp_coverage_f32_compiled(hw, h, lib=host_lib)), bits(want))


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_erode_equals_cv2(host_lib, radius):
    import cv2  # the reference: the JAX package's `_erode` calls `cv2.erode` where it imports

    rng = np.random.default_rng(radius)
    kernel = ellipse_kernel(radius)
    for hw in ((64, 96), (97, 131), (640, 640)):
        mask = (rng.uniform(size=hw) < 0.97).astype(np.float32)
        mask[:, : hw[1] // 3] = 1.0  # a run of ones up to the frame
        want = cv2.erode(mask.astype(np.uint8), kernel).astype(np.float32)
        np.testing.assert_array_equal(jax_erode(mask.copy(), radius), want)
        np.testing.assert_array_equal(native.erode(mask, kernel), want)
        np.testing.assert_array_equal(native.erode_compiled(mask, kernel, lib=host_lib), want)


def config_params():
    """Every homography parameter set of `configs/`: augmentation and val
    augmentation (homographic, its mosaic, the warped pair and its mosaic),
    and the export's."""
    found = {}
    for path in sorted((REPO / "configs").glob("*.yaml")):
        cfg = load_config(path)
        data = cfg.get("data") or {}
        for section in ("augmentation", "val_augmentation"):
            aug = data.get(section) or {}
            hom, pair = aug.get("homographic") or {}, aug.get("warped_pair") or {}
            for key, p in (("h1", hom.get("params")), ("mosaic", (hom.get("mosaic") or {})
                                                        .get("params")),
                           ("h2", pair.get("params")), ("h2_mosaic", pair.get("mosaic_params"))):
                if p:
                    found[f"{path.stem}.{section}.{key}"] = p
        if p := (cfg.get("export") or {}).get("homography"):
            found[f"{path.stem}.export"] = p
    return found


def test_sample_homography_np_equals_jax():
    params = config_params()
    assert len(params) > 20
    crop = {"W_crop": 192, "H_crop": 64, "tl": (17, 40), "HW_full": (256, 832)}
    for name, p in params.items():
        p = {k: v for k, v in p.items() if k != "cropHW"}
        for seed in range(8):
            want = jax_sample_np((2.0, 2.0), shift=-1.0, seed=seed, **p)
            got = sample_homography_np((2.0, 2.0), shift=-1.0, seed=seed, **p)
            assert got.dtype == np.float64 and np.array_equal(got, want), name
            want = jax_sample_np((2.0, 2.0), shift=-1.0, seed=seed, crop_pts=crop, **p)
            got = sample_homography_np((2.0, 2.0), shift=-1.0, seed=seed, crop_pts=crop, **p)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), name
    # the pixel-frame form of the reference (shape and shift 0)
    for seed in range(4):
        np.testing.assert_array_equal(sample_homography_np((240, 320), seed=seed),
                                      jax_sample_np((240, 320), seed=seed))


def test_sample_homography_np_without_a_valid_candidate():
    """With a config that sets no parameters (`patch_ratio` 1, the corners
    on the unit square's edge) a draw whose scales are all >= 1 leaves no
    valid candidate: the JAX numpy sampler raises; the port takes candidate
    0, as the device sampler (`_pick_valid`) does. That is scale 1, the unit
    square, which no translation moves and no rotation keeps inside, so
    the rotation's candidate 0 too: the first angle of the linspace, -pi/2.
    Every other draw is the JAX one."""
    square = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    a = -math.pi / 2
    rot = np.array([[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]])
    candidate_0 = jax_perspective_transform(square * 2 - 1, ((square - 0.5) @ rot + 0.5) * 2 - 1)
    raised = 0
    for seed in range(160):
        got = sample_homography_np((2.0, 2.0), shift=-1.0, seed=seed)
        try:
            want = jax_sample_np((2.0, 2.0), shift=-1.0, seed=seed)
        except ValueError:
            raised += 1
            want = candidate_0
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
    assert raised >= 1
