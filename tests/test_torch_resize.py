"""The port's resize (`yolopoint_tpu_torch.ops.resize`, no OpenCV) against
`cv2.resize` as the JAX package calls it (`INTER_LINEAR` enlarging,
`INTER_AREA` shrinking), and the port's `preprocess_frame` against the JAX
package's.

Tolerances, as measured on this host with OpenCV 5.0:
  uint8 INTER_LINEAR  equal (OpenCV's fixed-point arithmetic reproduced);
  uint8 INTER_AREA    equal at integer ratios; at non-integer ratios at
                      most 1 level, on at most 1% of the values (OpenCV
                      accumulates in f32 in its own order: measured 0.02%
                      at 480x640 -> 160x213, 0.8% at 100x100 -> 99x100);
  f32                 within 2e-7 of OpenCV's own code (its IPP backend
                      off; measured 1.2e-7, one ulp near 1) and within 2e-5
                      of its default build, where IPP computes
                      INTER_LINEAR in another order (measured up to 1.4e-5);
  preprocess_frame    within 2e-5 of the JAX package's (f32 images).
"""

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.frontend.pipeline import preprocess_frame as jax_preprocess_frame
from yolopoint_tpu_torch.frontend.pipeline import preprocess_frame
from yolopoint_tpu_torch.ops.resize import INTER_AREA, INTER_LINEAR, resize

torch.set_num_threads(1)

# (H, W) -> (h, w): enlarging at integer and non-integer ratios, shrinking
# at integer (the fast block mean) and non-integer ratios, one axis kept
SIZES = [
    ((256, 320), (512, 640)),
    ((240, 320), (480, 640)),
    ((100, 130), (137, 171)),
    ((37, 53), (100, 61)),
    ((720, 1280), (360, 640)),
    ((90, 90), (30, 30)),
    ((480, 640), (160, 213)),
    ((97, 131), (33, 44)),
    ((100, 100), (99, 100)),
]


@pytest.fixture
def no_ipp():
    """OpenCV's own resize code (its IPP backend off) for one test."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


def _image(rng, H, W, C, dtype):
    img = rng.integers(0, 256, (H, W, C)).astype(np.uint8)
    return img if dtype == np.uint8 else (img / 255.0).astype(np.float32)


def _pair(img, h, w):
    H, W = img.shape[:2]
    shrink = h < H or w < W
    want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA if shrink else cv2.INTER_LINEAR)
    got = resize(torch.from_numpy(img), (w, h), INTER_AREA if shrink else INTER_LINEAR).numpy()
    return got, want.reshape(got.shape), shrink


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{a}-{b}" for a, b in SIZES])
def test_uint8_matches_cv2(src, dst, channels, no_ipp):
    rng = np.random.default_rng(sum(src) + sum(dst) + channels)
    got, want, shrink = _pair(_image(rng, *src, channels, np.uint8), *dst)
    assert got.dtype == np.uint8 and got.shape == dst + (channels,)
    diff = np.abs(got.astype(int) - want.astype(int))
    H, W = src
    integer_ratio = H % dst[0] == 0 and W % dst[1] == 0
    if not shrink or integer_ratio:
        assert diff.max() == 0
    else:
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("ipp", [False, True], ids=["opencv", "opencv_ipp"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", SIZES, ids=[f"{a}-{b}" for a, b in SIZES])
def test_float32_matches_cv2(src, dst, channels, ipp):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(ipp)
    try:
        rng = np.random.default_rng(sum(src) + sum(dst) + channels)
        got, want, _ = _pair(_image(rng, *src, channels, np.float32), *dst)
    finally:
        cv2.ipp.setUseIPP(was)
    assert got.dtype == np.float32 and got.shape == dst + (channels,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if ipp else 2e-7)


def test_same_size_is_a_copy_and_2d_keeps_its_layout():
    img = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    out = resize(img, (4, 3), INTER_LINEAR)
    assert torch.equal(out, img) and out.data_ptr() != img.data_ptr()
    grey = np.random.default_rng(0).random((40, 60), dtype=np.float32)
    got = resize(torch.from_numpy(grey), (90, 60), INTER_LINEAR).numpy()
    assert got.shape == (60, 90)
    np.testing.assert_allclose(got, cv2.resize(grey, (90, 60), interpolation=cv2.INTER_LINEAR),
                               rtol=0, atol=2e-5)


def test_rejects_what_it_does_not_reproduce():
    with pytest.raises(TypeError):
        resize(torch.zeros(4, 4, dtype=torch.float64), (2, 2), INTER_AREA)
    with pytest.raises(NotImplementedError):  # OpenCV's INTER_AREA enlarging an axis
        resize(torch.zeros(4, 4), (8, 2), INTER_AREA)
    with pytest.raises(ValueError):
        resize(torch.zeros(4, 4), (2, 2), "cubic")


@pytest.mark.parametrize("shape,img_size", [
    ((720, 1280, 3), 640),  # the demo operating point: INTER_AREA at ratio 0.5
    ((480, 640, 3), 1280),  # INTER_LINEAR at ratio 2
    ((300, 500, 3), 640),   # INTER_LINEAR at 1.28
    ((300, 500, 1), 256),   # INTER_AREA at 0.512, one channel
    ((97, 131, 3), 64),
    ((200, 200, 3), None),  # no resize, only the stride crop
])
def test_preprocess_frame_matches_jax(shape, img_size):
    img = np.random.default_rng(shape[0] + shape[1]).integers(0, 256, shape).astype(np.uint8)
    got, (top, left), ratio = preprocess_frame(img, img_size)
    want, (wtop, wleft), wratio = jax_preprocess_frame(img, img_size)
    assert (top, left, ratio) == (wtop, wleft, wratio)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
