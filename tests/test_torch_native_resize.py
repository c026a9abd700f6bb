"""The datasets' resize of the port (`yolopoint_tpu_torch/data/native.py`)
and its `letterbox` against the JAX package's, which run the C++ library
`native/preprocess.cc` (built with `-O3 -march=native`): bit for bit. Each
test first asserts `native.available()`, so that the reference is that
library and not the JAX package's `cv2` fallback."""

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.data import datasets as jds
from yolopoint_tpu.data import native as jnative
from yolopoint_tpu_torch.data import datasets as tds
from yolopoint_tpu_torch.data import native as tnative

torch.set_num_threads(1)

# (source, destination): KITTI at the export and training resize (area),
# the fixtures up to 960 (bilinear), COCO's letterbox shrinks, odd sizes
RESIZES = [((375, 1242), (290, 960)), ((96, 320), (288, 960)), ((480, 640), (320, 426)),
           ((640, 640), (320, 320)), ((375, 1242), (500, 1656)), ((112, 352), (305, 960)),
           ((120, 100), (64, 53)), ((13, 17), (5, 7)), ((13, 17), (29, 31)), ((50, 50), (50, 50))]


def image(seed: int, h: int, w: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, c)).astype(np.uint8), (5, 5), 1.5)
    return img.reshape(h, w, c)


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                                                   for s, d in RESIZES])
def test_resize_u8_equals_the_native_library(src, dst):
    assert jnative.available()
    for c in (3, 1):
        img = image(src[0] + c, *src, c)
        for mode in ("auto", "area", "bilinear"):
            want = jnative.resize_u8(img, *dst, mode)
            got = tnative.resize_u8(img, *dst, mode)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} C={c}")


def test_u8_to_f32_equals_the_native_library():
    assert jnative.available()
    img = image(0, 7, 9, 3)
    np.testing.assert_array_equal(tnative.u8_to_f32(img), jnative.u8_to_f32(img))


@pytest.mark.parametrize("shape,new", [((96, 128), 64), ((120, 100), 64), ((80, 144), 96),
                                       ((375, 1242), 640), ((64, 64), 64), ((50, 70), (48, 96))])
def test_letterbox_equals_jax(shape, new):
    assert jnative.available()
    img = image(shape[0], *shape, 3)
    want = jds.letterbox(img, new)
    got = tds.letterbox(img, new, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[2] == want[2]
