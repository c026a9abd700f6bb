"""The port's OpenCV warps (`data/cv_warp.py`) against `cv2` 5.0 itself.

* `warp_perspective_u8` equals `cv2.warpPerspective(..., INTER_LINEAR)`
  (border constant 0) byte for byte over a seeded sweep of homographies:
  zoom-outs and zoom-ins, rotations of any angle, perspective, translations
  that put the source's border inside the frame, odd sizes (the scalar tail
  of OpenCV's 16-pixel vector loop), 1, 3 and 4 channels;
* `warp_affine_u8` equals `cv2.warpAffine(..., WARP_INVERSE_MAP,
  BORDER_REFLECT)` (nearest) likewise, with maps reaching past both edges
  several times and coordinates on exact halves (ties);
* the compiled twins (`ops/csrc/host_image.cpp`, built here with g++) equal
  the numpy versions.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu_torch.data import cv_warp
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
SOURCES = [((480, 640), (240, 320)), ((37, 53), (23, 37)), ((101, 77), (57, 101)),
           ((9, 5), (31, 17)), ((2, 3), (16, 21)), ((1, 1), (5, 7)), ((256, 320), (240, 321))]


def sweep(seed: int, n: int):
    """`n` cases of (src, 3x3 map, (W, H)) drawn from `seed`."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        (sh, sw), (H, W) = SOURCES[k % len(SOURCES)]
        C = (3, 1, 4)[k % 3]
        src = rng.integers(0, 256, (sh, sw, C), np.uint8)
        ang = rng.uniform(-np.pi, np.pi)
        s = rng.uniform(0.3, 3.0)  # below 1: a zoom-out of the source
        M = np.array([[s * np.cos(ang), -s * np.sin(ang), rng.uniform(-2 * sw, 2 * sw)],
                      [s * np.sin(ang), s * np.cos(ang), rng.uniform(-2 * sh, 2 * sh)],
                      [rng.normal(0, 1e-3), rng.normal(0, 1e-3), 1.0]])
        if k % 4 == 0:
            M[:2] = np.round(M[:2] * 4) / 4  # coordinates on exact quarters and halves
        yield (src[..., 0] if C == 1 else src), M, (W, H)


@pytest.mark.parametrize("seed", range(4))
def test_warp_perspective_equals_cv2(seed):
    for src, M, dsize in sweep(seed, 21):
        want = cv2.warpPerspective(src, M, dsize, flags=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(cv_warp.warp_perspective_u8(src, M, dsize), want,
                                      err_msg=f"{src.shape} -> {dsize}\n{M}")


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_equals_cv2(seed):
    for src, M, dsize in sweep(seed + 10, 21):
        A = M[:2].astype(np.float32 if seed % 2 else np.float64)
        want = cv2.warpAffine(src, A, dsize, flags=cv2.WARP_INVERSE_MAP,
                              borderMode=cv2.BORDER_REFLECT)
        np.testing.assert_array_equal(cv_warp.warp_affine_u8(src, A, dsize), want,
                                      err_msg=f"{src.shape} -> {dsize}\n{A}")


def test_the_sequence_tool_path_equals_cv2():
    """The camera maps of `tools/make_synthetic_sequence.py` on a 2x canvas."""
    from yolopoint_tpu_torch.tools.synthetic_sequence import camera

    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, (512, 640), np.uint8)
    ph = rng.uniform(0, 2 * np.pi, 4)
    for i in range(0, 48, 5):
        A = camera(i, 48, 256, 320, ph)
        want = cv2.warpAffine(big, A, (320, 256), flags=cv2.WARP_INVERSE_MAP,
                              borderMode=cv2.BORDER_REFLECT)
        np.testing.assert_array_equal(cv_warp.warp_affine_u8(big, A, (320, 256)), want)


def test_singular_perspective_raises():
    with pytest.raises(ValueError, match="singular"):
        cv_warp.warp_perspective_u8(np.zeros((4, 4, 3), np.uint8), np.zeros((3, 3)), (4, 4))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled warps are checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    for name in ("yp_cv_warp_perspective_u8", "yp_cv_warp_affine_u8"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("kind", ["perspective", "affine"])
def test_compiled_warps_equal_numpy(host_lib, kind):
    for src, M, dsize in sweep(20, 21):
        arg = M if kind == "perspective" else M[:2]
        got = getattr(cv_warp, f"warp_{kind}_u8_compiled")(src, arg, dsize, lib=host_lib)
        np.testing.assert_array_equal(got, getattr(cv_warp, f"warp_{kind}_u8")(src, arg, dsize))


def test_cv_warp_for_picks_numpy_on_the_cpu_only():
    assert cv_warp.cv_warp_for("cpu") is cv_warp.NUMPY_CV_WARP
    assert cv_warp.cv_warp_for("cuda") is cv_warp.COMPILED_CV_WARP
