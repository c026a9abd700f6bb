"""The port's RANSAC homography (`yolopoint_tpu_torch/evaluation/homography_ransac.py`)
against `cv2.findHomography(src.astype(f32), dst.astype(f32), cv2.RANSAC)`,
the call the JAX package makes wherever OpenCV is installed:

* a seeded sweep of 50 problems (`chip_smoke.ransac_problem`, which the
  card's `ransac` phase runs too: n from 4 to 300, 0-90% outliers, 0.5-2 px
  of noise, and the cases n = 4, n = 5, collinear points, duplicate points,
  all outliers and integer coordinates): `None` exactly where cv2 finds no
  model, the same inlier mask on every problem, and the four corners of a
  320x256 image mapped through the two H within 1e-2 px (the
  Levenberg-Marquardt step is OpenCV 5's in its rules, not to the last bit);
* the compiled twin (`yp_find_homography` in `ops/csrc/host_image.cpp`,
  built here with g++) against the numpy version on the same sweep: the
  same masks and H within 1e-9 relative;
* the pieces the sweep leans on: `cv::RNG`'s draws and
  `RANSACUpdateNumIters`.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import RANSAC_PROBLEMS as N_PROBLEMS
from chip_smoke import ransac_problem as problem
from yolopoint_tpu_torch.evaluation import homography_ransac as hr
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CORNERS = np.array([[0, 0, 1], [319, 0, 1], [0, 255, 1], [319, 255, 1]], np.float64)


@functools.cache
def port(i: int):
    """The numpy version's answer to problem `i` (shared by the tests)."""
    return hr.find_homography_ransac(*problem(i))


def _corners(h):
    c = CORNERS @ np.asarray(h, np.float64).T
    return c[:, :2] / c[:, 2:]


@pytest.mark.parametrize("i", range(N_PROBLEMS))
def test_equal_to_cv2(i):
    src, dst = problem(i)
    want_h, want_mask = cv2.findHomography(src.astype(np.float32), dst.astype(np.float32),
                                           cv2.RANSAC)
    got_h, got_mask = port(i)
    assert got_mask.dtype == np.uint8
    np.testing.assert_array_equal(got_mask, want_mask.ravel())
    assert (got_h is None) == (want_h is None)
    if want_h is not None:
        np.testing.assert_allclose(_corners(got_h), _corners(want_h), rtol=0, atol=1e-2)


def test_sweep_covers_its_cases():
    """The sweep has problems without a model (collinear, duplicates), from
    4 to 300 pairs, and mostly outliers."""
    assert all(port(i)[0] is None for i in (4, 5))
    ns = [len(problem(i)[0]) for i in range(N_PROBLEMS)]
    assert min(ns) == 4 and max(ns) > 250
    shares = [port(i)[1].mean() for i in range(10, 20)]
    assert min(shares) < 0.3


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled RANSAC is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    lib.yp_find_homography.argtypes = _build._SIGNATURES["yp_find_homography"]
    lib.yp_find_homography.restype = ctypes.c_int
    return lib


def test_compiled_equals_numpy(host_lib):
    for i in range(N_PROBLEMS):
        src, dst = problem(i)
        want_h, want_mask = port(i)
        got_h, got_mask = hr.find_homography_ransac_compiled(src, dst, lib=host_lib)
        np.testing.assert_array_equal(got_mask, want_mask, err_msg=f"problem {i}")
        assert (got_h is None) == (want_h is None), i
        if want_h is not None:
            np.testing.assert_allclose(got_h, want_h, rtol=0,
                                       atol=1e-9 * np.abs(want_h).max(), err_msg=f"problem {i}")
    h, mask = hr.find_homography_ransac_compiled(np.zeros((3, 2)), np.zeros((3, 2)), lib=host_lib)
    assert h is None and mask.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        hr.find_homography_ransac_compiled(src, dst, confidence=1.0, lib=host_lib)


def test_draws_are_cv_rng_subsets():
    """`cv::RNG` from 2^64 - 1: its first output, and draws of four distinct
    indices."""
    rng = hr.CvRng()
    assert rng.next() == (0xFFFFFFFF * 4164903690 + 0xFFFFFFFF) & 0xFFFFFFFF
    draws = hr._draw(hr.CvRng(), 5, 200)
    assert draws.min() == 0 and draws.max() == 4
    assert all(len(set(d)) == 4 for d in draws.tolist())


def test_update_num_iters():
    assert hr.update_num_iters(0.995, 0.5, 4, 2000) == round(np.log(0.005) / np.log(1 - 0.5**4))
    assert hr.update_num_iters(0.995, 0.95, 4, 2000) == 2000  # beyond the cap
    assert hr.update_num_iters(0.995, 0.0, 4, 2000) == 0  # every point an inlier
    assert hr.update_num_iters(0.995, 0.3, 4, 10) == 10


def test_fewer_than_four_points_find_nothing():
    h, mask = hr.find_homography_ransac(np.zeros((3, 2)), np.ones((3, 2)))
    assert h is None and mask.tolist() == [0, 0, 0]


def test_find_homography_for_picks_numpy_on_the_cpu_only():
    assert hr.find_homography_for("cpu") is hr.find_homography_ransac
    assert hr.find_homography_for("cuda") is hr.find_homography_ransac_compiled
