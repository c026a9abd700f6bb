#!/usr/bin/env python3
"""Host-code times of the host-warp path's compiled functions, built under
several flag sets in one process, for the PyTorch port.

`yolopoint_tpu_torch/ops/csrc/host_image.cpp` is built by the host's C++
compiler (the one `nvcc` hands host code to) once per flag set of
`BUILDS`, loaded with ctypes, and at each input (the s640 frame, a KITTI
frame at 960 px, the KITTI mosaic canvas) each build's warp (bilinear C = 3
and 1, nearest C = 1), coverage and erosion are checked bit for bit against
the numpy twins of `yolopoint_tpu_torch/data/native.py` and timed: the
median ms of 7 calls, builds in order, then in reverse. Prints one JSON
line per input, then the host's core count and CPU model.

    python3 tools/bench_torch_host_warp.py

Builds:
  baseline  the kernel build's host flags without `-march=native`: libm
            calls for `std::fma` and `std::floor`, SSE2 code;
  native    the build's `HOST_FLAGS` (`-march=native`): the FMA and
            rounding instructions of the machine, vector loops.
"""

from __future__ import annotations

import ctypes
import json
import os
import platform
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# tools/profile.py would shadow the standard `profile` module of torch's imports
sys.path = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from yolopoint_tpu_torch.data import native  # noqa: E402
from yolopoint_tpu_torch.data.host_augment import NORM_SHAPE  # noqa: E402
from yolopoint_tpu_torch.ops.geometry import ellipse_kernel  # noqa: E402
from yolopoint_tpu_torch.ops.homography import sample_homography_np  # noqa: E402

SOURCE = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
COMMON = ("-std=c++17", "-O3", "-fPIC", "-shared", "-ffp-contract=off")
BUILDS = {"baseline": COMMON, "native": COMMON + ("-march=native",)}
INPUTS = {"s640": (640, 640, 3), "kitti_frame": (320, 960, 3), "mosaic_canvas": (576, 1792, 3)}
PARAMS = {"perspective": True, "scaling": True, "rotation": True, "translation": True,
          "patch_ratio": 0.85, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
          "scaling_amplitude": 0.2, "max_angle": 1.57}  # configs/synthetic_s640.yaml H1


def build(tmp: Path) -> dict:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler")
    libs = {}
    for name, flags in BUILDS.items():
        out = tmp / f"host_image_{name}.so"
        subprocess.run([cxx, *flags, "-o", str(out), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def median_ms(fn, reps: int = 7) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    rng = np.random.default_rng(0)
    kernel = ellipse_kernel(3)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for name, (H, W, C) in INPUTS.items():
            img = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
            h = sample_homography_np(NORM_SHAPE, shift=-1.0, seed=int(rng.integers(2**31)),
                                     **PARAMS)
            cov = native.warp_coverage_f32((H, W), h)
            calls = {
                "bilinear_c3": (lambda lib: native.warp_perspective_f32_compiled(img, h, lib=lib),
                                native.warp_perspective_f32(img, h)),
                "bilinear_c1": (lambda lib: native.warp_perspective_f32_compiled(
                    img[..., :1], h, lib=lib), native.warp_perspective_f32(img[..., :1], h)),
                "nearest_c1": (lambda lib: native.warp_perspective_f32_compiled(
                    img[..., :1], h, "nearest", lib=lib),
                    native.warp_perspective_f32(img[..., :1], h, "nearest")),
                "coverage": (lambda lib: native.warp_coverage_f32_compiled((H, W), h, lib=lib),
                             cov),
                "erode": (lambda lib: native.erode_compiled(cov, kernel, lib=lib),
                          native.erode(cov, kernel)),
            }
            line = {"input": name, "frame": [H, W, C], "ms": {b: {} for b in BUILDS}}
            for fn_name, (call, want) in calls.items():
                for b, lib in libs.items():
                    got = call(lib)
                    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
                        raise AssertionError(f"{name} {fn_name} {b}: not bit-equal to numpy")
                times = {b: [] for b in BUILDS}
                for order in (list(libs), list(libs)[::-1]):
                    for b in order:
                        times[b].append(median_ms(lambda: call(libs[b])))
                for b in BUILDS:
                    line["ms"][b][fn_name] = times[b]
            print(json.dumps(line), flush=True)
    print(json.dumps({"cpu_count": os.cpu_count(), "cpu": platform.processor() or
                      platform.machine()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
