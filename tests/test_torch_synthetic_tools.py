"""The port's synthetic-data tools (`yolopoint_tpu_torch/tools/`) write the
files the JAX package's tools write, run here on the same seeds:

* `synthetic_hpatches` against `tools/make_synthetic_hpatches.py`: every
  PPM and `H_1_n` file of viewpoint and illumination scenes byte-equal, with
  the warp in numpy and in compiled host code; its first scene at 256x320
  matches the SHA-256 that `chip_smoke.py` holds the card's render to;
* `synthetic_dataset` against `tools/make_synthetic_dataset.py`: the PNG
  files and the label text byte-equal, the `.npz` points equal (the zip
  holds a time stamp);
* `synthetic_sequence` against `tools/make_synthetic_sequence.py`: the PNG
  frames byte-equal;
* the writers the tools use: `data.netpbm.encode_ppm` and `data.png.encode_png`
  give `cv2`'s bytes.

The committed `datasets/hpatches_synth` was written by an older renderer
(the JAX tool of commit d3e99ee reproduces it, today's JAX tool does not),
so the twin is held to the JAX tool as it runs here.
"""

import ctypes
import hashlib
import importlib.util
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import HPATCHES_SYNTH_SHA256
from yolopoint_tpu_torch.data.png import encode_png
from yolopoint_tpu_torch.data.netpbm import encode_ppm
from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.tools import synthetic_dataset, synthetic_hpatches, synthetic_sequence

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def jax_tool(name: str):
    """A script of the repository's `tools/` (the JAX package's tools)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def assert_same_tree(got: Path, want: Path) -> None:
    a, b = files(got), files(want)
    assert sorted(a) == sorted(b)
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, differ


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


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_hpatches_twin_writes_the_jax_tools_files(tmp_path, device, request, monkeypatch):
    """Two viewpoint scenes and one illumination scene at 96x128; `cuda`
    takes the compiled warp (the g++ build answering `_build.library`)."""
    if device == "cuda":
        lib = request.getfixturevalue("host_lib")
        monkeypatch.setattr(_build, "library", lambda: lib)
    args = ["--scenes", "2", "--i-scenes", "1", "--hw", "96", "128", "--seed", "4"]
    jax_tool("make_synthetic_hpatches").main(["--out", str(tmp_path / "jax"), *args])
    synthetic_hpatches.main(["--out", str(tmp_path / "port"), *args, "--device", device])
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(files(tmp_path / "port")) == 3 * 11


def test_hpatches_first_scene_matches_the_recorded_digests(tmp_path):
    """The first scene of the default seed at 256x320, by both tools, has the
    SHA-256 that `chip_smoke.py` checks the card's render against."""
    args = ["--scenes", "1", "--i-scenes", "0", "--hw", "256", "320"]
    jax_tool("make_synthetic_hpatches").main(["--out", str(tmp_path / "jax"), *args])
    synthetic_hpatches.main(["--out", str(tmp_path / "port"), *args, "--device", "cpu"])
    for tool in ("jax", "port"):
        scene = tmp_path / tool / "v_synth000"
        got = {f: hashlib.sha256((scene / f).read_bytes()).hexdigest()
               for f in HPATCHES_SYNTH_SHA256}
        assert got == HPATCHES_SYNTH_SHA256, tool


def test_photometric_change_is_numpy_version_proof():
    """`photometric` writes every promotion out: the JAX tool's expression,
    evaluated by this host's numpy 2, gives the same bytes."""
    jax_mod = jax_tool("make_synthetic_hpatches")
    img = np.random.default_rng(0).integers(0, 256, (33, 47, 3), np.uint8)
    for seed in range(4):
        want = jax_mod._photometric(np.random.default_rng(seed), img)
        got = synthetic_hpatches.photometric(np.random.default_rng(seed), img)
        np.testing.assert_array_equal(got, want)


def test_dataset_twin_writes_the_jax_tools_files(tmp_path):
    args = ["--n", "4", "--val", "2", "--hw", "64", "96", "--seed", "3"]
    jax_tool("make_synthetic_dataset").main(["--out", str(tmp_path / "jax"), *args])
    synthetic_dataset.main(["--out", str(tmp_path / "port"), *args])
    got, want = files(tmp_path / "port"), files(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3 * 6
    for name in got:
        if name.endswith(".npz"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name)["pts"],
                                          np.load(tmp_path / "jax" / name)["pts"])
        else:
            assert got[name] == want[name], name


def test_sequence_twin_writes_the_jax_tools_frames(tmp_path):
    args = ["--frames", "4", "--hw", "64", "96", "--seed", "6"]
    jax_tool("make_synthetic_sequence").main(["--out", str(tmp_path / "jax"), *args])
    synthetic_sequence.main(["--out", str(tmp_path / "port"), *args, "--device", "cpu"])
    assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_ppm_writer_bytes_equal_cv2(tmp_path):
    rng = np.random.default_rng(1)
    for shape in ((1, 1, 3), (7, 5, 3), (240, 320, 3)):
        img = rng.integers(0, 256, shape, np.uint8)
        cv2.imwrite(str(tmp_path / "a.ppm"), img)
        assert encode_ppm(img) == (tmp_path / "a.ppm").read_bytes()
    with pytest.raises(ValueError, match="BGR"):
        encode_ppm(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_png_writer_bytes_equal_cv2(channels):
    """OpenCV 5's defaults: Sub filters (None one pixel wide), zlib level 1
    with the run-length strategy, libpng's small-image window, 8192-byte
    IDATs; noise and flat images, one pixel wide or high, and large."""
    rng = np.random.default_rng(channels)
    shapes = [(int(rng.integers(1, 60)), int(rng.integers(1, 60))) for _ in range(30)]
    shapes += [(1, 1), (1, 300), (300, 1), (256, 320)]
    for i, (H, W) in enumerate(shapes):
        img = rng.integers(0, 256, (H, W, max(channels, 1)), np.uint8)
        if i % 2:
            img = (img // 64 * 60).astype(np.uint8)
        if channels == 0:
            img = img[..., 0]
        ok, want = cv2.imencode(".png", img)
        assert ok and encode_png(img) == want.tobytes(), (H, W, channels)
