"""The port's PNG reader (`yolopoint_tpu_torch/data/png.py`) against
`cv2.imread(path, cv2.IMREAD_COLOR)`, bit for bit: every colour type at
every bit depth PNG allows, every filter type (files written by
`chip_smoke.encode_png`, which filters row y by type y mod 5, and by
`cv2.imwrite`, which picks its own filters), odd widths, Adam7-interlaced
files (in colour and in grey), and the committed `datasets/fixtures/kitti`
images. The compiled unfilter and resize
(`ops/csrc/host_image.cpp`) run on the card; here, where a C++ compiler
exists, the same source is built with it and held bit-equal to the numpy
twins the CPU path runs.
"""

import ctypes
import shutil
import subprocess
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import encode_png
from yolopoint_tpu_torch.data import native, png
from yolopoint_tpu_torch.data.datasets import _imread

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CASES = [(color, depth) for color, depths in png.DEPTHS.items() for depth in depths]


def samples(rng, color: int, depth: int, H: int, W: int):
    s = rng.integers(0, 2 ** depth, (H, W, png.CHANNELS[color]))
    pal = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
    return s, pal


@pytest.mark.parametrize("color,depth", CASES, ids=[f"type{c}-{d}bit" for c, d in CASES])
def test_png_equals_cv2(tmp_path, color, depth):
    rng = np.random.default_rng(color * 100 + depth)
    for H, W in ((11, 13), (5, 1), (16, 33)):
        s, pal = samples(rng, color, depth, H, W)
        path = tmp_path / f"{H}x{W}.png"
        path.write_bytes(encode_png(s, color, depth, palette=pal))
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        got = png.read_png(path, device="cpu")
        assert got.dtype == np.uint8 and got.shape == want.shape == (H, W, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color,depth", CASES, ids=[f"type{c}-{d}bit" for c, d in CASES])
def test_adam7_equals_cv2(tmp_path, color, depth):
    """Adam7-interlaced files, each pass filtered on its own, at sizes that
    leave passes empty (1x1, 3x2, 5x1) and fill all seven: the colour and
    the grey read equal to `cv2.imread`'s."""
    rng = np.random.default_rng(color * 10 + depth)
    for H, W in ((1, 1), (3, 2), (5, 1), (9, 13), (16, 33)):
        s, pal = samples(rng, color, depth, H, W)
        path = tmp_path / f"{H}x{W}.png"
        path.write_bytes(encode_png(s, color, depth, palette=pal, interlace=True))
        np.testing.assert_array_equal(png.read_png(path, device="cpu"), cv2.imread(str(path)))
        np.testing.assert_array_equal(png.read_png(path, device="cpu", grey=True),
                                      cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("channels", [1, 3])
def test_cv2_written_files_and_fixtures(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = cv2.GaussianBlur(rng.integers(0, 256, (37, 53, channels)).astype(np.uint8), (5, 5), 2)
    for level in (0, 9):
        path = tmp_path / f"cv2_{level}.png"
        cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        np.testing.assert_array_equal(_imread(str(path), "cpu"), cv2.imread(str(path)))
    fixtures = sorted((REPO / "datasets" / "fixtures" / "kitti" / "images").rglob("*.png"))
    assert len(fixtures) == 6
    for p in fixtures:
        np.testing.assert_array_equal(_imread(str(p), "cpu"), cv2.imread(str(p)))


def test_bad_files_raise(tmp_path):
    data = encode_png(np.zeros((4, 4, 3), np.uint8), 2)
    crc_off = data.index(b"IDAT") + 4 + int.from_bytes(data[data.index(b"IDAT") - 4:
                                                           data.index(b"IDAT")], "big")
    corrupt = data[:crc_off] + bytes([data[crc_off] ^ 1]) + data[crc_off + 1:]
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(corrupt, device="cpu")
    ihdr = data.index(b"IHDR") + 4
    interlaced = bytearray(data)
    interlaced[ihdr + 12] = 1  # the interlace byte of IHDR, CRC fixed below
    interlaced[ihdr + 13:ihdr + 17] = zlib.crc32(bytes(interlaced[ihdr - 4:ihdr + 13])) \
        .to_bytes(4, "big")
    (tmp_path / "adam7.png").write_bytes(bytes(interlaced))
    assert cv2.imread(str(tmp_path / "adam7.png")) is None  # too few bytes for the passes
    with pytest.raises(ValueError, match="adam7.png.*scanlines"):
        png.read_png(tmp_path / "adam7.png", device="cpu")
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8")  # a JPEG SOI and nothing else
    assert cv2.imread(str(tmp_path / "a.jpg")) is None
    with pytest.raises(FileNotFoundError, match="a.jpg"):  # as the JAX `_imread` raises
        _imread(str(tmp_path / "a.jpg"), "cpu")


def scanlines(data: bytes) -> tuple[np.ndarray, int, int]:
    ihdr, _, idat = png.parse_chunks(data)
    stride, bpp = png.geometry(ihdr)
    return np.frombuffer(zlib.decompress(idat), np.uint8), stride, bpp


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_numpy_unfilter_reverses_each_filter(ftype):
    """Each filter type alone, at byte distances 1, 2, 3, 4, 6 and 8."""
    rng = np.random.default_rng(ftype)
    for color, depth in ((0, 8), (0, 16), (2, 8), (6, 8), (2, 16), (6, 16)):
        s, _ = samples(rng, color, depth, 6, 7)
        plain, stride, bpp = scanlines(encode_png(s, color, depth, filters=(0,)))
        raw, _, _ = scanlines(encode_png(s, color, depth, filters=(ftype,)))
        want = plain.reshape(6, stride + 1)[:, 1:]
        np.testing.assert_array_equal(png.unfilter_numpy(raw, 6, stride, bpp), want)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled twin is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(out))


def test_compiled_unfilter_equals_numpy(host_lib):
    rng = np.random.default_rng(3)
    for color, depth in CASES:
        s, pal = samples(rng, color, depth, 9, 21)
        raw, stride, bpp = scanlines(encode_png(s, color, depth, palette=pal))
        out = np.empty((9, stride), np.uint8)
        assert host_lib.yp_png_unfilter(ctypes.c_void_p(raw.ctypes.data),
                                        ctypes.c_void_p(out.ctypes.data), 9, stride, bpp) == 0
        np.testing.assert_array_equal(out, png.unfilter_numpy(raw, 9, stride, bpp))


def test_compiled_resize_equals_numpy(host_lib):
    rng = np.random.default_rng(4)
    for (sh, sw), (dh, dw) in (((75, 248), (58, 192)), ((24, 80), (72, 240)), ((13, 17), (5, 7))):
        img = cv2.GaussianBlur(rng.integers(0, 256, (sh, sw, 3)).astype(np.uint8), (5, 5), 1.5)
        for mode, fn in (("area", host_lib.yp_host_resize_area_u8),
                         ("bilinear", host_lib.yp_host_resize_bilinear_u8)):
            out = np.empty((dh, dw, 3), np.uint8)
            fn(ctypes.c_void_p(img.ctypes.data), sh, sw, 3, ctypes.c_void_p(out.ctypes.data),
               dh, dw)
            np.testing.assert_array_equal(out, native.resize_u8(img, dh, dw, mode))


def test_compiled_adam7_equals_numpy(host_lib, monkeypatch):
    """The Adam7 passes unfiltered by the compiled code (the GPU run's path)
    against the numpy twin, in colour and in grey."""
    from yolopoint_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    for name, sig in _build._SIGNATURES.items():
        if hasattr(host_lib, name):
            getattr(host_lib, name).argtypes = sig
    rng = np.random.default_rng(8)
    for color, depth in CASES:
        s, pal = samples(rng, color, depth, 11, 19)
        data = encode_png(s, color, depth, palette=pal, interlace=True)
        for grey in (False, True):
            np.testing.assert_array_equal(png.decode_png(data, device="cuda", grey=grey),
                                          png.decode_png(data, device="cpu", grey=grey))
