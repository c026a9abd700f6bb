"""The port's image writers and its BMP reader against OpenCV, on the CPU.

* `encode_jpeg` gives the bytes of `cv2.imencode(".jpg", img)` (OpenCV's
  defaults: quality 95, 4:2:0, the Annex K Huffman tables): the numpy twin
  and the compiled host code (`host_image.cpp` built here with g++), on
  smooth and noisy BGR and grey frames, at sizes that are and are not
  multiples of 16; and its stages against libjpeg-turbo's C arithmetic
  (the reciprocal quantization against exact rounded division where the
  two agree).
* `write_png` round-trips grey, BGR and BGRA through `cv2.imread` and the
  port's `read_png`.
* `datasets._imread` reads BMP files as `cv2.imread` does: 8-bit with a
  grey or colour palette, 24-bit and 32-bit, bottom-up and top-down, the
  40-byte, V5 and 12-byte core headers.
"""

import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu_torch.data import jpeg
from yolopoint_tpu_torch.data.bmp import decode_bmp
from yolopoint_tpu_torch.data.datasets import _imread
from yolopoint_tpu_torch.data.png import read_png, write_png
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIZES = [(97, 131), (16, 16), (8, 8), (1, 1), (17, 33), (31, 15), (48, 64), (9, 200)]


def frame(kind, H, W, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    else:
        yy, xx = np.mgrid[:H, :W]
        img = np.stack([127 + 120 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0) for c in range(3)],
                       -1).astype(np.uint8)
    return img[..., 0].copy() if kind == "grey" else img


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled encoder is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.yp_jpeg_encode.argtypes = _build._SIGNATURES["yp_jpeg_encode"]
    lib.yp_jpeg_encode.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("kind", ["smooth", "noise", "grey"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_numpy_encoder_equals_imencode(kind, size):
    img = frame(kind, *size)
    want = cv2.imencode(".jpg", img)[1].tobytes()
    assert jpeg.encode_jpeg(img, device="cpu") == want


def test_encoder_at_a_camera_frame():
    img = frame("smooth", 480, 640)
    img[100:300, 200:500] = frame("noise", 200, 300)
    assert jpeg.encode_numpy(img) == cv2.imencode(".jpg", img)[1].tobytes()


def test_compiled_encoder_equals_numpy(host_lib, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: host_lib)
    for i, size in enumerate(SIZES + [(480, 640)]):
        for kind in ("smooth", "noise", "grey"):
            img = frame(kind, *size, seed=i)
            got = jpeg.encode_jpeg(img, device="cuda")  # the compiled host code
            assert got == jpeg.encode_numpy(img), (size, kind)


def test_write_jpeg_decodes(tmp_path):
    img = frame("smooth", 97, 131)
    jpeg.write_jpeg(tmp_path / "a.jpg", img, device="cpu")
    np.testing.assert_array_equal(jpeg.read_jpeg(tmp_path / "a.jpg", device="cpu"),
                                  cv2.imread(str(tmp_path / "a.jpg")))


def test_quantization_is_rounded_division_where_exact():
    """The reciprocal quantization rounds |x| / (8 q) to nearest for the
    FDCT's range at every divisor of quality 95's tables but where
    libjpeg-turbo's correction differs by design; the encoder's bytes (the
    tests above) hold it to the reciprocal's."""
    q = jpeg.quality_tables()
    x = np.arange(-2048 * 8, 2048 * 8)[:, None]
    got = jpeg.quantize(np.repeat(x, 64, axis=1), q[0])
    exact = np.sign(x) * ((np.abs(x) + 4 * q[0]) // (8 * q[0]))
    assert (got != exact).mean() < 1e-3


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png", device="cpu"),
                                  cv2.imread(str(tmp_path / "a.png")))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_of_cv2(tmp_path, channels):
    rng = np.random.default_rng(channels)
    for h, w in ((5, 7), (16, 16), (13, 31)):
        img = rng.integers(0, 256, (h, w, channels) if channels > 1 else (h, w), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "a.bmp"), img)
        np.testing.assert_array_equal(_imread(str(tmp_path / "a.bmp"), "cpu"),
                                      cv2.imread(str(tmp_path / "a.bmp")))


def bmp_file(pixels, bpp, top_down=False, palette=None, core=False):
    """A hand-made BMP: `pixels` (H, W, 3|4) BGR(X) or (H, W) palette indices."""
    h, w = pixels.shape[:2]
    stride = (w * bpp // 8 + 3) & ~3
    rows = pixels.reshape(h, -1)
    body = b"".join(r.tobytes().ljust(stride, b"\0") for r in (rows if top_down else rows[::-1]))
    entry = 3 if core else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes(c[:entry]) for c in palette)
    if core:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, 0, len(body),
                          2835, 2835, len(palette) if palette is not None else 0, 0)
    offset = 14 + len(dib) + len(pal)
    return struct.pack("<2sIHHI", b"BM", offset + len(body), 0, 0, offset) + dib + pal + body


@pytest.mark.parametrize("variant", ["24_top_down", "32_bi_rgb", "8_colour", "8_core",
                                     "24_core", "32_top_down"])
def test_bmp_variants(tmp_path, variant):
    rng = np.random.default_rng(len(variant))
    h, w = 11, 9
    top_down = "top_down" in variant
    if variant.startswith("8"):
        palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
        data = bmp_file(rng.integers(0, 256, (h, w), dtype=np.uint8), 8, palette=palette,
                        core="core" in variant)
    else:
        bpp = int(variant[:2])
        data = bmp_file(rng.integers(0, 256, (h, w, bpp // 8), dtype=np.uint8), bpp, top_down,
                        core="core" in variant)
    path = tmp_path / "a.bmp"
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None
    np.testing.assert_array_equal(_imread(str(path), "cpu"), want)


def test_bmp_refuses_rle():
    """A BI_RLE4 flag on an 8-bit file and BI_RLE8 on a 24-bit one are
    refused as malformed (`cv2.imread` returns None for both); run-length
    files themselves are read (`tests/test_torch_bmp.py`)."""
    data = bytearray(bmp_file(np.zeros((4, 4), np.uint8), 8, palette=np.zeros((256, 4), np.uint8)))
    struct.pack_into("<I", data, 30, 2)  # BI_RLE4 at 8 bits
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError):
        decode_bmp(bytes(data), device="cpu")
    data = bytearray(bmp_file(np.zeros((4, 4, 3), np.uint8), 24))
    struct.pack_into("<I", data, 30, 1)  # BI_RLE8 at 24 bits
    assert cv2.imdecode(np.frombuffer(bytes(data), np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError):
        decode_bmp(bytes(data), device="cpu")
