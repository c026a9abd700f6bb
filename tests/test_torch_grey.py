"""The port's grey reads (`datasets._imread(path, device, channels=1)`)
against `cv2.imread(path, cv2.IMREAD_GRAYSCALE)`, which is what the JAX
package's `_imread(path, 1)` returns: bit for bit, each format through its
own decoder's conversion (a grey read is not the colour read converted
afterwards):

* PNG at 8 and 16 bits, grey, grey + alpha, RGB, RGBA and palette (libpng's
  rgb_to_gray as OpenCV asks for it), with a gAMA or sRGB chunk (libpng's
  gamma-corrected path, through its 16-bit tables for 16-bit RGB, an sBIT
  chunk setting their index), Adam7-interlaced too;
* JPEG in grey, 4:2:0, 4:2:2, 4:4:4 and Adobe RGB (libjpeg's JCS_GRAYSCALE:
  the Y component alone, or rgb_gray_convert), with EXIF orientations;
* BMP at 8 (palette), 24 and 32 bits, PPM and PGM (OpenCV's own
  converter).

The compiled conversions (`yp_grey_u8`, and `yp_jpeg_decode`'s grey
output, in `ops/csrc/host_image.cpp`, built here with g++) are held equal
to the numpy twins. And the datasets with `input_channels: 1` yield what
the JAX datasets yield for the same config and seed (host crop, device
crop, letterbox, mosaic); where the JAX mosaic of letterboxed one-channel
tiles raises (its letterbox drops the channel axis, as `cv2` does), the
port raises the same `IndexError` at the same stage.
"""

from __future__ import annotations

import copy
import ctypes
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import encode_png
from yolopoint_tpu.data import datasets as jds
from yolopoint_tpu_torch.data import datasets as tds
from yolopoint_tpu_torch.data import native, png
from yolopoint_tpu_torch.data.datasets import _imread
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "datasets" / "fixtures"
NAMES = ["car", "person", "DontCare"]


def cv2_grey(path: Path) -> np.ndarray:
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert want is not None, path
    return want


def check_grey(path: Path, device: str = "cpu") -> None:
    got = _imread(str(path), device, channels=1)
    want = cv2_grey(path)
    assert got.dtype == np.uint8 and got.shape == (*want.shape, 1), path
    np.testing.assert_array_equal(got[..., 0], want, err_msg=str(path))
    np.testing.assert_array_equal(got, jds._imread(str(path), 1), err_msg=str(path))


def chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def with_chunk(data: bytes, extra: bytes) -> bytes:
    """`data` with `extra` chunks before its PLTE (or first IDAT)."""
    at = data.index(b"PLTE" if b"PLTE" in data else b"IDAT") - 4
    return data[:at] + extra + data[at:]


GAMMAS = {"none": b"", "gAMA_45455": chunk(b"gAMA", struct.pack(">I", 45455)),
          "gAMA_220000": chunk(b"gAMA", struct.pack(">I", 220000)),
          "gAMA_100000": chunk(b"gAMA", struct.pack(">I", 100000)),
          "sRGB": chunk(b"sRGB", b"\0")}
PNG_CASES = [(c, d) for c, depths in png.DEPTHS.items() for d in depths]


def png_files(tmp_path: Path, color: int, depth: int) -> list[Path]:
    rng = np.random.default_rng(color * 100 + depth)
    out = []
    for (H, W), interlace in (((11, 13), False), ((16, 33), True), ((1, 5), False)):
        s = rng.integers(0, 2 ** depth, (H, W, png.CHANNELS[color]))
        s[: H // 3] = s[: H // 3, :, :1]  # grey pixels: libpng passes them through
        pal = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
        data = encode_png(s, color, depth, palette=pal, interlace=interlace)
        for name, extra in GAMMAS.items():
            path = tmp_path / f"{H}x{W}_{interlace}_{name}.png"
            path.write_bytes(with_chunk(data, extra))
            out.append(path)
    return out


@pytest.mark.parametrize("color,depth", PNG_CASES, ids=[f"type{c}-{d}bit" for c, d in PNG_CASES])
def test_png_grey_equals_cv2(tmp_path, color, depth):
    for path in png_files(tmp_path, color, depth):
        check_grey(path)


def test_png_16bit_gamma_grey_raises(tmp_path):
    """libpng's gamma-corrected grey of 16-bit RGB, which the port once
    refused, reads as `cv2` reads it: its 16-bit tables at the index shift
    that PNG_MAX_GAMMA_8 and an sBIT chunk set (grey pixels through its
    16-to-8 table, the others through gamma_16_to_1 and gamma_16_from_1);
    the colour read of the same file is unchanged by the gamma (OpenCV asks
    for no gamma correction)."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 65536, (24, 29, 3))
    s[:8] = s[:8, :, :1]  # grey pixels
    s[8:16] = rng.integers(0, 256, (8, 29, 3)) * 257
    for name in ("gAMA_45455", "gAMA_220000", "sRGB"):
        for bits in (0, 10, 12, 16):
            sbit = chunk(b"sBIT", bytes([bits] * 3)) if bits else b""
            path = tmp_path / f"g16_{name}_{bits}.png"
            path.write_bytes(with_chunk(encode_png(s, 2, 16), GAMMAS[name] + sbit))
            check_grey(path)
            np.testing.assert_array_equal(_imread(str(path), "cpu"), cv2.imread(str(path)))
    assert native.png_gamma_tables_16(100000) is None  # within 5% of 1: the plain path


def jpeg_files(tmp_path: Path) -> list[Path]:
    from tests.test_torch_jpeg import rgb_ids, smooth, with_exif

    img = smooth(21, 37, 53)
    out = []
    params = {"grey": None, **{f"s{k}": v for k, v in (
        ("420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        ("444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411))}}
    for name, factor in params.items():
        src = img[..., 0] if factor is None else img
        args = [] if factor is None else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
        data = cv2.imencode(".jpg", src, args)[1].tobytes()
        for o in (0, 6):
            path = tmp_path / f"{name}_{o}.jpg"
            path.write_bytes(with_exif(data, o) if o else data)
            out.append(path)
    full = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])[1].tobytes()
    no_jfif = full[:2] + full[2 + 2 + 16:]
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"  # transform 0: RGB
    for name, data in (("adobe_rgb", no_jfif[:2] + adobe + no_jfif[2:]),
                       ("rgb_ids", rgb_ids(no_jfif))):
        (tmp_path / f"{name}.jpg").write_bytes(data)
        out.append(tmp_path / f"{name}.jpg")
    out += sorted((FIXTURES / "coco" / "images").rglob("*.jpg"))[:2]
    return out


def test_jpeg_grey_equals_cv2(tmp_path):
    files = jpeg_files(tmp_path)
    assert len(files) >= 12
    for path in files:
        check_grey(path)


def test_bmp_ppm_pgm_grey_equals_cv2(tmp_path):
    from tests.test_torch_image_write import bmp_file

    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (13, 31, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    cv2.imwrite(str(tmp_path / "g.bmp"), img[..., 0])  # an 8-bit grey palette
    cv2.imwrite(str(tmp_path / "a.ppm"), img)
    cv2.imwrite(str(tmp_path / "a.pgm"), img[..., 1])
    palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    (tmp_path / "p.bmp").write_bytes(bmp_file(rng.integers(0, 256, (9, 11), dtype=np.uint8), 8,
                                              palette=palette))
    (tmp_path / "x.bmp").write_bytes(bmp_file(rng.integers(0, 256, (9, 11, 4), dtype=np.uint8),
                                              32, top_down=True))
    for name in ("a.bmp", "g.bmp", "a.ppm", "a.pgm", "p.bmp", "x.bmp"):
        check_grey(tmp_path / name)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled twin is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    for name, sig in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = sig
            getattr(lib, name).restype = ctypes.c_int
    return lib


def test_compiled_grey_equals_numpy(host_lib, monkeypatch, tmp_path):
    """Every file above through the compiled host code (the GPU run's path)
    against the numpy twins (and so against `cv2`); and the converters
    alone on random pixels, every kind."""
    from tests.test_torch_image_write import bmp_file

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    files = []
    for c, d in ((2, 8), (6, 16), (3, 4), (0, 16), (4, 8)):
        (tmp_path / f"{c}_{d}").mkdir()
        files += png_files(tmp_path / f"{c}_{d}", c, d)
    files += jpeg_files(tmp_path)
    rng = np.random.default_rng(4)
    (tmp_path / "b.bmp").write_bytes(bmp_file(rng.integers(0, 256, (7, 9, 3), dtype=np.uint8),
                                              24))
    cv2.imwrite(str(tmp_path / "c.ppm"), rng.integers(0, 256, (5, 6, 3), dtype=np.uint8))
    files += [tmp_path / "b.bmp", tmp_path / "c.ppm"]
    for path in files:
        got = _imread(str(path), "cuda", channels=1)  # compiled host code
        np.testing.assert_array_equal(got, _imread(str(path), "cpu", channels=1), str(path))
        np.testing.assert_array_equal(got[..., 0], cv2_grey(path), str(path))
    rgb8 = rng.integers(0, 256, (57, 3), dtype=np.uint8)
    rgb16 = rng.integers(0, 65536, (57, 3)).astype(np.uint16)
    for gamma in (0, 45455, 80000):
        np.testing.assert_array_equal(native.png_rgb_to_grey_compiled(rgb8, 8, gamma),
                                      native.png_rgb_to_grey(rgb8, 8, gamma))
    for gamma, sig_bit in ((0, 0), (45455, 0), (80000, 0), (45455, 12)):
        np.testing.assert_array_equal(native.png_rgb_to_grey_compiled(rgb16, 16, gamma, sig_bit),
                                      native.png_rgb_to_grey(rgb16, 16, gamma, sig_bit))
    np.testing.assert_array_equal(native.cv_bgr_to_grey_compiled(rgb8),
                                  native.cv_bgr_to_grey(rgb8))


# ---------------------------------------------------------------------------
# input_channels: 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    out = tmp_path_factory.mktemp("datasets")
    shutil.copytree(FIXTURES / "kitti", out / "kitti")
    shutil.copytree(FIXTURES / "coco", out / "coco")
    return out


def grey_config(root: Path, name: str, img_size: int, crop=None, device_crop=False,
                mosaic=0.0) -> dict:
    cfg = {"dataset": name, "suffix": ".jpg" if name == "coco" else ".png",
           "preprocessing": {"img_size": img_size}, "input_channels": 1,
           "labels": {"points": str(root / name / "points")}, "augmentation": {"mosaic": mosaic}}
    if crop:
        cfg["augmentation"]["homographic"] = {"cropHW": list(crop), "device_crop": device_crop}
    return cfg


GREY_DATASETS = {
    "kitti_host_crop": ("kitti", 320, (96, 288), False, 0.0),
    "kitti_device_crop": ("kitti", 320, (96, 288), True, 0.0),
    "kitti_mosaic": ("kitti", 320, (96, 288), True, 1.0),
    "coco_letterbox": ("coco", 128, None, False, 0.0),
    "coco_mosaic": ("coco", 128, None, False, 1.0),
}


@pytest.mark.parametrize("case", list(GREY_DATASETS))
def test_one_channel_datasets_equal_jax(root, case):
    name, size, crop, device_crop, mosaic = GREY_DATASETS[case]
    cfg = grey_config(root, name, size, crop, device_crop, mosaic)
    jax_ds = jds.build_dataset(copy.deepcopy(cfg), "train", NAMES, root=str(root))
    port_ds = tds.build_dataset(copy.deepcopy(cfg), "train", NAMES, root=str(root), device="cpu")
    for i in range(len(port_ds)):
        np.random.seed(100 + i)
        try:
            want = jax_ds.get(i)
        except IndexError as e:  # the JAX mosaic of 2-D letterboxed tiles
            assert case == "coco_mosaic", e
            with pytest.raises(IndexError):
                port_ds.get(i, rng=np.random.RandomState(100 + i))
            continue
        got = port_ds.get(i, rng=np.random.RandomState(100 + i))
        assert got["image"].shape == want["image"].shape
        # letterboxed tiles lose the channel axis (cv2.copyMakeBorder's), crops keep it
        assert got["image"].ndim == (2 if case == "coco_letterbox" else 3)
        np.testing.assert_array_equal(got["image"], want["image"])
        for k in ("boxes", "points", "crop_yx", "mosaic_crop_yx"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
        assert got["pad"] == want["pad"]
    if case == "kitti_host_crop":
        (_, img), = list(port_ds.iter_export())[:1]
        (_, ref), = list(jax_ds.iter_export())[:1]
        np.testing.assert_array_equal(img, ref)
