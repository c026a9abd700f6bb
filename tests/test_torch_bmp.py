"""The port's run-length BMP reading (`data/bmp.py`: `BI_RLE8` and
`BI_RLE4`) against `cv2.imread`, bit for bit, in colour and in grey: files
of random codes (`chip_smoke.encode_bmp_rle`: encoded and absolute runs,
ends of line, deltas, ends of bitmap) at sizes from 1x1 up, hand-made code
streams for the cursor moves OpenCV 5 makes (an RLE8 run that ends its row,
an end of line after it, a delta of dy rows; an RLE4 delta of dx pixels
only, an RLE4 end of bitmap that ends only its row), and files cut short
(`cv2.imread` returns None, the port raises). The compiled decoder
(`yp_bmp_rle` in `ops/csrc/host_image.cpp`, built here with g++) is held
equal to the numpy twin on every file."""

from __future__ import annotations

import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import encode_bmp_rle
from yolopoint_tpu_torch.data import bmp
from yolopoint_tpu_torch.data.datasets import _imread
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def rle_file(codes: bytes, W: int, H: int, bpp: int) -> bytes:
    """A BMP of the code stream `codes` over a palette whose entry i is
    (10 i + 5, 3 i, 255 - i)."""
    n = 1 << bpp
    pal = np.stack([np.arange(n) * 10 + 5, np.arange(n) * 3, 255 - np.arange(n),
                    np.zeros(n)], 1).astype(np.uint8).tobytes()
    dib = struct.pack("<IiiHHIIiiII", 40, W, H, 1, bpp, 1 if bpp == 8 else 2, len(codes), 2835,
                      2835, n, 0)
    off = 14 + len(dib) + len(pal)
    return struct.pack("<2sIHHI", b"BM", off + len(codes), 0, 0, off) + dib + pal + codes


def check(path: Path) -> int:
    """The port's colour and grey reads of `path` against `cv2`'s; 1 if cv2
    read it, 0 if it returned None (and the port raised)."""
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(ValueError):
            bmp.read_bmp(path, device="cpu")
        return 0
    np.testing.assert_array_equal(_imread(str(path), "cpu"), want, err_msg=path.name)
    np.testing.assert_array_equal(_imread(str(path), "cpu", channels=1)[..., 0],
                                  cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), err_msg=path.name)
    return 1


@pytest.mark.parametrize("bpp", [8, 4])
def test_random_rle_files_equal_cv2(tmp_path, bpp):
    rng = np.random.default_rng(bpp)
    read = 0
    for i in range(60):
        W, H = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        path = tmp_path / f"r{i}.bmp"
        data = encode_bmp_rle(rng, W, H, bpp)
        path.write_bytes(data[:len(data) - 3] if i % 10 == 9 else data)  # every tenth cut
        read += check(path)
    assert 50 <= read <= 57


# (bpp, width, height, codes) of the cursor moves in OpenCV 5's decoder
CURSOR_CASES = {
    "rle8_run_ends_row_then_eol": (8, 3, 4, "0307 0000 0109 0001"),
    "rle8_absolute_ends_row_then_eol": (8, 3, 4, "0003 050607 00 0000 0109 0001"),
    "rle8_eol_on_empty_row": (8, 3, 4, "0000 0000 0109 0001"),
    "rle8_delta_dx_dy": (8, 5, 6, "0203 0002 0201 0109 0001"),
    "rle8_run_across_no_eol": (8, 3, 4, "0307 0308 0001"),
    "rle8_ends_without_eob": (8, 2, 2, "0201 0202"),
    "rle4_delta_is_dx_only": (4, 5, 6, "0233 0002 0203 0199 0000 0000 0000 0000 0000 0000"),
    "rle4_eob_ends_its_row": (4, 3, 3, "0122 0001 0144 0000 0000"),
    "rle4_eol_on_empty_row": (4, 3, 4, "0000 0000 0199 0000 0000"),
    "rle4_absolute_odd": (4, 7, 2, "0005 123450 00 0000 0001 0000"),
}


@pytest.mark.parametrize("case", list(CURSOR_CASES))
def test_rle_cursor_moves_equal_cv2(tmp_path, case):
    bpp, W, H, codes = CURSOR_CASES[case]
    path = tmp_path / f"{case}.bmp"
    path.write_bytes(rle_file(bytes.fromhex(codes.replace(" ", "")), W, H, bpp))
    assert check(path) == 1


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


def test_compiled_rle_equals_numpy(host_lib, monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: host_lib)
    rng = np.random.default_rng(9)
    datas = [rle_file(bytes.fromhex(c.replace(" ", "")), W, H, b)
             for b, W, H, c in CURSOR_CASES.values()]
    datas += [encode_bmp_rle(rng, int(rng.integers(1, 50)), int(rng.integers(1, 40)), b)
              for b in (4, 8) * 20]
    raised = 0
    for data in datas:
        for grey in (False, True):
            want = bmp.decode_bmp(data, device="cpu", grey=grey)
            np.testing.assert_array_equal(bmp.decode_bmp(data, device="cuda", grey=grey), want)
        cut = data[:len(data) - 2]  # the codes cut short: both raise, or both read
        try:
            want = bmp.decode_bmp(cut, device="cpu")
        except ValueError:
            raised += 1
            with pytest.raises(ValueError, match="ends before"):
                bmp.decode_bmp(cut, device="cuda")
        else:
            np.testing.assert_array_equal(bmp.decode_bmp(cut, device="cuda"), want)
    assert raised > 10
    bad = bytearray(rle_file(bytes.fromhex("0411"), 3, 1, 8))  # a run past its row
    with pytest.raises(ValueError, match="leaves its row"):
        bmp.decode_bmp(bytes(bad), device="cuda")
    with pytest.raises(ValueError, match="leaves its row"):
        bmp.decode_bmp(bytes(bad), device="cpu")
