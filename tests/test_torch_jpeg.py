"""The port's JPEG reader (`yolopoint_tpu_torch/data/jpeg.py`) against the JAX
package's `_imread`, which is `cv2.imread(path, cv2.IMREAD_COLOR)` (OpenCV
built with libjpeg-turbo), bit for bit: the committed COCO fixtures, and
files `cv2.imencode` writes here at every chroma sampling layout, in grey,
at four qualities, with optimized Huffman tables, with restart intervals,
at sizes no side of which is a multiple of 16, with each EXIF orientation
injected, and in the colour spaces libjpeg infers without JFIF (Adobe
transform 0 and 1, components named R, G, B); a progressive file raises naming the file, and a
truncated one reads as `cv2` reads it. The compiled decoder
(`yp_jpeg_decode` in `ops/csrc/host_image.cpp`, which the card runs) is
built here with g++ and held bit-equal to the numpy twin on every case;
and `chip_smoke.encode_jpeg`, the encoder of the card's checks, is held by
`cv2` decoding its files to what the port decodes.
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

from chip_smoke import JPEG_SAMPLING, encode_jpeg
from yolopoint_tpu.data.datasets import _imread as jax_imread
from yolopoint_tpu_torch.data import jpeg
from yolopoint_tpu_torch.data.datasets import _imread
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = sorted((REPO / "datasets" / "fixtures" / "coco" / "images").rglob("*.jpg"))
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (1, 17), (8, 8), (15, 17), (33, 47), (100, 120), (136, 104)]


def smooth(seed: int, H: int, W: int, channels: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, channels)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5).reshape(H, W, channels)


def encode(img: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def with_exif(data: bytes, orientation: int, order: bytes = b"II") -> bytes:
    """`data` with an APP1 Exif segment after SOI whose IFD0 holds only the
    orientation tag (0x0112, SHORT)."""
    e = "<" if order == b"II" else ">"
    tiff = order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1) \
        + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0)
    body = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


def generated_cases():
    """(id, bytes) of every generated file."""
    cases = []
    base = smooth(0, 33, 47)
    for name, factor in SAMPLING.items():
        cases.append((f"sampling_{name}",
                      encode(base, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor)))
    cases.append(("grey", encode(base[..., 0])))
    for q in (5, 50, 90, 100):
        cases.append((f"quality_{q}", encode(smooth(1, 100, 120), cv2.IMWRITE_JPEG_QUALITY, q)))
    cases.append(("optimized", encode(base, cv2.IMWRITE_JPEG_OPTIMIZE, 1)))
    for r in (1, 3):
        cases.append((f"restart_{r}",
                      encode(smooth(2, 100, 120), cv2.IMWRITE_JPEG_RST_INTERVAL, r)))
    for H, W in SIZES:  # each size at every layout and in grey, in one case
        img = smooth(H * 1000 + W, H, W)
        parts = [encode(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f) for f in SAMPLING.values()]
        cases.append((f"size_{H}x{W}", parts + [encode(img[..., 0])]))
    plain = encode(smooth(3, 37, 53))
    for o in range(1, 9):
        cases.append((f"orientation_{o}", [with_exif(plain, o), with_exif(plain, o, b"MM")]))
    # the colour space libjpeg infers without a JFIF APP0: an Adobe APP14's
    # transform (0: RGB, 1: YCbCr), else the component ids ('R', 'G', 'B': RGB)
    full = encode(base, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"])
    no_jfif = full[:2] + full[2 + 2 + 16:]
    for t in (0, 1):
        adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([t])
        cases.append((f"adobe_transform_{t}", no_jfif[:2] + adobe + no_jfif[2:]))
    cases.append(("rgb_component_ids", rgb_ids(no_jfif)))
    return cases


def rgb_ids(data: bytes) -> bytes:
    """`data` with its three components renamed 'R', 'G', 'B' in SOF0 and SOS."""
    out = bytearray(data)
    sof, sos = out.index(b"\xff\xc0"), out.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        out[sof + 10 + 3 * i] = cid  # FF C0, length, precision, H, W, count, then 3 bytes each
        out[sos + 5 + 2 * i] = cid   # FF DA, length, count, then 2 bytes each
    return bytes(out)


CASES = generated_cases()


def check_file(path: Path) -> np.ndarray:
    """The port's numpy decode of `path`, asserted equal to the JAX `_imread`."""
    want = jax_imread(str(path))
    got = jpeg.read_jpeg(path, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_imread(str(path), "cpu"), got)
    return got


@pytest.mark.parametrize("path", FIXTURES, ids=[p.stem for p in FIXTURES])
def test_coco_fixtures_equal_cv2(path):
    assert len(FIXTURES) == 8
    check_file(path)


@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_generated_files_equal_cv2(tmp_path, case):
    data = dict(CASES)[case]
    for i, part in enumerate(data if isinstance(data, list) else [data]):
        path = tmp_path / f"{case}_{i}.jpg"
        path.write_bytes(part)
        got = check_file(path)
        if case.startswith("orientation_"):
            o = int(case.split("_")[1])
            assert got.shape[:2] == ((53, 37) if o >= 5 else (37, 53))
            if o == 6:  # as checked against cv2: a quarter turn clockwise
                np.testing.assert_array_equal(got, np.rot90(jpeg.decode_jpeg(
                    dict(CASES)["orientation_1"][0], device="cpu"), -1))


def test_progressive_raises_naming_the_file(tmp_path):
    path = tmp_path / "progressive.jpg"
    path.write_bytes(encode(smooth(4, 33, 47), cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    assert cv2.imread(str(path)) is not None  # cv2 reads it; the port does not
    with pytest.raises(NotImplementedError, match="progressive.jpg.*progressive"):
        jpeg.read_jpeg(path, device="cpu")
    with pytest.raises(NotImplementedError, match="progressive.jpg"):
        _imread(str(path), "cpu")


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("fraction", [0.02, 0.1, 0.5, 0.97])
def test_truncated_files_as_cv2(tmp_path, restart, fraction):
    """Cut in the header: `cv2.imread` returns None and both packages raise
    `FileNotFoundError`. Cut in the scan: libjpeg-turbo reads the rest as
    zero bits, then zero MCUs, and the port gives the same bytes."""
    data = encode(smooth(5, 100, 120), cv2.IMWRITE_JPEG_QUALITY, 90,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:int(len(data) * fraction)])
    if cv2.imread(str(path)) is None:
        assert fraction <= 0.1
        with pytest.raises(FileNotFoundError):
            jax_imread(str(path))
        with pytest.raises(FileNotFoundError, match="cut.jpg"):
            jpeg.read_jpeg(path, device="cpu")
        with pytest.raises(FileNotFoundError):
            _imread(str(path), "cpu")
    else:
        assert fraction >= 0.1
        check_file(path)


@pytest.mark.parametrize("height, width", [(65501, 16), (16, 65501), (32769, 32768)])
def test_oversized_frames_raise_before_decoding(tmp_path, height, width):
    """A SOF forged past libjpeg's side limit (`cv2.imread` returns None) or
    OpenCV's pixel limit (`cv2.imread` raises): the port raises
    `FileNotFoundError` naming the file from the header, before any
    buffer of the frame's size is allocated."""
    data = bytearray(encode(smooth(7, 16, 16)))
    sof = data.index(b"\xff\xc0")
    data[sof + 5:sof + 9] = struct.pack(">HH", height, width)
    path = tmp_path / "forged.jpg"
    path.write_bytes(bytes(data))
    if max(height, width) > 65500:
        assert cv2.imread(str(path)) is None
        with pytest.raises(FileNotFoundError):
            jax_imread(str(path))
    else:
        with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
            cv2.imread(str(path))
    for device in ("cpu", "cuda"):  # the header is refused before either decoder runs
        with pytest.raises(FileNotFoundError, match="forged.jpg.*too large"):
            jpeg.read_jpeg(path, device=device)
    with pytest.raises(FileNotFoundError, match="forged.jpg"):
        _imread(str(path), "cpu")


def test_malformed_streams_raise(tmp_path):
    data = encode(smooth(6, 16, 16))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG", device="cpu")
    sof = data.index(b"\xff\xc0")
    twelve_bit = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(twelve_bit, "x.jpg", device="cpu")
    # a three-component file without its JFIF APP0, given an Adobe APP14 of transform 2
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    no_jfif = data[:2] + data[2 + 2 + 16:]
    with pytest.raises(NotImplementedError, match="YCCK"):
        jpeg.decode_jpeg(no_jfif[:2] + adobe + no_jfif[2:], device="cpu")
    path = tmp_path / "no_huffman.jpg"
    dht = data.index(b"\xff\xc4")
    # every DHT segment dropped: libjpeg-turbo (and the port) take the standard tables
    out, pos = bytearray(data[:dht]), dht
    while data[pos:pos + 2] == b"\xff\xc4":
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    path.write_bytes(bytes(out) + data[pos:])
    check_file(path)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled decoder is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    lib.yp_jpeg_decode.argtypes = _build._SIGNATURES["yp_jpeg_decode"]
    lib.yp_jpeg_decode.restype = ctypes.c_int
    return lib


@pytest.fixture
def compiled(host_lib, monkeypatch):
    """`_build.library()` answered by the g++ build of `host_image.cpp`."""
    monkeypatch.setattr(_build, "library", lambda: host_lib)


def all_files():
    out = [(p.stem, p.read_bytes()) for p in FIXTURES]
    for case, data in CASES:
        out += [(f"{case}_{i}", d) for i, d in enumerate(data if isinstance(data, list)
                                                         else [data])]
    full = encode(smooth(8, 100, 120), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out += [(f"cut_{f}", full[:int(len(full) * f)]) for f in (0.3, 0.6)]
    return out


@pytest.mark.parametrize("group", range(4))
def test_compiled_decoder_equals_numpy(compiled, group):
    files = all_files()
    for name, data in files[group::4]:
        want = jpeg.decode_jpeg(data, name, device="cpu")
        got = jpeg.decode_jpeg(data, name, device="cuda")  # the compiled host code
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_compiled_decoder_reports_bad_input(host_lib):
    """Status 2 for a Huffman table with more codes than its lengths hold,
    3 for a sampling ratio that is not integral, 1 for a bad component count."""
    def run(params, huff):
        quant = np.ones((3, 64), np.int32)
        data = np.frombuffer(b"\x00\xff\xd9", np.uint8)
        out = np.empty((8, 8, 3), np.uint8)
        return host_lib.yp_jpeg_decode(*[a.ctypes.data_as(ctypes.c_void_p) for a in (data,)],
                                       3, *[a.ctypes.data_as(ctypes.c_void_p)
                                            for a in (params, quant, huff, out)])

    good = np.zeros((3, 2, 272), np.uint8)
    good[:, :, 0] = 1  # one code of length 1, symbol 0
    bad = good.copy()
    bad[0, 1, 0] = 3  # three codes of length 1
    grey = np.array([8, 8, 1, 0, jpeg.GREY, 1, 1, 0], np.int32)
    assert run(grey, good) == 0 and run(grey, bad) == 2
    fractional = np.array([8, 8, 3, 0, jpeg.YCC, 3, 1, 2, 1, 1, 1, 0, 1, 2], np.int32)
    assert run(fractional, good) == 3
    assert run(np.array([8, 8, 2, 0, jpeg.YCC, 1, 1, 1, 1, 0, 1], np.int32), good) == 1


@pytest.mark.parametrize("sampling", [*JPEG_SAMPLING, "grey"])
def test_encoder_of_the_card_checks(tmp_path, sampling):
    """`chip_smoke.encode_jpeg`'s files: `cv2` decodes them to what the port
    decodes, at odd sizes, with and without restart intervals and EXIF
    orientations, and within a PSNR bound of what was encoded."""
    for (H, W), restart, orientation in (((15, 17), 0, 0), ((33, 47), 1, 6),
                                         ((136, 104), 3, 3), ((1, 1), 0, 8)):
        img = smooth(H + W, H, W)
        src = img[..., 0] if sampling == "grey" else img
        data = encode_jpeg(src, 90, "420" if sampling == "grey" else sampling, restart,
                           orientation)
        path = tmp_path / f"{H}x{W}.jpg"
        path.write_bytes(data)
        got = check_file(path)
        back = jpeg.orient(got, {0: 1, 6: 8, 3: 3, 8: 6}[orientation])  # undo the turn
        ref = np.repeat(src[..., None], 3, axis=2) if sampling == "grey" else src
        mse = np.mean((back.astype(np.float64) - ref) ** 2)
        assert mse == 0 or 10 * np.log10(255 ** 2 / mse) > 25, (H, W, mse)
