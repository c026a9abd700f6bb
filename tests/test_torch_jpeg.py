"""The port's JPEG reader (`yolopoint_tpu_torch/data/jpeg.py`) against the JAX
package's `_imread`, which is `cv2.imread(path, cv2.IMREAD_COLOR)` (OpenCV
built with libjpeg-turbo), bit for bit: the committed COCO fixtures, and
files `cv2.imencode` writes here at every chroma sampling layout, in grey,
at four qualities, with optimized Huffman tables, with restart intervals,
at sizes no side of which is a multiple of 16, with each EXIF orientation
injected, and in the colour spaces libjpeg infers without JFIF (Adobe
transform 0, 1 and 2, components named R, G, B); CMYK files as Pillow
writes them and YCCK and straight CMYK files of `chip_smoke.encode_jpeg`,
in colour and grey; progressive files
(`IMWRITE_JPEG_PROGRESSIVE`, with restarts, at every layout, in grey) and
sequential files of one scan a component or of Y then Cb and Cr
(`chip_smoke.encode_jpeg(scans=...)`), in colour and in grey; progressive
files cut before their last scans, which libjpeg-turbo smooths; a
progressive file marked arithmetic-coded reads as `cv2` reads it and one
marked hierarchical raises naming the file; and a truncated file reads as
`cv2` reads it. The
compiled decoder (`yp_jpeg_decode` in `ops/csrc/host_image.cpp`, which the
card runs) is built here with g++ and held bit-equal to the numpy twin on
every case; and `chip_smoke.encode_jpeg`, the encoder of the card's
checks, is held by `cv2` decoding its files to what the port decodes.
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
    prog = (cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    for name, factor in SAMPLING.items():
        cases.append((f"progressive_{name}", [
            encode(smooth(9, 33, 47), *prog, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor),
            encode(smooth(10, 15, 17), *prog, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor)]))
    cases.append(("progressive_grey", [encode(smooth(11, 37, 53)[..., 0], *prog),
                                       encode(smooth(12, 1, 1)[..., 0], *prog)]))
    cases.append(("progressive_restart", [
        encode(smooth(13, 64, 80), *prog, cv2.IMWRITE_JPEG_RST_INTERVAL, r) for r in (1, 3)]))
    cases.append(("progressive_optimized_q50", encode(smooth(14, 100, 120), *prog,
                                                      cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                      cv2.IMWRITE_JPEG_QUALITY, 50)))
    for scans in MULTISCAN:
        label = "_".join("".join(map(str, g)) for g in scans)
        cases.append((f"multiscan_{label}", [
            encode_jpeg(smooth(15, 33, 47), 90, sampling, restart, scans=scans)
            for sampling, restart in (("420", 0), ("422", 2), ("444", 0), ("411", 1))]))
    return cases


# sequential files of several scans: one a component, Y then CbCr, CbCr then Y
MULTISCAN = (((0,), (1,), (2,)), ((0,), (1, 2)), ((1, 2), (0,)), ((2,), (0,), (1,)))


def rgb_ids(data: bytes) -> bytes:
    """`data` with its three components renamed 'R', 'G', 'B' in SOF0 and SOS."""
    out = bytearray(data)
    sof, sos = out.index(b"\xff\xc0"), out.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        out[sof + 10 + 3 * i] = cid  # FF C0, length, precision, H, W, count, then 3 bytes each
        out[sos + 5 + 2 * i] = cid   # FF DA, length, count, then 2 bytes each
    return bytes(out)


CASES = generated_cases()


def pil_cmyk(img: np.ndarray, **kwargs) -> bytes:
    """A CMYK JPEG as Pillow writes it (an Adobe APP14 of transform 0, the
    samples stored inverted, as Adobe's tools store them); Pillow writes the
    test files only: the port does not import it."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def four_component_cases() -> list[tuple[str, bytes]]:
    """(id, bytes) of the four-component files: Pillow's CMYK (baseline at
    two qualities, progressive, at odd sizes) and `chip_smoke.encode_jpeg`'s
    YCCK (Adobe transform 2: 4:2:0, 4:2:2, 4:4:4, restarts, one scan a
    component) and straight CMYK (transform 0, and no Adobe segment, which
    libjpeg reads as CMYK too); and a three-component file under an Adobe
    transform of 2, which libjpeg reads as YCbCr."""
    cmyk = smooth(20, 37, 53, 4)
    cases = [("pil_cmyk_q90", pil_cmyk(cmyk, quality=90)),
             ("pil_cmyk_q50", pil_cmyk(smooth(21, 15, 17, 4), quality=50)),
             ("pil_cmyk_progressive", pil_cmyk(cmyk, quality=80, progressive=True))]
    for sampling, restart in (("420", 0), ("422", 2), ("444", 0)):
        cases.append((f"ycck_{sampling}_r{restart}",
                      encode_jpeg(cmyk, 85, sampling, restart, adobe=2)))
    cases.append(("ycck_scan_a_component",
                  encode_jpeg(cmyk, 85, "420", 1, scans=[(0,), (1,), (2,), (3,)], adobe=2)))
    cases.append(("cmyk_adobe_0", encode_jpeg(cmyk, 85, adobe=0)))
    cases.append(("cmyk_no_adobe", encode_jpeg(255 - cmyk, 85)))
    cases.append(("ycc_adobe_2", encode_jpeg(smooth(22, 33, 47), 90, "420", adobe=2)))
    return cases


FOUR_CASES = four_component_cases()


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


@pytest.mark.parametrize("case", [c for c, _ in FOUR_CASES])
def test_four_component_files_equal_cv2(tmp_path, case):
    """CMYK and YCCK files (libjpeg-turbo's CMYK output, OpenCV's CMYK-to-BGR
    and CMYK-to-grey conversions), in colour and in grey, bit for bit."""
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(dict(FOUR_CASES)[case])
    color = jpeg.parse_header(path.read_bytes()).color
    assert color == {"ycck": jpeg.YCCK, "ycc": jpeg.YCC}.get(case.split("_")[0], jpeg.CMYK)
    check_file(path)
    grey = jpeg.read_jpeg(path, device="cpu", grey=True)
    np.testing.assert_array_equal(grey, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))


def test_progressive_raises_naming_the_file(tmp_path):
    """A Huffman progressive file reads as `cv2` reads it, and so does the
    same file marked arithmetic-coded (SOF10: its bytes read as arithmetic
    code); marked hierarchical (SOF6), which `cv2.imread` returns None for,
    it raises `FileNotFoundError` naming the file."""
    data = encode(smooth(4, 33, 47), cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(data)
    check_file(path)
    sof = data.index(b"\xff\xc2")
    path.write_bytes(data[:sof + 1] + b"\xca" + data[sof + 2:])
    check_file(path)
    path.write_bytes(data[:sof + 1] + b"\xc6" + data[sof + 2:])
    assert cv2.imread(str(path)) is None
    with pytest.raises(FileNotFoundError, match="progressive.jpg.*hierarchical"):
        jpeg.read_jpeg(path, device="cpu")
    with pytest.raises(FileNotFoundError, match="progressive.jpg"):
        _imread(str(path), "cpu")


# (height, width) of the smoothing cases: one, two (the last one partial or
# full) and several iMCU rows; one and two blocks wide
SMOOTH_SIZES = [(16, 16), (17, 9), (24, 24), (32, 24), (37, 53), (64, 80), (9, 40)]


@pytest.mark.parametrize("size", SMOOTH_SIZES, ids=[f"{h}x{w}" for h, w in SMOOTH_SIZES])
def test_block_smoothing_as_cv2(tmp_path, size):
    """Progressive files whose first AC coefficients are unfinished, which
    libjpeg-turbo smooths from the DC values of the 5x5 blocks around each
    block (`jpeg.smooth_blocks`): every scan prefix closed by EOI (the last
    scan complete; from DC alone, where the DC is smoothed too), and cuts
    inside the scans (the rows past the one where the data ran out take
    the bits before that scan), at 4:2:0, 4:4:0 and 4:4:4 with and without
    restarts, and in grey: colour and grey reads equal to `cv2.imread`."""
    H, W = size
    img = smooth(H * 100 + W, H, W)
    path = tmp_path / "s.jpg"
    smoothed = 0
    for src, factor, restart in ((img, "420", 0), (img, "440", 2), (img, "444", 0),
                                 (img[..., 1], "420", 1)):
        data = encode(src, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      SAMPLING[factor], cv2.IMWRITE_JPEG_RST_INTERVAL, restart)
        scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
        cuts = [data[:i] + b"\xff\xd9" for i in scans[1:]]
        cuts += [data[:(a + b) // 2] for a, b in zip(scans, scans[1:])]
        for cut in cuts:
            path.write_bytes(cut)
            for flag, grey in ((cv2.IMREAD_COLOR, False), (cv2.IMREAD_GRAYSCALE, True)):
                want = cv2.imread(str(path), flag)
                if want is None:  # cut inside the Huffman tables before a scan
                    with pytest.raises(FileNotFoundError):
                        jpeg.read_jpeg(path, device="cpu", grey=grey)
                    continue
                np.testing.assert_array_equal(jpeg.read_jpeg(path, device="cpu", grey=grey), want,
                                              err_msg=f"{factor} cut at {len(cut)}, grey {grey}")
                smoothed += jpeg.block_smoothing(jpeg.parse_header(cut))
    assert smoothed >= 20


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


def cut_points(data: bytes) -> list[int]:
    """Where a truncation is cut: around every marker but the restart
    markers (inside the marker segments that follow it, and just after each
    scan header), around the first three restart markers, and at fractions
    of the file."""
    marks = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] not in (0, 0xFF)]
    restarts = [i for i in marks if 0xD0 <= data[i + 1] <= 0xD7]
    marks = [i for i in marks if i not in restarts] + restarts[:3]
    out = {n for i in marks for n in range(i, i + 12)}
    out |= {int(len(data) * f) for f in np.linspace(0.05, 0.99, 20)}
    return sorted(n for n in out if 4 <= n < len(data))


@pytest.mark.parametrize("kind", ["progressive", "progressive_restart", "multiscan"])
def test_truncated_multiscan_files_as_cv2(tmp_path, kind):
    """Cut around every marker and at fractions of the file: where
    `cv2.imread` returns None the port raises; where it reads, the port
    gives its bytes, in colour and in grey (a progressive file cut before
    its last scans smoothed as libjpeg-turbo smooths it). A cut inside a
    marker segment reads on fake EOI markers, as libjpeg-turbo's file
    source gives them."""
    img = smooth(16, 33, 47)
    if kind == "multiscan":
        data = encode_jpeg(img, 90, "420", 0, scans=MULTISCAN[0])
    else:
        data = encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      cv2.IMWRITE_JPEG_RST_INTERVAL, 2 if kind.endswith("restart") else 0)
    path = tmp_path / "cut.jpg"
    counts = {"equal": 0, "none": 0, "smoothed": 0}
    for n in cut_points(data):
        path.write_bytes(data[:n])
        for flag, grey in ((cv2.IMREAD_COLOR, False), (cv2.IMREAD_GRAYSCALE, True)):
            want = cv2.imread(str(path), flag)
            try:
                got = jpeg.read_jpeg(path, device="cpu", grey=grey)
            except FileNotFoundError:
                assert want is None, (n, grey)
                counts["none"] += 1
                continue
            np.testing.assert_array_equal(got, want, err_msg=f"cut at {n}, grey {grey}")
            counts["equal"] += 1
            counts["smoothed"] += jpeg.block_smoothing(jpeg.parse_header(data[:n]))
    assert counts["equal"] >= 50 and counts["none"] > 0, counts
    assert (counts["smoothed"] > 0) == (kind != "multiscan"), counts


@pytest.mark.parametrize("case", [c for c, _ in CASES if c.startswith(("progressive", "multi"))])
def test_progressive_and_multiscan_grey_equal_cv2(tmp_path, case):
    """The grey read (`IMREAD_GRAYSCALE`: the Y component alone) of every
    progressive and multi-scan file, numpy twin against `cv2`."""
    data = dict(CASES)[case]
    for i, d in enumerate(data if isinstance(data, list) else [data]):
        path = tmp_path / f"{case}_{i}.jpg"
        path.write_bytes(d)
        want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(jpeg.read_jpeg(path, device="cpu", grey=True), want)
        np.testing.assert_array_equal(_imread(str(path), "cpu", channels=1), want[..., None])


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
    with pytest.raises(ValueError, match="12-bit"):  # `cv2.imread` returns None
        jpeg.decode_jpeg(twelve_bit, "x.jpg", device="cpu")
    # a three-component file without its JFIF APP0, given an Adobe APP14 of
    # transform 2: YCbCr to libjpeg (after a warning), as `cv2` reads it
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    no_jfif = data[:2] + data[2 + 2 + 16:]
    (tmp_path / "adobe_2.jpg").write_bytes(no_jfif[:2] + adobe + no_jfif[2:])
    check_file(tmp_path / "adobe_2.jpg")
    two = data[:sof + 9] + b"\x02" + data[sof + 10:]
    with pytest.raises(ValueError, match="2-component"):  # `cv2.imread` returns None
        jpeg.decode_jpeg(two, "x.jpg", device="cpu")
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
    out = [(p.stem, p.read_bytes()) for p in FIXTURES] + FOUR_CASES
    for case, data in CASES:
        out += [(f"{case}_{i}", d) for i, d in enumerate(data if isinstance(data, list)
                                                         else [data])]
    full = encode(smooth(8, 100, 120), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    out += [(f"cut_{f}", full[:int(len(full) * f)]) for f in (0.3, 0.6)]
    prog = encode(smooth(9, 37, 53), cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2)  # smoothed when cut
    out += [(f"progressive_cut_{f}", prog[:int(len(prog) * f)]) for f in (0.15, 0.4, 0.7)]
    return out


@pytest.mark.parametrize("group", range(4))
def test_compiled_decoder_equals_numpy(compiled, group):
    files = all_files()
    for name, data in files[group::4]:
        for grey in (False, True):
            want = jpeg.decode_jpeg(data, name, device="cpu", grey=grey)
            got = jpeg.decode_jpeg(data, name, device="cuda", grey=grey)  # the compiled code
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=f"{name} grey {grey}")


def test_compiled_decoder_reports_bad_input(host_lib):
    """Status 2 for a Huffman table with more codes than its lengths hold,
    3 for a sampling ratio that is not integral, 1 for a bad component count,
    a progressive scan whose band is not legal, an arithmetic table number
    or conditioning out of range, or a lossless scan that is not one."""
    def run(frame, scan, huff, ncomp=1, cond=(0, 0, 0, 1, 5)):
        quant = np.ones((3, 64), np.int32)
        data = np.frombuffer(b"\x00\xff\xd9", np.uint8)
        out = np.empty((8, 8, 3), np.uint8)
        table = np.array([[0, 3, *scan, *cond * 4]], np.int32)
        assert table.shape[1] == jpeg.SCAN_FIELDS
        return host_lib.yp_jpeg_decode(*[a.ctypes.data_as(ctypes.c_void_p) for a in (
            data, frame, table)], 1, *[a.ctypes.data_as(ctypes.c_void_p) for a in (
                quant, huff)], 0, out.ctypes.data_as(ctypes.c_void_p))

    def frame(ncomp, color, progressive, *hv, arithmetic=0, lossless=0, precision=8):
        return np.array([8, 8, ncomp, color, progressive, arithmetic, lossless, precision, *hv],
                        np.int32)

    good = np.zeros((1, 4, 2, 272), np.uint8)
    good[..., 0] = 1  # one code of length 1, symbol 0
    bad = good.copy()
    bad[0, 0, 1, 0] = 3  # three codes of length 1
    grey = frame(1, jpeg.GREY, 0, 1, 1)
    one = [1, 0, 0, 0, 0, 0, 63, 0, 0, 0]  # one component (frame index 0), Ss..Se 0..63
    assert run(grey, one, good) == 0 and run(grey, one, bad) == 2
    fractional = frame(3, jpeg.YCC, 0, 3, 1, 2, 1, 1, 1)
    assert run(fractional, one, good) == 3
    assert run(frame(2, jpeg.YCC, 0, 1, 1, 1, 1), one, good) == 1
    progressive = frame(1, jpeg.GREY, 1, 1, 1)
    assert run(progressive, [1, 0, 0, 0, 0, 0, 0, 0, 0, 0], good) == 0  # a DC first scan
    assert run(progressive, [1, 0, 0, 0, 0, 0, 5, 0, 0, 0], good) == 1  # DC and AC in one
    arithmetic = frame(1, jpeg.GREY, 0, 1, 1, arithmetic=1)
    assert run(arithmetic, one, bad) == 0  # no Huffman table is read
    assert run(arithmetic, one, bad, cond=(16, 0, 0, 1, 5)) == 1  # table number 16
    assert run(arithmetic, one, bad, cond=(0, 0, 2, 1, 5)) == 1  # L above U
    lossless = frame(1, jpeg.GREY, 0, 1, 1, lossless=1)
    assert run(lossless, [1, 0, 0, 0, 0, 1, 0, 0, 0, 0], good) == 0  # predictor 1
    assert run(lossless, [1, 0, 0, 0, 0, 0, 0, 0, 0, 0], good) == 1  # predictor 0
    assert run(lossless, [1, 0, 0, 0, 0, 1, 0, 0, 8, 0], good) == 1  # Al of the precision


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


@pytest.mark.parametrize("kind", ["restart_1", "baseline"])
def test_cut_inside_a_huffman_code_as_cv2(tmp_path, kind):
    """Every cut point of a small file, a restart interval of one MCU and
    a baseline `cv2` file: where the data ends inside a Huffman code, the
    block it splits decodes to garbage whose samples pass +-512;
    libjpeg-turbo's SIMD IDCT (the one `cv2` runs) saturates them where its
    C range-limit table would wrap, and so does the port."""
    img = cv2.GaussianBlur(np.random.default_rng(0).integers(0, 256, (15, 17, 3))
                           .astype(np.uint8), (5, 5), 1.5)
    data = encode_jpeg(img, 90, "422", 1) if kind == "restart_1" else encode(img)
    path = tmp_path / "cut.jpg"
    read = 0
    for n in range(2, len(data)):
        path.write_bytes(data[:n])
        want = cv2.imread(str(path))
        if want is None:
            with pytest.raises(FileNotFoundError):
                jpeg.read_jpeg(path, device="cpu")
            continue
        np.testing.assert_array_equal(jpeg.read_jpeg(path, device="cpu"), want, err_msg=str(n))
        read += 1
    assert read > 100


@pytest.mark.parametrize("decoder", ["numpy", "compiled"])
def test_garbage_block_16bit_sums_as_cv2(tmp_path, decoder, request):
    """Quality 2 of uniform noise, cut at every byte: the garbage block a
    cut inside a Huffman code leaves has dequantized values whose sums pass
    16 bits in libjpeg-turbo's SIMD IDCT (`x0 + x4`, `x0 - x4`, `x7 + x3`,
    `x5 + x1` wrap in 16-bit lanes, and a block with no coefficient past its
    first row takes a 16-bit shift in place of the first pass); the port
    computes those sums as the SIMD code does and decodes as `cv2.imread`."""
    if decoder == "compiled":
        request.getfixturevalue("compiled")
    path = tmp_path / "cut.jpg"
    read = 0
    for H, W in ((24, 40), (16, 16), (33, 29)):
        img = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
        data = encode(img, cv2.IMWRITE_JPEG_QUALITY, 2)
        for n in range(2, len(data) + 1):
            path.write_bytes(data[:n])
            want = cv2.imread(str(path))
            if want is None:
                continue
            got = jpeg.read_jpeg(path, device="cpu" if decoder == "numpy" else "cuda")
            np.testing.assert_array_equal(got, want, err_msg=f"{H}x{W} cut at {n}")
            read += 1
    assert read > 100


def test_fixture_hashes():
    """The committed fixtures (`tests/data/`, written by
    `tools/make_image_fixtures.py`): `cv2.imread` still gives the recorded
    SHA-256 in colour and in grey, and so does the port's numpy decoder (the
    card holds the compiled one to the same hashes)."""
    import hashlib
    import json

    index = json.loads((REPO / "tests" / "data" / "jpeg_fixtures.json").read_text())
    assert len(index["files"]) >= 6
    for name, entry in index["files"].items():
        path = REPO / "tests" / "data" / name
        assert path.stat().st_size == entry["bytes"] <= 20_000
        for grey, key in ((False, "colour_sha256"), (True, "grey_sha256")):
            want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if grey else cv2.IMREAD_COLOR)
            assert hashlib.sha256(want.tobytes()).hexdigest() == entry[key], (name, key)
            got = jpeg.read_jpeg(path, device="cpu", grey=grey)
            assert hashlib.sha256(got.tobytes()).hexdigest() == entry[key], (name, key)
