"""The port's `_imread` (`yolopoint_tpu_torch/data/datasets.py`) against the
JAX package's, which is `cv2.imread` (OpenCV 5.0 built with libjpeg-turbo
3.1), bit for bit, in colour and in grey, on every kind of file that the
port reads since slice 21, and on the kinds `cv2.imread` returns None for:

* arithmetic-coded JPEG (SOF9 from `chip_smoke.encode_jpeg(arithmetic=True)`
  at every sampling layout and grey with restart intervals 0, 1 and 3 and
  under a DAC segment; a Huffman file's bytes read as SOF9; SOF10 from
  `chip_smoke.progressive_arith_jpeg` with DC and AC refinement, restarts
  and cut scans) and lossless JPEG (SOF3 from `chip_smoke.encode_lossless`:
  grey at predictors 1-7 and point transforms 0 and 2, with restarts, at 4
  bits; RGB subsampled and in one scan a component; CMYK; a Huffman file's
  bytes read as lossless differences): `chip_smoke.jpeg_kind_cases`, and
  more layouts of lossless colour files, the files the card's `jpeg`
  phase holds the compiled decoders to numpy on (held here too, the host
  code built with g++);
* JPEG kinds that `cv2.imread` returns None for (hierarchical, lossless
  arithmetic, precisions other than 8, two components, lossless files in
  the read libjpeg-turbo cannot convert, bad lossless scans and DAC
  segments): `FileNotFoundError`;
* BMP at 1 and 4 bits (info and core headers), 16 bits (5-5-5 of `BI_RGB`
  and of `BI_BITFIELDS`, 5-6-5) and 32 bits with masks OpenCV ignores, and
  the depths, compressions and masks it refuses;
* PBM / PGM / PPM (`P1`-`P6`) at maxval 1, 100, 255, 256, 1000 and 65535,
  with comments, and malformed headers;
* the formats `cv2.imread` reads here that the port does not
  (`datasets.UNPORTED_SIGNATURES`: WebP, JPEG 2000, AVIF) and the TIFF
  layouts it reads and the port does not (CCITT Group 3 and 4 and RLEW,
  SGILog, CIELab): `NotImplementedError`; other first bytes:
  `FileNotFoundError`;
* a PNG of a bad deflate stream or IHDR: `FileNotFoundError`; a reader's
  own `ValueError` (not `errors.Unreadable`) and the compiled decoders'
  bad-parameter status (`RuntimeError`) leave `_imread` as they are.

Then the JAX demo's `iter_frames` against the port's on a directory of
`chip_smoke.image_kind_files` (the same stems served and skipped, the
served frames equal; the lists the card's `demo_kinds` phase checks; since
slice 22 with TIFF, GIF, Sun raster, PAM, PFM and Radiance files among
them), the port raising where the directory holds a format it does not
read (a WebP file); and the JAX ROS node's `_load_templates` against the
port's."""

from __future__ import annotations

import ctypes
import importlib
import shutil
import struct
import subprocess
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import (IMAGE_KINDS_SERVED, IMAGE_KINDS_SKIPPED, encode_bmp, encode_jpeg,
                        encode_lossless, encode_netpbm, image_kind_files, jpeg_kind_cases,
                        patch_jpeg, smooth_frame, two_component_jpeg)
from yolopoint_tpu.data.datasets import _imread as jax_imread
from yolopoint_tpu_torch.data import jpeg, png
from yolopoint_tpu_torch.data.datasets import UNPORTED_SIGNATURES, _imread
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KIND_CASES = jpeg_kind_cases(0)


def same_as_cv2(path: Path) -> None:
    """The port's `_imread` of `path` in colour and in grey equals the JAX
    package's, or both raise `FileNotFoundError` (`cv2.imread` returned
    None)."""
    for channels in (3, 1):
        try:
            want = jax_imread(str(path), channels)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError, match=path.name):
                _imread(str(path), "cpu", channels)
            continue
        got = _imread(str(path), "cpu", channels)
        assert got.shape == want.shape and got.dtype == want.dtype, (path.name, channels)
        np.testing.assert_array_equal(got, want, err_msg=f"{path.name} channels={channels}")


def write(tmp_path: Path, name: str, data: bytes) -> Path:
    path = tmp_path / name
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("case", range(len(KIND_CASES)), ids=[c[0] for c in KIND_CASES])
def test_jpeg_kinds_equal_cv2(tmp_path, case):
    name, data, src = KIND_CASES[case]
    path = write(tmp_path, f"{name}.jpg", data)
    same_as_cv2(path)
    if src is not None and jpeg.parse_header(data).lossless:  # the samples, exactly
        al = jpeg.parse_header(data).scans[0].al
        got = _imread(str(path), "cpu", 1 if src.ndim == 2 else 3)
        np.testing.assert_array_equal(got.reshape(src.shape), (src >> al) << al)


def test_arithmetic_file_equals_huffman_file():
    """`encode_jpeg`'s arithmetic-coded file carries the same coefficients
    as its Huffman-coded one: `cv2` and the port decode both to one image."""
    img = smooth_frame(np.random.default_rng(11), 40, 56)
    for sampling in ("420", "444"):
        arith = encode_jpeg(img, 90, sampling, 2, arithmetic=True)
        huff = encode_jpeg(img, 90, sampling, 2)
        want = cv2.imdecode(np.frombuffer(huff, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(arith, np.uint8),
                                                   cv2.IMREAD_COLOR), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(arith, device="cpu"), want)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled decoders are checked on the card")
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


def test_compiled_jpeg_kinds_equal_numpy(host_lib, monkeypatch):
    """`yp_jpeg_decode`'s arithmetic and lossless branches (what a GPU run
    reads with) bit-equal to the numpy twins on every kind file, in both
    reads; both refuse the reads of a lossless file that libjpeg-turbo
    refuses."""
    monkeypatch.setattr(_build, "library", lambda: host_lib)
    for name, data, _ in KIND_CASES:
        for grey in (False, True):
            try:
                want = jpeg.decode_jpeg(data, name, device="cpu", grey=grey)
            except ValueError:
                with pytest.raises(ValueError):
                    jpeg.decode_jpeg(data, name, device="cuda", grey=grey)
                continue
            np.testing.assert_array_equal(jpeg.decode_jpeg(data, name, device="cuda", grey=grey),
                                          want, err_msg=f"{name} grey={grey}")


def _no_jfif(data: bytes) -> bytes:
    head, rest = chip_smoke._jpeg_segments(data)
    return b"\xff\xd8" + b"".join(chip_smoke._jpeg_segment(m, b) for m, b in head
                                  if m != 0xE0) + rest


def _none_kinds() -> dict:
    """JPEG files of kinds `cv2.imread` returns None for in both reads."""
    rng = np.random.default_rng(21)
    img = smooth_frame(rng, 21, 30)
    base, grey = encode_jpeg(img, 90, "420"), encode_jpeg(img[..., 0], 90)
    kinds = {f"sof{m - 0xC0}": patch_jpeg(base, m) for m in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE,
                                                            0xCF)}
    for sof, name in ((0xC0, "baseline"), (0xC1, "extended"), (0xC9, "arithmetic")):
        kinds[f"{name}_12bit"] = patch_jpeg(base, sof, precision=12)
    kinds["lossless_16bit"] = patch_jpeg(grey, 0xC3, 1, 0, 0, precision=16)
    kinds["lossless_1bit"] = patch_jpeg(grey, 0xC3, 1, 0, 0, precision=1)
    kinds["two_components"] = two_component_jpeg(img)
    kinds["lossless_ycbcr"] = patch_jpeg(base, 0xC3, 1, 0, 0)  # JFIF: YCbCr
    kinds["lossless_adobe_1"] = patch_jpeg(encode_jpeg(img, 90, "444", adobe=1), 0xC3, 1, 0, 0)
    kinds["lossless_ycck"] = patch_jpeg(
        encode_jpeg(np.concatenate([img, img[..., :1]], 2), 90, "444", adobe=2), 0xC3, 1, 0, 0)
    for ss, se, al in ((0, 0, 0), (8, 0, 0), (1, 63, 0), (1, 0, 8)):
        kinds[f"lossless_scan_{ss}_{se}_{al}"] = patch_jpeg(grey, 0xC3, ss, se, al)
    kinds["lossless_ah"] = patch_jpeg(grey, 0xC3, 1, 0, 0x10)
    kinds["lossless_restart_3"] = patch_jpeg(encode_jpeg(img[..., 0], 90, "420", 3), 0xC3,
                                             1, 0, 0)
    kinds["dac_index_40"] = patch_jpeg(base, 0xC9, dac=bytes([40, 0x11]))
    kinds["dac_l_above_u"] = patch_jpeg(base, 0xC9, dac=bytes([0, 0x12]))
    return kinds


NONE_KINDS = _none_kinds()


@pytest.mark.parametrize("kind", sorted(NONE_KINDS))
def test_jpeg_none_kinds_raise_file_not_found(tmp_path, kind):
    path = write(tmp_path, f"{kind}.jpg", NONE_KINDS[kind])
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        assert cv2.imread(str(path), flag) is None
    for channels in (3, 1):
        with pytest.raises(FileNotFoundError, match=f"{kind}.jpg"):
            _imread(str(path), "cpu", channels)


LOSSLESS_LAYOUTS = [(sampling, scans) for sampling in ("444", "422", "420", "440", "411")
                    for scans in (None, ((0,), (1,), (2,)), ((0,), (1, 2)))]


@pytest.mark.parametrize("sampling, scans", LOSSLESS_LAYOUTS,
                         ids=[f"{s}_{len(g or [0])}scans" for s, g in LOSSLESS_LAYOUTS])
def test_lossless_colour_kinds(tmp_path, sampling, scans):
    """Lossless colour files as `cv2.imread` reads them (libjpeg-turbo
    converts no colour in lossless mode): RGB (component IDs 1, 2, 3 without
    JFIF, or 'R', 'G', 'B', or an Adobe transform of 0) in colour only,
    upsampled by replication, in one interleaved scan, one scan a component
    or Y then the others, with restarts; CMYK in both reads; the grey read
    of an RGB one, and YCbCr (JFIF, Adobe transform 1) and YCCK ones, None."""
    rng = np.random.default_rng(len(sampling) + len(scans or ()))
    img = smooth_frame(rng, 21, 30)
    for predictor in (1, 4, 6):
        rgb = encode_lossless(img, predictor, predictor % 3, 0 if scans else 2, 8, sampling,
                              scans and list(scans))
        path = write(tmp_path, "rgb.jpg", rgb)
        same_as_cv2(path)
        assert cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) is None
        if sampling == "444":
            al = predictor % 3
            np.testing.assert_array_equal(_imread(str(path), "cpu"), (img >> al) << al)
    head, rest = chip_smoke._jpeg_segments(encode_lossless(img, 7, 0, 0, 8, sampling, scans))
    for name, extra, ids in (("rgb_ids.jpg", b"", b"RGB"), ("adobe_0.jpg", b"\x00", b"\x01\x02\x03"),
                             ("adobe_1.jpg", b"\x01", b"\x01\x02\x03"),
                             ("jfif.jpg", None, b"\x01\x02\x03")):
        out = bytearray(b"\xff\xd8")
        if extra is None:
            out += chip_smoke._jpeg_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
        elif extra:
            out += chip_smoke._jpeg_segment(0xEE, b"Adobe\0\x64\0\0\0\0" + extra)
        for marker, body in head:
            if marker == 0xC3:
                body = body[:6] + b"".join(bytes([ids[c]]) + body[7 + 3 * c:9 + 3 * c]
                                           for c in range(3))
            out += chip_smoke._jpeg_segment(marker, body)
        tail = bytearray(rest)  # the scans name the components by their new IDs
        pos = 0
        while (pos := tail.find(b"\xff\xda", pos)) >= 0:
            n = tail[pos + 4]
            for k in range(n):
                tail[pos + 5 + 2 * k] = ids[tail[pos + 5 + 2 * k] - 1]
            pos += 2
        same_as_cv2(write(tmp_path, name, bytes(out + tail)))
    cmyk = np.concatenate([img, img[..., :1]], 2)
    for adobe in (None, 0, 2):
        data = encode_lossless(cmyk, 5, 1, 0, 8, sampling, None)
        if adobe is not None:  # Adobe APP14 after SOI: transform 0 CMYK, 2 YCCK (None)
            data = data[:2] + chip_smoke._jpeg_segment(
                0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe])) + data[2:]
        same_as_cv2(write(tmp_path, f"cmyk_{adobe}.jpg", data))


def test_lossless_without_quantization_table(tmp_path):
    """A lossless file needs no DQT segment (libjpeg latches none)."""
    data = encode_lossless(smooth_frame(np.random.default_rng(23), 17, 19)[..., 0], 7, 1)
    head, rest = chip_smoke._jpeg_segments(data)
    data = b"\xff\xd8" + b"".join(chip_smoke._jpeg_segment(m, b) for m, b in head
                                  if m != 0xDB) + rest
    same_as_cv2(write(tmp_path, "no_dqt.jpg", data))


BMP_KINDS = {
    "1bit": dict(bpp=1), "1bit_core": dict(bpp=1, core=True), "4bit": dict(bpp=4),
    "4bit_core": dict(bpp=4, core=True), "16bit_rgb_555": dict(bpp=16),
    "16bit_bitfields_555": dict(bpp=16, masks=(0x7C00, 0x03E0, 0x001F)),
    "16bit_bitfields_565": dict(bpp=16, masks=(0xF800, 0x07E0, 0x001F)),
    "32bit_masks_swapped": dict(bpp=32, masks=(0x000000FF, 0x0000FF00, 0x00FF0000)),
    "32bit_masks_high": dict(bpp=32, masks=(0xFF000000, 0x00FF0000, 0x0000FF00)),
    "16bit_masks_444": dict(bpp=16, masks=(0x0F00, 0x00F0, 0x000F)),
    "24bit_bitfields": dict(bpp=24, compression=3),
    "24bit_png_compressed": dict(bpp=24, compression=5),
    "16bit_rle8": dict(bpp=16, compression=1),
}


@pytest.mark.parametrize("kind", sorted(BMP_KINDS))
def test_bmp_kinds_equal_cv2(tmp_path, kind):
    rng = np.random.default_rng(31)
    for H, W in ((1, 1), (7, 13), (24, 33)):
        same_as_cv2(write(tmp_path, f"{kind}.bmp", encode_bmp(smooth_frame(rng, H, W),
                                                              **BMP_KINDS[kind])))
        # a noisy image: every palette entry and 16-bit code
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        same_as_cv2(write(tmp_path, f"{kind}_noise.bmp", encode_bmp(img, **BMP_KINDS[kind])))


NETPBM_KINDS = [(kind, maxval) for kind in (2, 3, 5, 6) for maxval in (1, 100, 255, 256, 65535)
                if not (kind in (5, 6) and maxval == 255)] + [(1, 1), (4, 1)]


@pytest.mark.parametrize("kind, maxval", NETPBM_KINDS,
                         ids=[f"P{k}_{m}" for k, m in NETPBM_KINDS])
def test_netpbm_kinds_equal_cv2(tmp_path, kind, maxval):
    """A file of each kind and maxval (ASCII samples above the maxval too,
    binary ones of every value), with and without header comments."""
    rng = np.random.default_rng(kind * 7 + maxval)
    for H, W in ((1, 1), (9, 14)):
        img = smooth_frame(rng, H, W)
        for comment in (False, True):
            same_as_cv2(write(tmp_path, f"p{kind}.ppm", encode_netpbm(img, kind, maxval,
                                                                      comment)))
        channels = 3 if kind in (3, 6) else 1
        head = b"P%d %d %d" % (kind, W, H) + (b"" if kind in (1, 4) else b" %d" % maxval)
        if kind in (2, 3):  # samples up to 1.2x the maxval: clamped
            vals = rng.integers(0, int(maxval * 1.2) + 2, H * W * channels)
            data = head + b"\n" + b"\t".join(b"%d" % v for v in vals) + b"\r\n"
        elif kind in (5, 6):
            data = head + b"\n" + rng.integers(0, 256, H * W * channels * (
                2 if maxval > 255 else 1)).astype(np.uint8).tobytes()
        elif kind == 1:
            data = head + b"\n" + b"".join(b"%d" % v for v in rng.integers(0, 2, H * W))
        else:
            data = head + b"\n" + rng.integers(0, 256, H * ((W + 7) // 8)).astype(
                np.uint8).tobytes()
        same_as_cv2(write(tmp_path, f"p{kind}_raw.ppm", data))


NETPBM_EDGES = {
    "comment_after_magic": b"P6#c\n2 1\n255\n" + bytes(6),
    "comment_after_number": b"P6 2#x\n 1 255\n" + bytes(6),
    "comment_between": b"P3 2 #x\n 1 255\n 1 2 3 #y\n 4 5 6\n",
    "tabs": b"P2\t2\t1\t255\t7\t8\t",
    "leading_zeros": b"P5 1 1 00100 \x07",
    "letter_after_number": b"P2 2 1 255\n12a 5 ",
    "ascii_ends_in_number": b"P2 1 1 255\n 7",
    "bits_end_after_digit": b"P1 3 1\n101",
    "maxval_0": b"P6 2 1 0\n" + bytes(6),
    "maxval_65536": b"P6 2 1 65536\n" + bytes(12),
    "width_0": b"P6 0 2 255\n",
    "short_binary": b"P6 4 2 255\n" + bytes(20),
    "short_ascii": b"P3 2 1 255\n0 50 100 101\n",
    "bad_byte": b"P2 2 1 255\n 1 x\n",
    "maxval_end_byte_eats_pixel": b"P5 2 1 255" + bytes([7, 8]),
    "p2_maxval_1": b"P2 4 1 1\n 0 1 2 1\n",
    "p5_maxval_1": b"P5 4 1 1\n" + bytes([0, 1, 2, 1]),
}


@pytest.mark.parametrize("edge", sorted(NETPBM_EDGES))
def test_netpbm_headers_equal_cv2(tmp_path, edge):
    same_as_cv2(write(tmp_path, f"{edge}.ppm", NETPBM_EDGES[edge]))


def _unported_files() -> dict:
    import io

    from PIL import Image

    from chip_smoke import encode_tiff

    img = smooth_frame(np.random.default_rng(41), 48, 64)
    out = {}
    for ext in (".webp", ".jp2", ".avif"):
        ok, buf = cv2.imencode(ext, img)
        assert ok, ext
        out[ext[1:]] = buf.tobytes()
    jp2 = out["jp2"]
    out["j2k"] = jp2[jp2.index(b"jp2c") + 4:]  # the bare codestream
    # TIFF layouts that OpenCV's libtiff reads and the port does not
    for group in ("group3", "group4"):
        buf = io.BytesIO()
        Image.fromarray(img[..., 1] > 127).save(buf, "TIFF", compression=group)
        out[f"tiff_ccitt_{group}"] = buf.getvalue()
    out["tiff_ccitt_rlew"] = encode_tiff(img[..., 1:2] > 127, 0, bits=1, compression=32771)
    wide = img[..., ::-1].astype(np.int64) * 257
    out["tiff_sgilog_luv"] = encode_tiff(wide, 32845, bits=16, compression=34676)
    out["tiff_sgilog_l"] = encode_tiff(wide[..., 1:2], 32844, bits=16, compression=34676)
    out["tiff_cielab"] = encode_tiff(img[..., ::-1], 8)
    return out


UNPORTED = _unported_files()
# the format (and for TIFF the layout) each file's `NotImplementedError` names
UNPORTED_KIND = {"webp": "WebP", "jp2": "JPEG 2000", "j2k": "JPEG 2000", "avif": "AVIF",
                 "tiff_ccitt_group3": "TIFF of CCITT Group 3",
                 "tiff_ccitt_group4": "TIFF of CCITT Group 4",
                 "tiff_ccitt_rlew": "TIFF of CCITT RLEW", "tiff_sgilog_luv": "TIFF of SGILog",
                 "tiff_sgilog_l": "TIFF of SGILog", "tiff_cielab": "TIFF of CIELab"}


@pytest.mark.parametrize("fmt", sorted(UNPORTED))
def test_unported_formats_raise_not_implemented(tmp_path, fmt):
    """Files `cv2.imread` reads here (under a demo suffix: the decoder is
    picked by the first bytes) that the port does not read raise naming the
    format (a TIFF file: the layout), in both reads; never a skip."""
    path = write(tmp_path, f"{fmt}_file.png", UNPORTED[fmt])
    assert cv2.imread(str(path)) is not None
    if not fmt.startswith("tiff"):
        assert any(kind == UNPORTED_KIND[fmt] for kind, _ in UNPORTED_SIGNATURES)
    for channels in (3, 1):
        with pytest.raises(NotImplementedError, match=f"{fmt}_file.png: {UNPORTED_KIND[fmt]}"):
            _imread(str(path), "cpu", channels)


def test_unknown_signatures_raise_file_not_found(tmp_path):
    """First bytes no decoder of `cv2.imread` takes here (an OpenEXR file:
    no OpenEXR in this OpenCV; text; nothing; a PNG signature one byte off;
    `FF D8` without the third `FF`): None there, `FileNotFoundError` here."""
    for name, data in (("exr.ppm", b"\x76\x2f\x31\x01" + bytes(60)),
                       ("text.png", b"not an image\n"), ("empty.bmp", b""),
                       ("png_off.png", b"\x89PNG\r\n\x1a\x0b" + bytes(60)),
                       ("soi_only.jpg", b"\xff\xd8\x00\xff\xd9")):
        path = write(tmp_path, name, data)
        assert cv2.imread(str(path)) is None
        for channels in (3, 1):
            with pytest.raises(FileNotFoundError, match=name):
                _imread(str(path), "cpu", channels)


def _kinds_dir(root: Path) -> Path:
    root.mkdir()
    for name, data in image_kind_files(0, 48, 64).items():
        (root / name).write_bytes(data)
    return root


def test_iter_frames_equals_jax(tmp_path):
    """The demo's frames of a directory of every kind: the port serves the
    stems the JAX demo serves, with equal frames, and skips the rest; both
    lists are the ones the card's `demo_kinds` phase checks."""
    from yolopoint_tpu.frontend.demo import iter_frames as jax_iter_frames
    from yolopoint_tpu_torch.frontend.demo import iter_frames

    frames = _kinds_dir(tmp_path / "frames")
    want = list(jax_iter_frames(str(frames)))
    got = list(iter_frames(str(frames), "cpu"))
    assert [s for s, _ in got] == [s for s, _ in want] == list(IMAGE_KINDS_SERVED)
    for (stem, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=stem)
    skipped = sorted({p.stem for p in frames.iterdir()} - set(IMAGE_KINDS_SERVED))
    assert skipped == list(IMAGE_KINDS_SKIPPED)


def test_iter_frames_raises_on_unported_format(tmp_path):
    """A WebP file under a `.png` name: the JAX demo shows it, the port's
    raises naming it instead of skipping it."""
    from yolopoint_tpu.frontend.demo import iter_frames as jax_iter_frames
    from yolopoint_tpu_torch.frontend.demo import iter_frames

    frames = _kinds_dir(tmp_path / "frames")
    (frames / "zz_webp.png").write_bytes(UNPORTED["webp"])
    assert [s for s, _ in jax_iter_frames(str(frames))][-1] == "zz_webp"
    with pytest.raises(NotImplementedError, match="zz_webp.png: WebP"):
        list(iter_frames(str(frames), "cpu"))


def test_ros_templates_equal_jax(tmp_path):
    """The ROS node's templates (grey reads) from the kinds of the card's
    `ros` phase and more: the port loads the templates the JAX node loads,
    with equal eroded masks, and skips the same ones; a WebP template
    raises."""
    from yolopoint_tpu.deploy.ros_node import YoloPointRosNode as JaxNode
    from yolopoint_tpu_torch.deploy.ros_node import YoloPointRosNode as PortNode

    frames = _kinds_dir(tmp_path / "frames")
    paths = {Path(n).stem: str(frames / n) for n in sorted(p.name for p in frames.iterdir())}
    paths["missing"] = str(frames / "missing.png")
    assert set(chip_smoke.ROS_TEMPLATE_KINDS.values()) <= {Path(p).name for p in paths.values()}
    jax_node, port_node = JaxNode.__new__(JaxNode), PortNode.__new__(PortNode)
    jax_node.templates, port_node.templates = {}, {}
    port_node.device = torch.device("cpu")
    jax_node._load_templates(paths)
    port_node._load_templates(paths)
    assert "lossless_grey" in port_node.templates and "lossless_ycc" not in port_node.templates
    assert set(port_node.templates) == set(jax_node.templates)
    for key, mask in port_node.templates.items():
        np.testing.assert_array_equal(mask > 0, jax_node.templates[key] > 0, err_msg=key)
    webp = write(tmp_path, "tpl.png", UNPORTED["webp"])
    with pytest.raises(NotImplementedError, match="tpl.png: WebP"):
        port_node._load_templates({"cam9": str(webp)})


def _png_chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append((kind, data[pos + 8:pos + 8 + n]))
        pos += 12 + n
    return out


def _png_file(chunks) -> bytes:
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))
        for kind, body in chunks)


def test_png_bad_stream_raises_file_not_found(tmp_path):
    """A PNG whose IDAT is no deflate stream, or whose IHDR is not 13 bytes,
    each chunk's CRC right: None in `cv2.imread`, `FileNotFoundError` here
    (not `zlib.error` or `struct.error`)."""
    chunks = _png_chunks(png.encode_png(smooth_frame(np.random.default_rng(3), 16, 16)))
    bad_idat = [(k, b"\x78\x01\x07" + bytes(20) if k == b"IDAT" else b) for k, b in chunks]
    long_ihdr = [(k, b + b"\0" if k == b"IHDR" else b) for k, b in chunks]
    for name, file_chunks in (("bad_idat.png", bad_idat), ("long_ihdr.png", long_ihdr)):
        path = write(tmp_path, name, _png_file(file_chunks))
        assert cv2.imread(str(path)) is None
        same_as_cv2(path)


def _reader_fault(*args, **kwargs):
    raise ValueError("cannot reshape array of size 3 into shape (2,)")


READER_FAULTS = {  # a file of each reader, and a function inside the reader
    "jpeg": ("f.jpg", "yolopoint_tpu_torch.data.jpeg", "decode_numpy",
             lambda img, rng: encode_jpeg(img, 90)),
    "png": ("f.png", "yolopoint_tpu_torch.data.png", "unfilter_numpy",
            lambda img, rng: png.encode_png(img)),
    "bmp": ("f.bmp", "yolopoint_tpu_torch.data.bmp", "rle_numpy",
            lambda img, rng: chip_smoke.encode_bmp_rle(rng, 16, 12)),
    "netpbm": ("f.ppm", "yolopoint_tpu_torch.data.netpbm", "_ascii",
               lambda img, rng: encode_netpbm(img, 3)),
}


@pytest.mark.parametrize("reader", sorted(READER_FAULTS))
def test_reader_fault_is_not_skipped(tmp_path, monkeypatch, reader):
    """A `ValueError` that is a fault of a reader (numpy's, say), not of the
    file, leaves `_imread` as it is: only the readers' `Unreadable` (what
    `cv2.imread` returns None for) becomes `FileNotFoundError`, so the demo
    stops on the file instead of skipping one that `cv2` reads."""
    from yolopoint_tpu_torch.frontend.demo import iter_frames

    name, module, fn, make = READER_FAULTS[reader]
    rng = np.random.default_rng(4)
    path = write(tmp_path, name, make(smooth_frame(rng, 12, 16), rng))
    _imread(str(path), "cpu")  # the file reads
    monkeypatch.setattr(importlib.import_module(module), fn, _reader_fault)
    for channels in (3, 1):
        with pytest.raises(ValueError, match="cannot reshape"):
            _imread(str(path), "cpu", channels)
    with pytest.raises(ValueError, match="cannot reshape"):
        list(iter_frames(str(tmp_path), "cpu"))


def test_compiled_bad_parameters_raise_runtime_error(host_lib, monkeypatch):
    """Status 1 of `yp_jpeg_decode` and `yp_bmp_rle`, which only a caller's
    fault produces (the file was checked before), is a `RuntimeError`, never
    the error of an unreadable file that the skip sites take."""
    from yolopoint_tpu_torch.data import bmp

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    hdr = jpeg.parse_header(encode_jpeg(smooth_frame(np.random.default_rng(6), 16, 16), 90))
    inputs = jpeg.compiled_inputs

    def two_components(h):
        frame, *rest = inputs(h)
        frame = frame.copy()
        frame[2] = 2  # the component count, which the parse refuses
        return (frame, *rest)

    monkeypatch.setattr(jpeg, "compiled_inputs", two_components)
    with pytest.raises(RuntimeError, match="bad parameters"):
        jpeg.decode_compiled(hdr)
    with pytest.raises(RuntimeError, match="bad parameters"):
        bmp.rle_compiled(b"\0\1", 5, 4, 4, True, np.zeros((256, 3), np.uint8))
