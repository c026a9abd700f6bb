"""The port's `_imread` (`yolopoint_tpu_torch/data/datasets.py`) against the
JAX package's, which is `cv2.imread` (OpenCV 5.0 with libtiff 4.7.1), bit
for bit, in colour and in grey, on the six formats slice 22 reads:

* TIFF (`data/tiff.py`): files of Pillow (every mode it writes, none, LZW,
  Deflate, PackBits and JPEG with `JPEGTables`) and of
  `chip_smoke.encode_tiff` (BigTIFF, both byte orders, strips and tiles,
  separate planes, the predictor, 1- to 16-bit samples, palettes of 8- and
  16-bit maps, min-is-white, unassociated alpha, CMYK, YCbCr at every
  subsampling and with its coefficient and reference tags, JPEG strips
  and tiles, the orientations), the traps of libtiff's RGBA interface
  (16-bit colour rounded by 257, unassociated alpha premultiplied, 16-bit
  grey's high byte, the 4x4 YCbCr block's short read and skew, the clipped
  tile rows of 16-bit grey), damaged strips read as zeros, and the files
  `cv2` returns None for (float and 32-bit samples, LZMA and ZSTD, 2-bit
  samples, five samples, orientation 5-8 of a non-square image, a cut
  file);
* GIF (`data/gif.py`): Pillow's and `cv2.imencode`'s files and
  `chip_smoke.encode_gif`'s (global and local tables, interlacing, the
  transparent index, a frame smaller than the screen, code sizes 2 to 11,
  clear codes, a full table without a clear), and the malformed ones;
* Sun raster (`data/sunras.py`), PAM (`data/pam.py`), PFM (`data/pfm.py`)
  and Radiance HDR (`data/radiance.py`): `cv2.imencode`'s files, this
  repository's writers' at every layout, the header rules found by sweeps,
  and malformed files.

Where `cv2.imread` returns None the port raises `FileNotFoundError`. The
compiled decoders (`yp_tiff_lzw`, `yp_packbits`, `yp_gif_lzw`,
`yp_hdr_rgbe` in `ops/csrc/host_image.cpp`, built here with g++) are held
equal to their numpy twins on every file, damaged streams included; and
`chip_smoke.image_format_files`, the files the card's `image_formats`
phase checks, are read by `cv2` as the port reads them."""

from __future__ import annotations

import ctypes
import io
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import (encode_gif, encode_pam, encode_pfm, encode_radiance, encode_sunras,
                        encode_tiff, image_format_files, smooth_frame)
from yolopoint_tpu.data.datasets import _imread as jax_imread
from yolopoint_tpu_torch.data import gif, pam
from yolopoint_tpu_torch.data.datasets import UNPORTED_SIGNATURES, _imread
from yolopoint_tpu_torch.data.errors import Unreadable
from yolopoint_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(2722)
IMG = smooth_frame(RNG, 37, 53)  # BGR
RGB = IMG[..., ::-1]
WIDE = RGB.astype(np.int64) * 257 + RNG.integers(0, 257, RGB.shape)
ALPHA = RNG.integers(0, 256, IMG.shape[:2] + (1,))


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


def cv2_encoded(ext: str, img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(ext, img)
    assert ok, ext
    return buf.tobytes()


def pillow(img: Image.Image, fmt: str, **kwargs) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kwargs)
    return buf.getvalue()


def cut(data: bytes, n: int) -> bytes:
    return data[:len(data) - n]


# --- Sun raster -------------------------------------------------------------------


def _sunras_cases() -> dict:
    out = {f"depth_{d}": encode_sunras(IMG, d) for d in (1, 8, 24, 32)}
    out.update({
        "depth_1_map": encode_sunras(IMG, 1, colormap=True),
        "depth_8_map": encode_sunras(IMG, 8, colormap=True),
        "old_24": encode_sunras(IMG, 24, kind=0),
        "old_8": encode_sunras(IMG, 8, kind=0),
        "odd_width_8": encode_sunras(IMG[:, :7], 8),
        "cv2_colour": cv2_encoded(".ras", IMG),
        "cv2_grey": cv2_encoded(".ras", IMG[..., 1]),
        # cv2 returns None: OpenCV tests its image type where it means the file's
        "byte_encoded": encode_sunras(IMG, 8, kind=2),
        "rgb_type": encode_sunras(IMG, 24, kind=3),
        "truncated": cut(encode_sunras(IMG, 24), 1),
        "header_only": encode_sunras(IMG, 24)[:20],
    })
    head = bytearray(encode_sunras(IMG, 8, colormap=True))
    head[24:28] = struct.pack(">I", 2)  # a raw colour map
    out["map_type_raw"] = bytes(head)
    head = bytearray(encode_sunras(IMG, 24))
    head[12:16] = struct.pack(">I", 16)
    out["depth_16"] = bytes(head)
    head = bytearray(encode_sunras(IMG, 1, colormap=True))
    head[28:32] = struct.pack(">I", 9)  # three entries for a 1-bit image
    out["map_too_long"] = bytes(head)
    return out


SUNRAS = _sunras_cases()


@pytest.mark.parametrize("case", sorted(SUNRAS))
def test_sunras_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.ras"
    path.write_bytes(SUNRAS[case])
    same_as_cv2(path)


# --- PAM ------------------------------------------------------------------------------


def _pam(head: bytes, samples: bytes) -> bytes:
    return b"P7\n" + head + samples


def _pam_cases() -> dict:
    grey = IMG[..., 1].tobytes()
    hdr = b"WIDTH 53\nHEIGHT 37\nDEPTH 1\nMAXVAL 255\n"
    out = {f"rgb_{m}": encode_pam(IMG, "RGB", m) for m in (2, 100, 255, 256, 1000, 65535)}
    out.update({f"grey_{m}": encode_pam(IMG, "GRAYSCALE", m) for m in (255, 65535)})
    out.update({
        "black_and_white": encode_pam(IMG, "BLACKANDWHITE"),
        "cv2_rgb8": cv2_encoded(".pam", IMG),
        "cv2_grey8": cv2_encoded(".pam", IMG[..., 1]),
        # no TUPLTYPE at 16 bits and depth 3: None (the file cv2.imencode writes)
        "cv2_rgb16": cv2_encoded(".pam", WIDE[..., ::-1].astype(np.uint16)),
        "cv2_bgra": cv2_encoded(".pam", np.concatenate([IMG, IMG[..., :1]], 2)),
        # maxval 1 reads packed bits, one a pixel, whatever the depth
        "rgb_maxval_1": _pam(b"WIDTH 53\nHEIGHT 37\nDEPTH 3\nMAXVAL 1\nENDHDR\n",
                             RNG.integers(0, 256, 53 * 37 * 3, np.uint8).tobytes()),
        "grey_alpha_w1": encode_pam(IMG[:, :1], "GRAYSCALE_ALPHA"),
        "rgb_alpha_w1": encode_pam(IMG[:, :1], "RGB_ALPHA", 1000),
        "comments_cr": b"P7\r# written by hand\rWIDTH 53\r\rHEIGHT 37 \rDEPTH   1\rMAXVAL 255\r"
                       b"ENDHDR\r" + grey,
        "crlf_shifts_the_samples": b"P7\r\nWIDTH 53\r\nHEIGHT 37\r\nDEPTH 1\r\nMAXVAL 255\r\n"
                                   b"ENDHDR\r\n" + grey,
        "endhdr_value": _pam(hdr + b"ENDHDR  \n", grey + b"\n" * 40),
        "value_on_next_line": _pam(b"WIDTH \n53\nHEIGHT 37\nDEPTH 1\nMAXVAL 255\nENDHDR\n", grey),
        "empty_tupltype": _pam(hdr + b"TUPLTYPE\nENDHDR\n", grey),
        "last_tupltype": _pam(hdr + b"TUPLTYPE RGB\nTUPLTYPE GRAYSCALE  \nENDHDR\n", grey),
        "leading_zeros": _pam(b"WIDTH 0053\nHEIGHT 37\nDEPTH 1\nMAXVAL 0\nENDHDR\n", grey),
        "duplicate_width": _pam(b"WIDTH 53\n" + hdr + b"ENDHDR\n", grey),
        "no_maxval": _pam(b"WIDTH 53\nHEIGHT 37\nDEPTH 1\nENDHDR\n", grey),
        "unknown_tupltype": _pam(hdr + b"TUPLTYPE GREY\nENDHDR\n", grey),
        "maxval_70000": _pam(hdr.replace(b"255", b"70000") + b"ENDHDR\n", grey * 2),
        "depth_mismatch": _pam(hdr + b"TUPLTYPE RGB\nENDHDR\n", grey * 3),
        "plus_sign": _pam(hdr.replace(b"53", b"+53") + b"ENDHDR\n", grey),
        "trailing_text": _pam(hdr.replace(b"53", b"53 px") + b"ENDHDR\n", grey),
        "space_after_p7": b"P7 " + hdr + b"ENDHDR\n" + grey,
        "lowercase_field": _pam(hdr.replace(b"WIDTH", b"width") + b"ENDHDR\n", grey),
        "truncated": cut(encode_pam(IMG, "RGB"), 1),
    })
    return out


PAM = _pam_cases()


@pytest.mark.parametrize("case", sorted(PAM))
def test_pam_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.pam"
    path.write_bytes(PAM[case])
    same_as_cv2(path)


def test_pam_alpha_reads_opencv_leaves_unset_raise():
    """OpenCV's `basic_conversion` converts `ceil(width / depth)` pixels of a
    depth-2 or -4 file and leaves the rest of the output uninitialised: the
    port raises `NotImplementedError` for those reads, and reads the grey
    one it writes in full (held to `cv2` at width 5, where OpenCV's write
    past the row stays within its allocation)."""
    data = encode_pam(IMG[:, :5], "GRAYSCALE_ALPHA")
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(pam.decode_pam(data, device="cpu", grey=True), want)
    with pytest.raises(NotImplementedError, match="PAM of depth 2 at width 5"):
        pam.decode_pam(data, device="cpu")
    with pytest.raises(NotImplementedError, match="PAM of depth 4 at width 53"):
        pam.decode_pam(encode_pam(IMG, "RGB_ALPHA"), device="cpu", grey=True)


# --- PFM --------------------------------------------------------------------------------


def _pfm(kind: bytes, values: np.ndarray, scale: bytes, order: str) -> bytes:
    h, w = values.shape[:2]
    return kind + b"\n%d %d\n%s\n" % (w, h, scale) + values[::-1].astype(order + "f4").tobytes()


def _pfm_cases() -> dict:
    v = (RNG.random((9, 11, 3)) * 300 - 20).astype(np.float32)
    v[0, :8] = np.array([np.nan, np.inf, -np.inf, 255.5, 254.5, 0.5, 1.5, 3e9])[:, None]
    out = {
        "cv2_unit": cv2_encoded(".pfm", IMG.astype(np.float32) / 255),  # reads as 0s and 1s
        "cv2_values": cv2_encoded(".pfm", IMG.astype(np.float32)),
        "cv2_grey": cv2_encoded(".pfm", IMG[..., 1].astype(np.float32)),
        "writer_le": encode_pfm(IMG),
        "writer_be_scaled": encode_pfm(IMG, 2.0),
        "writer_grey": encode_pfm(IMG, -1.0, grey=True),
        "specials_le": _pfm(b"PF", v[..., ::-1], b"-1.0", "<"),
        "specials_be": _pfm(b"PF", v[..., ::-1], b"1.0", ">"),
        "scale_2_5": _pfm(b"PF", v, b"-2.5", "<"),
        "scale_tokens": _pfm(b"Pf", v[..., :1], b"-3e0", "<").replace(b"11 9", b"+11\t9x"),
        "scale_zero": _pfm(b"PF", v, b"0.0", "<"),
        "scale_nan": _pfm(b"PF", v, b"nan", "<"),
        "high_byte": _pfm(b"PF", v, b"-1.0\xe9", "<"),
        "space_after_pf": b"PF " + _pfm(b"PF", v, b"-1.0", "<")[3:],
        "truncated": cut(_pfm(b"PF", v, b"-1.0", "<"), 1),
    }
    return out


PFM = _pfm_cases()


@pytest.mark.parametrize("case", sorted(PFM))
def test_pfm_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.pfm"
    path.write_bytes(PFM[case])
    same_as_cv2(path)


# --- Radiance HDR --------------------------------------------------------------------


def _radiance_cases() -> dict:
    values = IMG.astype(np.float32) / 255 * RNG.uniform(0.5, 2.0, IMG.shape).astype(np.float32)
    bright = values.copy()
    bright[:4] *= np.float32(3e7)  # 2**31 and up reads as 0
    rle = encode_radiance(values)
    body = rle[rle.index(b"+X 53\n") + 6:]
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 37 +X 53\n"
    out = {
        "cv2": cv2_encoded(".hdr", values),
        "rle": rle,
        "flat": encode_radiance(values, rle=False),
        "narrow_flat": encode_radiance(values[:, :5]),
        "width_8": encode_radiance(values[:, :8]),
        "bright": encode_radiance(bright),
        "rgbe_signature": b"#?RGBE" + rle[10:],
        "comments_exposure": rle.replace(b"FORMAT", b"# made here\nEXPOSURE=1.0\nFORMAT", 1),
        "flat_after_rle_row": head + body[:body.index(b"\x02\x02\x00\x35", 1)]
        + _rgbe_flat(values[1:]),
        "xyze": rle.replace(b"rgbe", b"xyze"),
        "no_blank_line": rle.replace(b"rgbe\n\n", b"rgbe\n"),
        "bad_size_line": rle.replace(b"-Y 37 +X 53", b"+Y 37 +X 53"),
        "zero_height": rle.replace(b"-Y 37", b"-Y 0"),
        "truncated": cut(rle, 5),
        "wrong_scanline_width": head + b"\x02\x02\x00\x34" + body[4:],
        "zero_count": head + b"\x02\x02\x00\x35\x00" + body[5:],
    }
    return out


def _rgbe_flat(values: np.ndarray) -> bytes:
    flat = encode_radiance(values, rle=False)
    return flat[flat.index(b"+X 53\n") + 6:]


RADIANCE = _radiance_cases()


@pytest.mark.parametrize("case", sorted(RADIANCE))
def test_radiance_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.hdr"
    path.write_bytes(RADIANCE[case])
    same_as_cv2(path)


# --- GIF ----------------------------------------------------------------------------------


PALETTE = RNG.integers(0, 256, (256, 3), dtype=np.uint8)
INDEX = ((IMG[..., 1] >> 4) * 16 + (IMG[..., 2] >> 4)).astype(np.uint8)


def _patch(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def _gif_cases() -> dict:
    small = (INDEX >> 6).astype(np.uint8)
    base = encode_gif(small, PALETTE[:4])
    frame_at = base.index(b"\x2c", 13 + 12)
    out = {
        "pillow_palette": pillow(Image.fromarray(RGB).quantize(64), "GIF"),
        "pillow_interlaced_transparent": pillow(Image.fromarray(RGB).quantize(16), "GIF",
                                                interlace=True, transparency=3),
        "cv2": cv2_encoded(".gif", IMG),
        "global": encode_gif(INDEX, PALETTE),
        "code_size_2": base,
        "code_size_11_full_table": encode_gif(RNG.integers(0, 256, (37, 53)).astype(np.uint8),
                                              PALETTE, min_size=11),
        "full_table_deferred": encode_gif(RNG.integers(0, 256, (37, 53)).astype(np.uint8),
                                          PALETTE, min_size=11, defer_full=True),
        "clear_codes": encode_gif(INDEX, PALETTE, min_size=9, clear_every=13),
        "local_interlaced": encode_gif(INDEX, PALETTE, local=True, interlace=True),
        "transparent": encode_gif(small, PALETTE[:4], transparent=1, background=2),
        "smaller_frame": encode_gif(small[:20, :30], PALETTE[:4], screen=(53, 37),
                                    offset=(5, 9), background=3),
        "no_global_table": encode_gif(small[:20, :30], PALETTE[:4], screen=(53, 37),
                                      offset=(5, 9), local=True, transparent=0),
        "one_pixel": encode_gif(small[:1, :1], PALETTE[:2]),
        # cv2 returns None
        "truncated": cut(base, 30),
        "no_trailer": cut(base, 1),
        "junk_block": base[:-1] + b"\x99\x3b",
        "code_size_1": _patch(base, frame_at + 10, b"\x01"),
        "code_size_12": _patch(encode_gif(small, PALETTE[:4], min_size=11),
                               frame_at + 10, b"\x0c"),
        "background_past_table": _patch(base, 11, b"\x09"),
        "disposal_4": encode_gif(small, PALETTE[:4], transparent=1).replace(
            b"\x21\xf9\x04\x01", b"\x21\xf9\x04\x11", 1),
        "gce_of_5_bytes": encode_gif(small, PALETTE[:4], transparent=1).replace(
            b"\x21\xf9\x04\x01\x00\x00\x01\x00", b"\x21\xf9\x05\x01\x00\x00\x01\x00\x00", 1),
        "pixel_past_table": encode_gif(INDEX, PALETTE[:64]),
    }
    frame = bytearray(encode_gif(small[:20, :30], PALETTE[:4], screen=(30, 20)))
    at = bytes(frame).index(b"\x2c", 13 + 12)
    frame[at + 1:at + 3] = b"\x01\x00"  # the frame one column right: off the screen
    out["off_screen"] = bytes(frame)
    local = encode_gif(small, PALETTE[:4], local=True)
    at = local.index(b"\x2c", 13)
    out["no_table"] = local[:at + 9] + b"\x00" + local[at + 10 + 12:]  # no table at all
    return out


GIF = _gif_cases()


@pytest.mark.parametrize("case", sorted(GIF))
def test_gif_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.gif"
    path.write_bytes(GIF[case])
    same_as_cv2(path)


def _lzw_codes(codes, min_size: int) -> bytes:
    """GIF LZW codes packed at the decoder's code sizes, as sub-blocks."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    size, nxt, prev, acc, nacc, out = min_size + 1, eoi + 1, -1, 0, 0, bytearray()
    for c in codes:
        acc |= c << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if c in (clear, eoi):
            size, nxt, prev = min_size + 1, eoi + 1, -1
            continue
        if prev >= 0 and nxt < 4096:
            nxt += 1
            if nxt == 1 << size and size < 12:
                size += 1
        prev = c
    if nacc:
        out.append(acc & 255)
    return bytes([len(out)]) + bytes(out) + b"\x00"


GIF_STREAMS = {  # code streams at code size 2 (clear 4, EOI 5) for a 3x1 frame
    "exact": [4, 1, 2, 3, 5],
    "no_eoi": [4, 1, 2, 3],
    "no_clear_first": [1, 2, 3, 5],
    "eoi_then_more": [4, 1, 5, 2, 3],
    "fewer_pixels": [4, 1, 2, 5],
    "string_past_the_frame": [4, 1, 2, 6, 5],
    "code_past_the_table": [4, 1, 8, 5],
    "first_code_no_colour": [4, 6, 5],
    "literals_past_the_frame": [4, 1, 2, 3, 1, 1, 1, 1, 1, 1],
    "clears_past_the_frame": [4, 1, 2, 3, 4, 4, 4, 5],
}


@pytest.mark.parametrize("case", sorted(GIF_STREAMS))
def test_gif_lzw_streams_equal_cv2(tmp_path, case):
    """OpenCV's LZW rules at the frame's end, found by sweeps: a first code
    after a reset must be a colour; EOI resets the table and the decode goes
    on; codes past the last pixel count pixels (a byte read after that is
    refused), a string that runs past it is refused."""
    head = encode_gif(np.zeros((1, 3), np.uint8), PALETTE[:4])
    at = head.index(b"\x2c", 13 + 12) + 10
    path = tmp_path / f"{case}.gif"
    path.write_bytes(head[:at] + b"\x02" + _lzw_codes(GIF_STREAMS[case], 2) + b"\x3b")
    same_as_cv2(path)


# --- TIFF ----------------------------------------------------------------------------------


PILLOW_MODES = {"1": lambda: Image.fromarray(IMG[..., 1] > 127),
                "L": lambda: Image.fromarray(IMG[..., 1]),
                "P": lambda: Image.fromarray(RGB).quantize(16),
                "RGB": lambda: Image.fromarray(RGB),
                "RGBA": lambda: Image.fromarray(np.concatenate([RGB, ALPHA.astype(np.uint8)], 2)),
                "CMYK": lambda: Image.fromarray(RGB).convert("CMYK"),
                "YCbCr": lambda: Image.fromarray(RGB).convert("YCbCr"),
                "LA": lambda: Image.fromarray(np.stack([IMG[..., 1], ALPHA[..., 0].astype(
                    np.uint8)], 2), "LA"),
                "I;16": lambda: Image.fromarray(WIDE[..., 1].astype(np.uint16))}
PILLOW_CODECS = ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits")


def _set_count(data: bytes, tag: int, count: int) -> bytes:
    """A little-endian classic TIFF with the count field of `tag`'s entry
    set to `count` (its values' offset kept)."""
    (ifd,) = struct.unpack_from("<I", data, 4)
    (n,) = struct.unpack_from("<H", data, ifd)
    out = bytearray(data)
    for e in range(ifd + 2, ifd + 2 + 12 * n, 12):
        if struct.unpack_from("<H", data, e)[0] == tag:
            struct.pack_into("<I", out, e + 4, count)
    return bytes(out)


def _tiff_cases() -> dict:
    out = {f"pillow_{m}_{c}": pillow(make(), "TIFF", compression=c)
           for m, make in PILLOW_MODES.items() for c in PILLOW_CODECS}
    for m in ("L", "RGB", "RGBA", "CMYK", "YCbCr", "LA"):
        out[f"pillow_{m}_jpeg"] = pillow(PILLOW_MODES[m](), "TIFF", compression="jpeg")
    out["pillow_RGB_jpeg_q30"] = pillow(PILLOW_MODES["RGB"](), "TIFF", compression="jpeg",
                                        quality=30)
    out["cv2_colour"] = cv2_encoded(".tif", IMG)
    out["cv2_grey"] = cv2_encoded(".tif", IMG[..., 1])
    rgba = np.concatenate([RGB, ALPHA], 2)
    wide_rgba = np.concatenate([WIDE, ALPHA * 257], 2)
    grey_alpha = np.concatenate([RGB[..., 1:2], ALPHA], 2)
    cmap16 = RNG.integers(0, 65536, (256, 3))
    square = RGB[:32, :32]
    out.update({
        "bigtiff_mm": encode_tiff(RGB, 2, order=">", big=True, rows_per_strip=7),
        "bigtiff_ii_tiles": encode_tiff(RGB, 2, big=True, tile=(16, 16), compression=5),
        "mm_tiles_planes": encode_tiff(RGB, 2, order=">", tile=(32, 16), planar=2,
                                       compression=8),
        "lzw_predictor": encode_tiff(RGB, 2, compression=5, predictor=2, rows_per_strip=5),
        "deflate_predictor_16": encode_tiff(WIDE, 2, bits=16, compression=8, predictor=2,
                                            order=">"),
        "packbits_planes": encode_tiff(RGB, 2, compression=32773, planar=2, rows_per_strip=9),
        "rgb16": encode_tiff(WIDE, 2, bits=16),  # (v + 128) // 257, not the high byte
        "rgb16_planes_mm": encode_tiff(WIDE, 2, bits=16, planar=2, order=">"),
        "rgba_unassociated": encode_tiff(rgba, 2, extra=(2,)),  # premultiplied
        "rgba_associated": encode_tiff(rgba, 2, extra=(1,)),
        "rgba_unspecified": encode_tiff(rgba, 2, extra=(0,)),
        "rgba_unassociated_planes": encode_tiff(rgba, 2, extra=(2,), planar=2),
        "rgba16_unassociated": encode_tiff(wide_rgba, 2, bits=16, extra=(2,)),
        "grey_alpha_unassociated": encode_tiff(grey_alpha, 1, extra=(2,)),
        "grey_alpha_planes": encode_tiff(grey_alpha, 1, extra=(2,), planar=2),
        "grey_white_planes": encode_tiff(grey_alpha, 0, extra=(0,), planar=2),
        "grey_alpha_tiles": encode_tiff(grey_alpha, 1, extra=(2,), tile=(16, 32)),
        "bilevel_white": encode_tiff(RGB[..., 1:2] > 127, 0, bits=1),
        "bilevel_black_tiles": encode_tiff(RGB[..., 1:2] > 127, 1, bits=1, tile=(16, 16)),
        "grey16_black": encode_tiff(WIDE[..., 1:2], 1, bits=16),  # the high byte
        "grey16_white_tiles": encode_tiff(WIDE[..., 1:2], 0, bits=16, tile=(16, 16),
                                          order=">"),
        "palette8_map16": encode_tiff(RGB[..., 1:2], 3, colormap=cmap16),
        "palette8_map8": encode_tiff(RGB[..., 1:2], 3, colormap=cmap16 >> 8),
        "palette4": encode_tiff(RGB[..., 1:2] >> 4, 3, bits=4, colormap=cmap16[:16]),
        "palette1": encode_tiff(RGB[..., 1:2] >> 7, 3, bits=1, colormap=cmap16[:2]),
        "cmyk": encode_tiff(np.concatenate([255 - RGB, RGB[..., :1]], 2), 5),
        "cmyk_planes": encode_tiff(np.concatenate([255 - RGB, RGB[..., :1]], 2), 5, planar=2),
        "ycbcr_default_2x2": encode_tiff(RGB, 6, subsampling=(2, 2), tags={530: (3, [2, 2])}),
        "ycbcr_coefficients": encode_tiff(RGB, 6, subsampling=(1, 1), tags={
            529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
            532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])}),
        "ycbcr_planes": encode_tiff(RGB, 6, subsampling=(1, 1), planar=2),
        "jpeg_strips": encode_tiff(RGB, 6, compression=7, subsampling=(2, 2),
                                   rows_per_strip=16),
        "jpeg_tiles": encode_tiff(RGB, 6, compression=7, subsampling=(2, 2), tile=(32, 32)),
        "jpeg_grey": encode_tiff(RGB[..., 1:2], 1, compression=7, rows_per_strip=16),
        "jpeg_planes_rgb": encode_tiff(RGB, 2, compression=7, planar=2, rows_per_strip=16),
        "jpeg_planes_ycbcr": encode_tiff(RGB, 6, compression=7, planar=2, subsampling=(1, 1),
                                         tile=(16, 16)),
        "jpeg_planes_cmyk": encode_tiff(np.concatenate([255 - RGB, RGB[..., :1]], 2), 5,
                                        compression=7, planar=2, rows_per_strip=32),
        "unknown_compression_reads_zeros": encode_tiff(RGB, 2, compression=4711),
        # cv2 returns None
        "float32": encode_tiff(RGB / 255, 2, bits=32, sample_format=3),
        "lzma": encode_tiff(RGB, 2, compression=34925),
        "zstd": encode_tiff(RGB, 2, compression=50000),
        "grey_2bit": encode_tiff(RGB[..., 1:2] >> 6, 1, bits=2),
        "palette2": encode_tiff(RGB[..., 1:2] >> 6, 3, bits=2, colormap=cmap16[:4]),
        "five_samples": encode_tiff(np.concatenate([rgba, ALPHA], 2), 2, extra=(2, 0)),
        "extra_sample_3": encode_tiff(rgba, 2, extra=(3,)),
        "cmyk16": encode_tiff(np.concatenate([WIDE, WIDE[..., :1]], 2), 5, bits=16),
        "ycbcr_3x3": encode_tiff(RGB, 6, subsampling=(3, 3)),
        "ycbcr_planes_2x2": encode_tiff(RGB, 6, subsampling=(2, 2), planar=2),
        "tile_byte_count": encode_tiff(RGB, 2, tile=(16, 16), tags={325: (4, [700] * 12)}),
        "truncated": cut(encode_tiff(RGB, 2, compression=5), 10),
        "no_photometric": encode_tiff(RGB, 2, tags={262: (7, [2, 0])}),
    })
    # libtiff reads no more strip offsets and counts than the strips: a count
    # field far past the file's end reads
    out["strip_counts_count_too_large"] = _set_count(
        encode_tiff(RGB, 2, compression=32773, rows_per_strip=8), 279, 100000)
    out["strip_offsets_too_few"] = _set_count(
        encode_tiff(RGB, 2, rows_per_strip=8), 273, 3)
    for comp in (1, 5, 8, 32773):  # FillOrder 2: the strips' bits reversed first
        out[f"fillorder_2_{comp}"] = encode_tiff(RGB, 2, compression=comp, rows_per_strip=8,
                                                 tags={266: (3, [2])})
    out["fillorder_2_jpeg"] = encode_tiff(RGB, 6, compression=7, subsampling=(2, 2),
                                          rows_per_strip=16, tags={266: (3, [2])})
    for ss in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4)):
        name = f"ycbcr_{ss[0]}x{ss[1]}"
        out[name] = encode_tiff(RGB, 6, subsampling=ss, rows_per_strip=8)
        out[name + "_tiles"] = encode_tiff(RGB, 6, subsampling=ss, tile=(32, 16),
                                           compression=5)
    for o in range(1, 9):
        out[f"orientation_{o}"] = encode_tiff(square, 2, orientation=o, rows_per_strip=5)
    out["orientation_6_not_square"] = encode_tiff(RGB, 2, orientation=6)
    # damaged strips: what the codec decoded, zeros after
    for name, comp in (("lzw", 5), ("deflate", 8), ("packbits", 32773)):
        damaged = bytearray(encode_tiff(RGB, 2, compression=comp, rows_per_strip=20))
        damaged[-60:] = bytes(60)  # the last strip's end
        out[f"damaged_{name}"] = bytes(damaged)
    return out


TIFF = _tiff_cases()


@pytest.mark.parametrize("case", sorted(TIFF))
def test_tiff_equal_cv2(tmp_path, case):
    path = tmp_path / f"{case}.tif"
    path.write_bytes(TIFF[case])
    same_as_cv2(path)


def test_tiff_traps():
    """The conversions of libtiff's RGBA interface the issue names, against
    `cv2` directly: 16-bit colour is `round(v / 257)`, unassociated alpha is
    premultiplied `(c * a + 127) // 255` and dropped, a 3-channel float32
    file is None in a colour read."""
    def cv(data, flag=cv2.IMREAD_COLOR):
        return cv2.imdecode(np.frombuffer(data, np.uint8), flag)

    np.testing.assert_array_equal(cv(TIFF["rgb16"]), ((WIDE + 128) // 257)[..., ::-1])
    want = (RGB.astype(np.int64) * ALPHA + 127) // 255
    np.testing.assert_array_equal(cv(TIFF["rgba_unassociated"]), want[..., ::-1])
    assert cv(TIFF["float32"]) is None


# --- the compiled decoders ---------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled decoders are checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    for name, sig in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = sig
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _read(path: Path, device: str, channels: int):
    try:
        return _imread(str(path), device, channels)
    except (FileNotFoundError, NotImplementedError) as e:
        return type(e)


def _damaged(data: bytes, rng: np.random.Generator, n: int) -> list[bytes]:
    """`n` copies of `data` with a few bytes of its second half replaced or
    its end cut."""
    out = []
    for i in range(n):
        d = bytearray(data)
        if i % 3 == 2:
            d = d[:int(rng.integers(len(d) // 2, len(d)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(len(d) // 2, len(d)))] = int(rng.integers(256))
        out.append(bytes(d))
    return out


FORMAT_SETS = {"tiff": (TIFF, ".tif"), "gif": (GIF, ".gif"), "radiance": (RADIANCE, ".hdr"),
               "sunras": (SUNRAS, ".ras"), "pam": (PAM, ".pam"), "pfm": (PFM, ".pfm")}


@pytest.mark.parametrize("fmt", sorted(FORMAT_SETS))
def test_compiled_decoders_equal_numpy(tmp_path, host_lib, monkeypatch, fmt):
    """Every file of the format, and damaged copies of the files the
    sequential decoders read, read on a GPU run's path (the compiled LZW,
    PackBits, GIF LZW, Radiance scanlines, JPEG and grey conversions) equal
    to the numpy reads, or both raise the same error."""
    monkeypatch.setattr(_build, "library", lambda: host_lib)
    cases, ext = FORMAT_SETS[fmt]
    rng = np.random.default_rng(len(fmt))
    files = list(cases.values())
    if fmt in ("tiff", "gif", "radiance"):
        seqs = [d for k, d in cases.items() if any(s in k for s in ("lzw", "deflate", "packbits",
                                                                    "rle", "global", "clear"))]
        files += [d for data in seqs for d in _damaged(data, rng, 6)]
    for i, data in enumerate(files):
        path = tmp_path / f"{i}{ext}"
        path.write_bytes(data)
        for channels in (3, 1):
            want = _read(path, "cpu", channels)
            got = _read(path, "cuda", channels)
            if isinstance(want, type):
                assert got is want, (fmt, i, channels)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{fmt} file {i}")


def test_compiled_status_codes(host_lib, monkeypatch):
    """The compiled decoders' statuses: bad parameters (status 1, only a
    caller's fault) raise `RuntimeError`; a stream the decoder refuses
    raises `Unreadable` (GIF) or reads as what was decoded (TIFF's LZW and
    PackBits, libtiff's partial strips)."""
    from yolopoint_tpu_torch.data import radiance, tiff

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    with pytest.raises(RuntimeError, match="bad parameters"):
        gif.lzw_compiled(b"\x00", 1, 4)
    with pytest.raises(RuntimeError, match="bad parameters"):
        radiance.rgbe_compiled(b"", 0, 3)
    with pytest.raises(Unreadable, match="fewer pixels"):
        gif.lzw_compiled(b"\x01\x0c\x00", 2, 4)
    out, ok = tiff.lzw_compiled(b"\x80", 10)
    assert not ok and not out.any()
    out, ok = tiff.packbits_compiled(b"\x02abc\xfeZ", 8)
    assert not ok and out.tobytes() == b"abcZZZ\0\0"


# --- the card's files ------------------------------------------------------------------------


CARD_FILES = image_format_files(0, 37, 53)


@pytest.mark.parametrize("name", sorted(CARD_FILES))
def test_card_phase_files_read_as_cv2(tmp_path, name):
    """The files the card's `image_formats` phase holds the compiled
    decoders to numpy on, written by this repository's numpy writers, are
    read by `cv2` as the port reads them."""
    path = tmp_path / name
    path.write_bytes(CARD_FILES[name])
    same_as_cv2(path)


def test_unported_signatures_are_webp_jpeg2000_avif():
    assert [kind for kind, _ in UNPORTED_SIGNATURES] == ["WebP", "JPEG 2000", "AVIF"]
