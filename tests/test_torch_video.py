"""The port's video reader (`yolopoint_tpu_torch/data/video.py`) against
`cv2.VideoCapture` on the CPU (cv2 5.0 with FFmpeg 8, the JAX package's
reader, is the oracle): for files `cv2.VideoWriter` writes (MJPEG AVI and MOV, `mp4v` MP4,
MOV and AVI, `XVID` / `DIVX` / `FMP4` AVI, raw I420 / IYUV / YV12 AVI,
`MPNG` AVI and `png ` MOV; panning clips, so that P-VOPs carry vectors
pointing outside the frame; a 150x110 size that is not a multiple of 16)
and MJPEG AVIs built by the test from `cv2.imencode` (4:2:2, 4:4:4, grey, no DHT,
restart intervals, odd sizes), the same number of frames, bit-equal. The
compiled decoders (`host_video.cpp` with `host_image.cpp`'s entropy
decoder, built with g++) equal the numpy ones. Refused streams raise
naming what is refused; bytes cv2 cannot open give no frames."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tests.torch_video_files import (
    avi_bytes,
    build_host_library,
    pan_clip,
    read_cv2,
    strip_dht,
    write_cv2,
)
from yolopoint_tpu_torch.data import mpeg4video, video, yuv

torch.set_num_threads(1)

WRITER_KINDS = [  # (file name, fourcc, height, width, frames)
    ("mjpg.avi", "MJPG", 120, 160, 13), ("mp4v.mp4", "mp4v", 120, 160, 13),
    ("xvid.avi", "XVID", 120, 160, 13), ("divx.avi", "DIVX", 120, 160, 13),
    ("fmp4.avi", "FMP4", 120, 160, 13), ("i420.avi", "I420", 120, 160, 13),
    ("iyuv.avi", "IYUV", 120, 160, 6), ("yv12.avi", "YV12", 120, 160, 6),
    ("mpng.avi", "MPNG", 120, 160, 3), ("png.mov", "png ", 120, 160, 3),
    ("jpeg.mov", "jpeg", 120, 160, 6), ("mp4v.mov", "mp4v", 120, 160, 6),
    ("mjpg_in.mp4", "MJPG", 120, 160, 4), ("mp4v_150x110.mp4", "mp4v", 110, 150, 13),
    ("mp4v_150x110.avi", "FMP4", 110, 150, 13), ("mjpg_150x110.avi", "MJPG", 110, 150, 6),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video")
    out = {}
    for name, fourcc, h, w, n in WRITER_KINDS:
        out[name] = write_cv2(tmp / name, fourcc, pan_clip(h, w, n, seed=len(out)))
    return out


def assert_reads_as_cv2(path: Path, device: str = "cpu") -> list[np.ndarray]:
    want = read_cv2(path)
    got = list(video.read_video(path, device))
    assert len(got) == len(want) > 0, (path.name, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8, (path.name, i)
        assert np.array_equal(g, w), (path.name, i, int(np.abs(g.astype(int) - w).max()))
    return got


@pytest.mark.parametrize("name", [k[0] for k in WRITER_KINDS])
def test_writer_files_read_as_cv2(files, name):
    assert_reads_as_cv2(files[name])


MJPEG_CASES = {
    "420": [], "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3], "q20": [cv2.IMWRITE_JPEG_QUALITY, 20],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
}


def mjpeg_avi(path: Path, frames, params=(), grey=False, no_dht=False) -> Path:
    packets = []
    for f in frames:
        data = cv2.imencode(".jpg", cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) if grey else f,
                            list(params))[1].tobytes()
        packets.append(strip_dht(data) if no_dht else data)
    h, w = frames[0].shape[:2]
    path.write_bytes(avi_bytes(packets, w, h))
    return path


@pytest.mark.parametrize("size", [(120, 160), (118, 157), (119, 150)], ids=str)
@pytest.mark.parametrize("case", [*MJPEG_CASES, "grey", "no_dht"])
def test_imencode_mjpeg_as_cv2(tmp_path, case, size):
    frames = pan_clip(*size, 3, seed=7)
    params = MJPEG_CASES.get(case, [])
    path = mjpeg_avi(tmp_path / "m.avi", frames, params, grey=case == "grey",
                     no_dht=case == "no_dht")
    if size[0] % 2 and case in ("420", "422", "restart", "q20", "optimized", "no_dht"):
        # 4:2:0 / 4:2:2 of odd height: swscale's scaled path
        with pytest.raises(NotImplementedError, match="odd height"):
            list(video.read_video(path, "cpu"))
        assert len(read_cv2(path)) == 3
        return
    assert_reads_as_cv2(path)


def test_zero_length_chunks_give_no_frame(tmp_path):
    frames = pan_clip(64, 80, 4, seed=3)
    packets = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    for index in (True, False):
        path = tmp_path / f"z{index}.avi"
        path.write_bytes(avi_bytes(packets[:2] + [b""] + packets[2:], 80, 64, index=index))
        assert len(assert_reads_as_cv2(path)) == 4


def test_packet_without_jpeg_ends_the_stream(tmp_path):
    frames = pan_clip(64, 80, 4, seed=4)
    packets = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    path = tmp_path / "g.avi"
    path.write_bytes(avi_bytes(packets[:2] + [b"garbage!"] + packets[2:], 80, 64))
    assert len(assert_reads_as_cv2(path)) == 2


def test_raw_i420_random_planes(tmp_path):
    """Random samples (luma below 16 included: swscale's SIMD routine does
    not saturate its luma term), odd width."""
    rng = np.random.default_rng(5)
    h, w = 64, 97
    packets = [rng.integers(0, 256, h * w + 2 * 32 * 49, np.uint8).tobytes() for _ in range(2)]
    path = tmp_path / "r.avi"
    path.write_bytes(avi_bytes(packets, w, h, fourcc=b"I420", bitcount=12))
    assert_reads_as_cv2(path)


def test_no_frames_where_cv2_opens_nothing(tmp_path):
    rng = np.random.default_rng(6)
    cases = {"random.bin": rng.integers(0, 256, 5000, np.uint8).tobytes(), "empty.avi": b"",
             "zeros.mp4": bytes(64)}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
    for name in [*cases, "missing.avi"]:
        assert read_cv2(tmp_path / name) == []
        assert list(video.read_video(tmp_path / name, "cpu")) == [], name


def patched(src: Path, dst: Path, old: bytes, new: bytes, count: int = 1) -> Path:
    data = src.read_bytes()
    assert data.count(old) >= 1
    dst.write_bytes(data.replace(old, new, count))
    return dst


def test_refused_streams_raise(files, tmp_path):
    cases = [
        # an AVI codec the port does not decode (H.264's tag in strh and strf)
        (patched(files["xvid.avi"], tmp_path / "h264.avi", b"XVID", b"H264", 2),
         r"h264\.avi: AVI with codec tag b'H264'"),
        # an MP4 track of another codec
        (patched(files["mp4v.mp4"], tmp_path / "avc.mp4", b"mp4v", b"avc1"),
         r"avc\.mp4: MP4/MOV with codec tag b'avc1'"),
        # XviD user data: FFmpeg would switch to the XviD IDCT
        (patched(files["xvid.avi"], tmp_path / "xvid_tag.avi", b"Lavc62.28.101",
                 b"XviD0063\x00\x00\x00\x00\x00"),
         r"xvid_tag\.avi: AVI with codec tag b'XVID': MPEG-4 Part 2 XviD-tagged"),
        (tmp_path / "clip.mkv", "Matroska"),
        (tmp_path / "notes.txt", "tty"),
    ]
    (tmp_path / "clip.mkv").write_bytes(b"\x1a\x45\xdf\xa3" + bytes(60))
    (tmp_path / "notes.txt").write_text("not a video\n" * 10)
    for path, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            list(video.read_video(path, "cpu"))
    frames = pan_clip(64, 80, 2, seed=8)
    prog = mjpeg_avi(tmp_path / "prog.avi", frames, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert len(read_cv2(prog)) == 2
    with pytest.raises(NotImplementedError,
                       match=r"prog\.avi: AVI with codec tag b'MJPG': progressive MJPEG"):
        list(video.read_video(prog, "cpu"))


def test_mpeg4_refuses_tools():
    gb_vol = bytearray(b"\x00\xc4\x8d\x88\x00\x55\x05\x04\x0f\x14\x63")  # lavc's 160x120 VOL
    vol = mpeg4video.parse_vol(bytes(gb_vol))
    assert (vol.width, vol.height, vol.mpeg_quant, vol.resync_marker) == (160, 120, False, False)
    vop = b"\xa0\x00\x00\x00"  # coding type 2: a B-VOP
    with pytest.raises(NotImplementedError, match="B-VOP"):
        mpeg4video.parse_vop(vop, 0, vol)


def test_yuv_layouts_refuse_odd_heights():
    y = np.zeros((5, 4), np.uint8)
    c = np.zeros((3, 2), np.uint8)
    with pytest.raises(NotImplementedError, match="odd height"):
        yuv.to_bgr_numpy(y, c, c, "420", False)
    out = yuv.to_bgr_numpy(y, np.zeros((5, 4), np.uint8), np.zeros((5, 4), np.uint8), "444",
                           True)
    assert out.shape == (5, 4, 3)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = build_host_library(tmp_path_factory.mktemp("host"))
    if lib is None:
        pytest.skip("no C++ compiler on this host: the compiled decoders are checked on the card")
    return lib


@pytest.mark.parametrize("name", ["mjpg.avi", "mp4v.mp4", "mp4v_150x110.avi", "i420.avi",
                                  "png.mov", "jpeg.mov"])
def test_compiled_equals_numpy_and_cv2(files, host_lib, monkeypatch, name):
    from yolopoint_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    got = assert_reads_as_cv2(files[name], "cuda")
    want = list(video.read_video(files[name], "cpu"))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_compiled_mjpeg_layouts(tmp_path, host_lib, monkeypatch):
    from yolopoint_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    frames = pan_clip(118, 157, 2, seed=9)
    for case in ("422", "444", "restart"):
        assert_reads_as_cv2(mjpeg_avi(tmp_path / f"{case}.avi", frames, MJPEG_CASES[case]),
                            "cuda")
    assert_reads_as_cv2(mjpeg_avi(tmp_path / "grey.avi", frames, grey=True), "cuda")


FIXTURES = Path(__file__).resolve().parent / "data" / "video"


@pytest.mark.parametrize("name", ["mp4v_480x640.mp4", "mjpeg_480x640.avi",
                                  "mjpeg422_240x320.avi"])
def test_fixtures_equal_cv2_digests(name):
    """The committed fixtures `chip_smoke.py` checks on the card: the numpy
    read gives the SHA-256 of cv2's frames (`tools/make_video_fixtures.py`),
    and cv2 still reads them so."""
    import hashlib
    import json

    entry = json.loads((FIXTURES / "video_fixtures.json").read_text())["files"][name]
    frames = list(video.read_video(FIXTURES / name, "cpu"))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == entry["sha256"]
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in read_cv2(FIXTURES / name)] == \
        entry["sha256"]


@pytest.mark.parametrize("size", [(64, 80), (63, 81)], ids=str)
def test_top_down_bi_rgb_as_cv2(tmp_path, size):
    """Uncompressed BGR rows padded to 4 bytes, top-down (negative
    biHeight); a bottom-up file (cv2 aborts on those) raises."""
    h, w = size
    stride = (w * 3 + 3) // 4 * 4
    frames = pan_clip(h, w, 3, seed=13)
    packets = []
    for f in frames:
        buf = np.zeros((h, stride), np.uint8)
        buf[:, :w * 3] = f.reshape(h, -1)
        packets.append(buf.tobytes())
    path = tmp_path / "dib.avi"
    path.write_bytes(avi_bytes(packets, w, -h, fourcc=b"\0\0\0\0", bitcount=24))
    got = assert_reads_as_cv2(path)
    assert all(np.array_equal(g, f) for g, f in zip(got, frames))
    path.write_bytes(avi_bytes(packets, w, h, fourcc=b"\0\0\0\0", bitcount=24))
    with pytest.raises(NotImplementedError, match="bottom-up BI_RGB"):
        list(video.read_video(path, "cpu"))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mpeg_quant,resync", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_random_mpeg4_syntax_as_cv2(tmp_path, seed, mpeg_quant, resync):
    """Random streams over every Simple-profile tool the decoder reads
    (`tests/torch_mpeg4_writer.py`: 4MV, intra and not-coded macroblocks in
    P-VOPs, DQUANT, AC prediction, every intra DC threshold, the three
    escapes, f_code 1-3, both rounding types, MPEG quantization with custom
    matrices, video packets), 64x48 and 48x32, as cv2 decodes them."""
    from tests.torch_mpeg4_writer import avi_of, random_stream

    w, h = (48, 32) if seed % 2 else (64, 48)
    path = tmp_path / "random.avi"
    path.write_bytes(avi_of(random_stream(seed, w, h, 6, mpeg_quant, resync), w, h))
    assert len(assert_reads_as_cv2(path)) == 6


def test_compiled_random_mpeg4_equals_numpy(tmp_path, host_lib, monkeypatch):
    from tests.torch_mpeg4_writer import avi_of, random_stream
    from yolopoint_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    for seed, (mq, rs) in enumerate([(False, False), (True, True), (False, True), (True, False)]):
        path = tmp_path / f"r{seed}.avi"
        path.write_bytes(avi_of(random_stream(10 + seed, 64, 48, 6, mq, rs), 64, 48))
        got = assert_reads_as_cv2(path, "cuda")
        assert all(np.array_equal(g, n) for g, n in zip(got, video.read_video(path, "cpu")))


def test_idct_row_overflow_raises():
    """Past 16 bits in the row pass FFmpeg's x86 SIMD IDCT is not the C
    code's: the port raises there (and is exact below it)."""
    from yolopoint_tpu_torch.data import idct_ff

    block = np.zeros((8, 8), np.int16)
    block[0, 0], block[0, 1] = 4000, 3000
    with pytest.raises(idct_ff.IdctOverflow):
        idct_ff.idct_put(block)
    block[0, 0], block[0, 1] = 1000, 300
    assert idct_ff.idct_put(block).shape == (8, 8)


def test_opendml_and_rec_lists_as_cv2(tmp_path):
    """Chunks continued in an OpenDML `RIFF AVIX`, and chunks grouped in
    `LIST rec ` lists."""
    import struct

    from tests.torch_video_files import _chunk, _list

    frames = pan_clip(64, 80, 6, seed=14)
    packets = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    movi = b"".join(_chunk(b"00dc", p) for p in packets[3:])
    avix = b"AVIX" + _list(b"movi", movi)
    path = tmp_path / "avix.avi"
    path.write_bytes(avi_bytes(packets[:3], 80, 64, index=False) + b"RIFF"
                     + struct.pack("<I", len(avix)) + avix)
    assert len(assert_reads_as_cv2(path)) == 6
    plain = avi_bytes(packets, 80, 64, index=False)
    head = plain[12:plain.find(b"movi") - 8]
    body = b"AVI " + head + _list(b"movi", b"".join(_list(b"rec ", _chunk(b"00dc", p))
                                                   for p in packets))
    path = tmp_path / "rec.avi"
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    assert len(assert_reads_as_cv2(path)) == 6


MP4_STBL = [b"moov", b"trak", b"mdia", b"minf", b"stbl"]


@pytest.mark.parametrize("start,frames", [(0, 10), (2, 8), (2, 5), (0, 4), (3, 0)])
def test_mp4_edit_list_as_cv2(files, tmp_path, start, frames):
    """lavc's one-edit `elst` patched to start `start` frames in and last
    `frames` frames (0: cv2 shows none)."""
    import struct

    from tests.torch_video_files import mp4_box, replace_box

    data = files["mp4v.mp4"].read_bytes()
    (delta,) = struct.unpack(">I", mp4_box(data, MP4_STBL + [b"stts"])[12:16])
    mdhd = mp4_box(data, [b"moov", b"trak", b"mdia", b"mdhd"])
    (media_scale,) = struct.unpack(">I", mdhd[12:16])
    (movie_scale,) = struct.unpack(">I", mp4_box(data, [b"moov", b"mvhd"])[12:16])
    elst = struct.pack(">IIIiI", 0, 1, frames * delta * movie_scale // media_scale,
                       start * delta, 0x10000)
    path = tmp_path / "edit.mp4"
    path.write_bytes(replace_box(data, [b"moov", b"trak", b"edts", b"elst"], b"elst", elst))
    want = read_cv2(path)
    assert len(want) == min(frames, 13 - start)
    got = list(video.read_video(path, "cpu"))
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_mp4_co64_and_stz2_as_cv2(files, tmp_path):
    """The 64-bit chunk offsets (`co64`) and compact sample sizes (`stz2`,
    16-bit fields) in place of lavc's `stco` and `stsz`."""
    import struct

    from tests.torch_video_files import mp4_box, replace_box

    data = files["mp4v.mp4"].read_bytes()
    stco = mp4_box(data, MP4_STBL + [b"stco"])
    (n,) = struct.unpack(">I", stco[4:8])
    offsets = struct.unpack(f">{n}I", stco[8:8 + 4 * n])
    data = replace_box(data, MP4_STBL + [b"stco"], b"co64",
                       stco[:8] + struct.pack(f">{n}Q", *offsets))
    stsz = mp4_box(data, MP4_STBL + [b"stsz"])
    _, count = struct.unpack(">II", stsz[4:12])
    sizes = struct.unpack(f">{count}I", stsz[12:12 + 4 * count])
    assert max(sizes) < 1 << 16
    data = replace_box(data, MP4_STBL + [b"stsz"], b"stz2",
                       bytes(4) + b"\0\0\0\x10" + struct.pack(f">I{count}H", count, *sizes))
    path = tmp_path / "co64.mp4"
    path.write_bytes(data)
    assert len(assert_reads_as_cv2(path)) == 13


def test_interlaced_mjpeg_as_cv2(tmp_path):
    """Two fields a packet in a container twice their height (the first
    field on the odd rows, with and without `AVI1` segments); one field a
    packet gives no frame."""
    import struct

    frames = pan_clip(120, 80, 3, seed=15)

    def avi1(jpg: bytes, polarity: int) -> bytes:
        return jpg[:2] + b"\xff\xe0" + struct.pack(">H", 10) + b"AVI1" + bytes([polarity, 0, 0,
                                                                                 0]) + jpg[2:]

    for polarity in (None, 1, 2):
        packets = []
        for f in frames:
            fields = [cv2.imencode(".jpg", f[k::2])[1].tobytes() for k in (0, 1)]
            if polarity is not None:
                fields = [avi1(x, polarity) for x in fields]
            packets.append(b"".join(fields))
        path = tmp_path / f"il{polarity}.avi"
        path.write_bytes(avi_bytes(packets, 80, 120))
        assert len(assert_reads_as_cv2(path)) == 3
    path = tmp_path / "one_field.avi"
    path.write_bytes(avi_bytes([cv2.imencode(".jpg", f[0::2])[1].tobytes() for f in frames],
                               80, 120))
    assert read_cv2(path) == [] and list(video.read_video(path, "cpu")) == []
