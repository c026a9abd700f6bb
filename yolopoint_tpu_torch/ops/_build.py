"""Build and load the port's CUDA kernels.

All `.cu` sources under `ops/csrc/` are compiled, one `nvcc` process each,
all started together, and linked into one shared library with a plain
`extern "C"` interface, which is loaded with ctypes. The `.cpp` sources are
host code of the datasets (PNG unfiltering, the JPEG decode (Huffman and
arithmetic coded, lossless) and encode, the grey reads, run-length BMP, TIFF's
LZW and PackBits, GIF's LZW, Radiance's run-length scanlines, the
video reader's swscale conversions, MJPEG IDCT and MPEG-4 Part 2 VOP decode, the
resize, the host warp of the training views and the export, the covariance packing of the ROS layer's object messages, OpenCV's
8-bit warps of the synthetic-data tools, OpenCV's RANSAC homography of the
evaluation) and of the checkpoint reader (zstd and CRC-32C), compiled by
`nvcc` in the same way with `HOST_FLAGS` and linked into the same library. No
source includes PyTorch's headers, so the build takes seconds, not the minutes a
`torch.utils.cpp_extension` build takes. The library goes
into `yolopoint_tpu_torch/_build/`, named by a hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused.

Pointers and the stream cross as `ctypes.c_void_p`; every launch goes on
PyTorch's current stream, and every C entry point returns the
`cudaError_t` of its launch, which `check()` turns into an exception.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# host code: no contraction of a * b + c into an FMA but where the source
# writes `std::fma` (the resize and the host warp are held bit for bit to the
# JAX package's); the machine's own instructions for `std::fma`, `std::floor`
# and vector loops, which round as the libm calls do
# (`tools/bench_torch_host_warp.py`: 3-4x on the warp)
HOST_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xcompiler", "-ffp-contract=off",
              "-Xcompiler", "-march=native")

# Kernel launches by wrapper name (the warp counts under the Pallas kernel
# it replaced, "K4" or "K5", and the suppressed map under "K6"; the keypoint
# NMS's global-memory branch under "nms_tile_keys_global" and "K6_global").
# A wrapper adds one exactly where it launches its kernel, so a caller can
# show that a path went through it.
launch_counts: collections.Counter = collections.Counter()
# one build at a time in a process: the first use of the library can come
# from several threads at once (a loader's host warps), whose temporary
# files would share a name
_BUILD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # heat, heat_is_bf16, keys, scratch (nullable), B, H, W, conf, radius, iterations,
    # border, tile, stream
    "yp_nms_tile_keys": (_P, _I, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P),
    # heat, heat_is_bf16, out, scratch (nullable), B, H, W, conf, radius, iterations,
    # border, stream
    "yp_nms_suppressed_map": (_P, _I, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    # boxes, valid, keep, mask_scratch, arrivals, B, K, iou_thres, stream
    "yp_greedy_nms": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    # desc, desc_is_bf16, points, out, B, Hc, Wc, D, N, cell, stream
    "yp_sample_descriptors": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # img, hom, xs, ys, out, B, H, W, C, nearest, global_tiles (nullable), stream
    "yp_warp_image": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    # host code (host_image.cpp). raw, out, height, stride, bpp
    "yp_png_unfilter": (_P, _P, _I, _I, _I),
    # src, sh, sw, c, dst, dh, dw
    "yp_host_resize_bilinear_u8": (_P, _I, _I, _I, _P, _I, _I),
    "yp_host_resize_area_u8": (_P, _I, _I, _I, _P, _I, _I),
    # src, h, w, c, hinv (9 f32), dst, nearest
    "yp_host_warp_perspective_f32": (_P, _I, _I, _I, _P, _P, _I),
    # h, w, hinv, dst
    "yp_host_warp_coverage_f32": (_I, _I, _P, _P),
    # src, h, w, kernel (u8), kh, kw, dst
    "yp_host_erode_f32": (_P, _I, _I, _P, _I, _I, _P),
    # data, frame (i32), scans (i32), nscans, quant (i32), huffman tables (u8), grey,
    # out (u8 BGR or grey)
    "yp_jpeg_decode": (_P, _P, _P, _I, _P, _P, _I, _P),
    # img, height, width, channels, quant (2 x 64 i32), out, capacity
    "yp_jpeg_encode": (_P, _I, _I, _I, _P, _P, ctypes.c_int64),
    # src, pixels, kind (0 libpng 8-bit RGB, 1 libpng 16-bit RGB, 2 OpenCV BGR, 3 libpng
    # 8-bit RGB with gamma, 4 libpng 16-bit RGB with gamma, 5 OpenCV cvtColor BGR), gamma
    # tables (3 x 256 u8, kind 3; 3 x 65536 u16 in the host's order, kind 4), out
    "yp_grey_u8": (_P, ctypes.c_int64, _I, _P, _P),
    # full / packed, n, packed / full (f32)
    "yp_cov_pack_upper": (_P, _I, _P),
    "yp_cov_unpack_upper": (_P, _I, _P),
    # data, len, bpp, width, height, bottom_up, palette (256 x 3 BGR), out (BGR)
    "yp_bmp_rle": (_P, ctypes.c_int64, _I, _I, _I, _I, _P, _P),
    # src, len, out, out bytes (TIFF LZW and PackBits of a strip or tile)
    "yp_tiff_lzw": (_P, ctypes.c_int64, _P, ctypes.c_int64),
    "yp_packbits": (_P, ctypes.c_int64, _P, ctypes.c_int64),
    # sub-blocks, len, min code size, out (indices), pixels
    "yp_gif_lzw": (_P, ctypes.c_int64, _I, _P, ctypes.c_int64),
    # data, len, width, height, out (R, G, B, E a pixel)
    "yp_hdr_rgbe": (_P, ctypes.c_int64, _I, _I, _P),
    # src, sh, sw, c, map (9 f32: the inverse for the perspective), dst, H, W
    "yp_cv_warp_perspective_u8": (_P, _I, _I, _I, _P, _P, _I, _I),
    "yp_cv_warp_affine_u8": (_P, _I, _I, _I, _P, _P, _I, _I),
    # src (n x 2 f32), dst, n, max_iters, confidence, h (9 f64), mask (n u8)
    "yp_find_homography": (_P, _P, _I, _I, ctypes.c_double, _P, _P),
    # data, frame, scans, nscans, huffman tables, out (i16 coefficients of every component)
    "yp_jpeg_coefficients": (_P, _P, _P, _I, _P, _P),
    # host_video.cpp. y, u, v, height, width, chroma stride, kind (0 4:2:0, 1 4:2:2,
    # 2 4:4:4, 3 grey), full range, out (BGR)
    "yp_yuv_to_bgr": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # coefficients (i16), blocks, quant (64 i32), out (u8 blocks)
    "yp_mjpeg_idct": (_P, ctypes.c_int64, _P, _P),
    # data, len, params (14 i32), matrices (128 i32), reference Y, U, V, out Y, U, V
    "yp_mpeg4_decode_vop": (_P, ctypes.c_int64, _P, _P, _P, _P, _P, _P, _P, _P),
    # host_zstd.cpp. src, n, dst, capacity, written (i64 out), message, message length
    "yp_zstd_decompress": (_P, ctypes.c_int64, _P, ctypes.c_int64, _P, ctypes.c_char_p, _I),
    # data, n, crc (u32 out)
    "yp_crc32c": (_P, ctypes.c_int64, _P),
}


def sources() -> list[Path]:
    """Every file under `csrc/` (all of them key the build; nvcc compiles the
    `.cu` and `.cpp`)."""
    return sorted(p for p in CSRC_DIR.iterdir() if p.is_file())


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + HOST_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyp_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple[Path, bool]:
    """Compile the kernels unless a library for these sources exists.

    Returns `(path, compiled)`. Raises with nvcc's output if it fails.
    """
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> tuple[Path, bool]:
    out = library_path()
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cpp")]):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        flags = compile_flags if src.suffix == ".cu" else HOST_FLAGS
        cmd = [_nvcc(), *flags, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    link = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc in procs:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
    except BaseException:
        for _, proc in procs:
            proc.kill()
            proc.wait()
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, True


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.yp_error_string.argtypes = (ctypes.c_int,)
    lib.yp_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().yp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtypes: tuple, ndim: int) -> None:
    """Argument checks shared by the kernel wrappers."""
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name} must be a tensor on the current CUDA device, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
