"""Build and load the port's CUDA kernels.

All `.cu` sources under `ops/csrc/` are compiled, one `nvcc` process each,
all started together, and linked into one shared library with a plain
`extern "C"` interface, which is loaded with ctypes. No source includes PyTorch's headers, so the build takes seconds,
not the minutes a `torch.utils.cpp_extension` build takes. The library goes
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
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches by wrapper name (the warp counts under the Pallas kernel
# it replaced, "K4" or "K5", and the suppressed map under "K6"; the keypoint
# NMS's global-memory branch under "nms_tile_keys_global" and "K6_global").
# A wrapper adds one exactly where it launches its kernel, so a caller can
# show that a path went through it.
launch_counts: collections.Counter = collections.Counter()

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
}


def sources() -> list[Path]:
    """Every file under `csrc/` (all of them key the build; nvcc compiles the `.cu`)."""
    return sorted(p for p in CSRC_DIR.iterdir() if p.is_file())


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    out = library_path()
    if out.exists():
        return out, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
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
