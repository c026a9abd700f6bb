#!/usr/bin/env python3
"""Kernel-alone times of variants of the port's keypoint NMS kernel (K1 tile
keys and K6 suppressed maps), in one process on one card.

Each variant is `yolopoint_tpu_torch/ops/csrc/nms_keys.cu` with some
constants replaced (`VARIANTS`), or another source given on the command
line (for example the parent commit's `nms_keys.cu`), built alone by `nvcc`
(all builds started together) and loaded with ctypes. At each input of
`INPUTS` (K1 at the serve path's batch 16 and batch 1 and at batch 8 f32;
K6 at the untiled serve path's radius 3, at radius 4, and a small f32 map at
radius 7) it checks each variant against the plain version (`exact`:
bit-equal) and times its launches alone: 20 launches captured in one CUDA
graph, replayed, per launch, in two rounds (variants in order, then in
reverse). Prints one JSON line per input (with the bound of
`chip_smoke.nms_bound`), then the card's name and power limit.

    python3 tools/bench_torch_nms.py [--source NAME=PATH ...]

Variants:
  design      the source as it is;
  small_only  every launch takes the small interior (32 x 64);
  large_only  every launch takes the large interior (64 x 128).
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "nms_keys.cu"
OUT_DIR = REPO / "yolopoint_tpu_torch" / "_build" / "bench_nms"
VARIANTS = {
    "design": {},
    "small_only": {"kLargeTH = 64;": "kLargeTH = 32;", "kLargeTW = 128;": "kLargeTW = 64;"},
    "large_only": {"kSmallTH = 32;": "kSmallTH = 64;", "kSmallTW = 64;": "kSmallTW = 128;"},
}
CONF, ITERATIONS, BORDER = 0.015, 3, 4
# kernel, B, H, W, dtype, radius
INPUTS = (
    ("K1", 16, 640, 640, torch.bfloat16, 4),
    ("K1", 1, 640, 640, torch.bfloat16, 4),
    ("K1", 8, 640, 640, torch.float32, 4),
    ("K6", 16, 640, 640, torch.bfloat16, 3),
    ("K6", 16, 640, 640, torch.bfloat16, 4),
    ("K6", 2, 101, 94, torch.float32, 7),
)


def has_scratch(text: str) -> bool:
    """Whether a source's entry points take the global branch's scratch
    pointer after the output (older sources have no such argument)."""
    return re.search(r"yp_nms_tile_keys\([^)]*scratch", text) is not None


def build_all(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile every variant, all nvcc processes at once; raises with the
    compiler's output if one fails. Each library gets its source's
    signatures and a `scratch` flag."""
    from yolopoint_tpu_torch.ops import _build

    procs = {}
    for name, text in texts.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "nms_keys.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "nms_keys.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(OUT_DIR / name / "lib.so"))
        lib.scratch = has_scratch(texts[name])
        for fn in ("yp_nms_tile_keys", "yp_nms_suppressed_map"):
            sig = _build._SIGNATURES[fn]
            getattr(lib, fn).argtypes = sig if lib.scratch else sig[:3] + sig[4:]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, kernel, hm, radius):
    """One launch of `lib`'s K1 or K6 on `hm`, into a new output tensor."""
    B, H, W = hm.shape
    bf16 = int(hm.dtype == torch.bfloat16)

    scratch = (None,) if lib.scratch else ()  # every input here fits an interior

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "K1":
            out = torch.empty((B, (H // radius) * (W // radius)), dtype=torch.int32,
                              device=hm.device)
            code = lib.yp_nms_tile_keys(hm.data_ptr(), bf16, out.data_ptr(), *scratch, B, H, W,
                                        CONF, radius, ITERATIONS, BORDER, radius, stream)
        else:
            out = torch.empty((B, H, W), dtype=torch.float32, device=hm.device)
            code = lib.yp_nms_suppressed_map(hm.data_ptr(), bf16, out.data_ptr(), *scratch, B, H,
                                             W, CONF, radius, ITERATIONS, BORDER, stream)
        if code:
            raise RuntimeError(f"{kernel} launch failed with CUDA error {code}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another nms_keys.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_nms: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops.cuda_nms import nms_suppressed_map_torch, nms_tile_keys_torch

    set_determinism()
    base = SOURCE.read_text()
    texts = {}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: '{old}' is not in {SOURCE.name}")
            text = text.replace(old, new)
        texts[name] = text
    for spec in args.source:
        name, path = spec.split("=", 1)
        texts[name] = Path(path).read_text()
    libs = build_all(texts)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for kernel, B, H, W, dtype, radius in INPUTS:
        hm = chip_smoke.heatmap_batch(gen, B, H, W, dtype)
        if kernel == "K1":
            ref = nms_tile_keys_torch(hm, CONF, radius, ITERATIONS, BORDER, radius)
        else:
            ref = nms_suppressed_map_torch(hm, CONF, radius, ITERATIONS, BORDER).view(torch.int32)
        bound_ms, bound_by = chip_smoke.nms_bound(hm, ref, radius, ITERATIONS)
        line = {"kernel": kernel, "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
                "radius": radius, "bound_ms": bound_ms, "bound_by": bound_by}
        runs = {name: launcher(lib, kernel, hm, radius) for name, lib in libs.items()}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            exact = torch.equal(got.view(torch.int32), ref)
            line[name] = {"exact": exact, "kernel_ms": []}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                line[name]["kernel_ms"].append(chip_smoke.graph_ms(runs[name]))
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
