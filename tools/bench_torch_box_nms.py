#!/usr/bin/env python3
"""Kernel-alone times of variants of the port's greedy box-NMS kernel (K2),
in one process on one card.

Each variant is `yolopoint_tpu_torch/ops/csrc/box_nms.cu` with some
constants replaced (`VARIANTS`), or another source given on the command
line (for example the parent commit's `box_nms.cu`, whose entry point takes
no arrival counters), built alone by `nvcc` (all builds started together)
and loaded with ctypes. At each input (random boxes as `chip_smoke.check_k2`
makes them at the serve path's (16, 512), at (8, 1024), (4, 2048) and
(1, 512); (16, 512) with no valid box, the serve path's case with seeded
weights; and the tiles of one val batch, `chip_smoke.record_val_tiles`) it
checks each variant against the plain version (`exact`: every keep mask
equal) and times its launches alone: the launches captured in one CUDA graph,
replayed, per launch, in two rounds (variants in order, then in reverse).
Prints one JSON line per input (with `chip_smoke.k2_bound`), then the card's
name and power limit.

    python3 tools/bench_torch_box_nms.py [--source NAME=PATH ...]

Variants:
  design      the source as it is;
  eight_warps every launch takes 8-warp mask CTAs (no fill rule);
  one_warp    every launch takes 1-warp mask CTAs;
  depth4      the scan fetches three column words ahead (four buffers);
  depth8      the scan fetches seven column words ahead.
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
SOURCE = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "box_nms.cu"
OUT_DIR = REPO / "yolopoint_tpu_torch" / "_build" / "bench_box_nms"
VARIANTS = {
    "design": {},
    "eight_warps": {"kFillCtas = 2 * kSms;": "kFillCtas = 0;"},
    "one_warp": {"kMaxWarps = 8;": "kMaxWarps = 1;"},
    "depth4": {"kScanDepth = 2;": "kScanDepth = 4;"},
    "depth8": {"kScanDepth = 2;": "kScanDepth = 8;"},
}
IOU = 0.45
RANDOM_INPUTS = ((16, 512), (8, 1024), (4, 2048), (1, 512))  # B, K


def has_arrivals(text: str) -> bool:
    """Whether a source's entry point takes the arrival counters after the
    mask scratch (older sources have no such argument)."""
    return re.search(r"yp_greedy_nms\([^)]*arrivals", text) is not None


def build_all(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile every variant, all nvcc processes at once; raises with the
    compiler's output if one fails. Each library gets its source's
    signature and an `arrivals` flag."""
    from yolopoint_tpu_torch.ops import _build

    procs = {}
    for name, text in texts.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "box_nms.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "box_nms.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(OUT_DIR / name / "lib.so"))
        lib.arrivals = has_arrivals(texts[name])
        sig = _build._SIGNATURES["yp_greedy_nms"]
        lib.yp_greedy_nms.argtypes = sig if lib.arrivals else sig[:4] + sig[5:]
        lib.yp_greedy_nms.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, tiles):
    """A function that launches `lib`'s K2 once on each `(boxes, valid,
    thr)` of `tiles`, into new keep masks, with scratch allocated here."""
    B, K = tiles[0][1].shape
    nw = -(-K // 32)
    dev = tiles[0][0].device
    mask = torch.empty(B * nw * (nw * 32 if lib.arrivals else K), dtype=torch.int32, device=dev)
    arrivals = torch.zeros(B, dtype=torch.int32, device=dev) if lib.arrivals else None
    keeps = [torch.empty((B, K), dtype=torch.bool, device=dev) for _ in tiles]

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        extra = () if arrivals is None else (arrivals.data_ptr(),)
        for keep, (boxes, valid, thr) in zip(keeps, tiles):
            code = lib.yp_greedy_nms(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                     mask.data_ptr(), *extra, B, K, thr, stream)
            if code:
                raise RuntimeError(f"K2 launch failed with CUDA error {code}")
        return keeps
    return launch


def run(libs, name, tiles, refs) -> dict:
    """One input: each library checked and timed; the line's fields."""
    import chip_smoke

    bound_ms, bound_by = chip_smoke.k2_bound(tiles)
    line = {"input": name, "shape": list(tiles[0][1].shape), "tiles": len(tiles),
            "valid": int(sum(int(v.sum()) for _, v, _ in tiles)),
            "bound_ms": bound_ms / len(tiles), "bound_by": bound_by}
    fns = {lib_name: launcher(lib, tiles) for lib_name, lib in libs.items()}
    for lib_name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        line[lib_name] = {"exact": all(torch.equal(g, r) for g, r in zip(got, refs)),
                          "kernel_ms": []}
    for order in (list(fns), list(fns)[::-1]):
        for lib_name in order:
            ms = chip_smoke.graph_ms(fns[lib_name], count=max(20 // len(tiles), 2))
            line[lib_name]["kernel_ms"].append(ms / len(tiles))
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another box_nms.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_box_nms: no CUDA device is available", file=sys.stderr)
        return 2
    # the script's own directory holds tools/profile.py, which would shadow
    # the standard library's `profile` (torch imports it)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep_torch

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
    for B, K in RANDOM_INPUTS:
        tiles = [(*chip_smoke.nms_boxes(gen, B, K), IOU)]
        refs = [greedy_nms_keep_torch(b, v, t) for b, v, t in tiles]
        print(json.dumps(run(libs, f"random {B}x{K}", tiles, refs)), flush=True)
    # the serve path's case with seeded weights: no box passes the gate
    boxes, valid = chip_smoke.nms_boxes(gen, 16, 512)
    tiles = [(boxes, torch.zeros_like(valid), IOU)]
    print(json.dumps(run(libs, "invalid 16x512", tiles, [tiles[0][1]])), flush=True)
    tiles = chip_smoke.record_val_tiles(seed=0)
    refs = [greedy_nms_keep_torch(b, v, t) for b, v, t in tiles]
    print(json.dumps(run(libs, "val tiles", tiles, refs)), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
