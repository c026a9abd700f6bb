#!/usr/bin/env python3
"""Kernel-alone times of variants of the port's warp kernel, in one process
on one card, for the PyTorch port.

Each variant is `yolopoint_tpu_torch/ops/csrc/warp.cu` with some constants
or calls replaced (`VARIANTS`), or another source given on the command line
(for example the parent commit's `warp.cu`), built alone by `nvcc` and
loaded with ctypes. At each input of `INPUTS` (the s640 train path's K4 and
K5 shapes, a 640x640 nearest mask, the export's warps back, a zoom-out) it
checks each variant against the plain version (`exact`: bit-equal, NaN at
the same pixels) and times its launches alone: 20 launches captured in one
CUDA graph, replayed, per launch, in two rounds (variants in order, then in
reverse). Prints one JSON line per input, then the card's name and power
limit.

    python3 tools/bench_torch_warp.py [--source NAME=PATH ...]

Variants:
  design        the source as it is;
  global_only   a window budget of 0: every tile with a tap in the frame
                samples from global memory;
  four_blocks   a 40 KB budget with 4 blocks per SM (64 registers);
  no_division   (not exact) w0 * w2 and w1 * w2 in place of the two
                divisions: what the correctly rounded divisions cost.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "warp.cu"
OUT_DIR = REPO / "yolopoint_tpu_torch" / "_build" / "bench_warp"
VARIANTS = {
    "design": {},
    "global_only": {"kWindowBytes = 24 * 1024": "kWindowBytes = 0"},
    "four_blocks": {"kWindowBytes = 24 * 1024": "kWindowBytes = 40 * 1024",
                    "kBlocksPerSm = 6": "kBlocksPerSm = 4"},
    "no_division": {"__fdiv_rn(w0, w2)": "__fmul_rn(w0, w2)",
                    "__fdiv_rn(w1, w2)": "__fmul_rn(w1, w2)"},
}
# B, H, W, C, mode, homographies (`chip_smoke.warp_homographies`)
INPUTS = (
    (32, 640, 640, 3, "bilinear", "s640"),
    (32, 80, 80, 1, "nearest", "s640"),
    (32, 640, 640, 1, "nearest", "s640"),
    (50, 640, 640, 1, "bilinear", "export_inverse"),
    (8, 640, 640, 3, "bilinear", "zoom_out"),
)


def build(name: str, text: str):
    """Compile one variant; its `yp_warp_image` with the signature the
    source declares (with or without the counter argument)."""
    from yolopoint_tpu_torch.ops import _build

    d = OUT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "warp.cu").write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "warp.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    fn = ctypes.CDLL(str(d / "lib.so")).yp_warp_image
    P, I = ctypes.c_void_p, ctypes.c_int
    counter = "global_tiles" in text
    fn.argtypes = (P, P, P, P, P, I, I, I, I, I) + ((P, P) if counter else (P,))
    fn.restype = ctypes.c_int
    return fn, counter


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another warp.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_warp: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops import geometry

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
    kernels = {name: build(name, text) for name, text in texts.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    for B, H, W, C, mode, homs in INPUTS:
        img = torch.rand(B, H, W, C, generator=gen, device="cuda")
        hom = chip_smoke.warp_homographies(gen, homs, B).reshape(-1, 3, 3).expand(B, 3, 3)
        hom = hom.contiguous()
        ref = geometry.warp_image_plain(img, hom, mode)
        ys, xs = geometry.grid_axes(H, W, img.device)
        line = {"shape": [B, H, W, C], "mode": mode, "homographies": homs}

        def launcher(fn, with_counter):
            def run():
                out = torch.empty_like(img)
                extra = (counter.data_ptr(),) if with_counter else ()
                code = fn(img.data_ptr(), hom.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                          out.data_ptr(), B, H, W, C, int(mode == "nearest"), *extra,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed with CUDA error {code}")
                return out
            return run

        runs = {name: launcher(*kernels[name]) for name in kernels}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            nan = ref.isnan()
            exact = torch.equal(got.isnan(), nan) and bool((torch.where(nan, 0.0, got - ref) == 0).all())
            line[name] = {"exact": exact, "kernel_ms": []}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                line[name]["kernel_ms"].append(chip_smoke.graph_ms(runs[name]))
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
