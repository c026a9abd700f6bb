#!/usr/bin/env python3
"""Kernel-alone times of the port's descriptor sampling kernel (K3) and its
variants, in one process on one card.

`yolopoint_tpu_torch/ops/csrc/gather.cu` (`design`) is built alone by
`nvcc` with `-Xptxas -v`, beside its source variants (`VARIANTS`, string
substitutions on the file) and any other source given on the command line
(for example the parent commit's `gather.cu`), all builds started together;
each build's registers and spills a kernel are printed. At each input of
`INPUTS` (every K3 shape of the main path and of the other paths: the serve
path at batch 16 and 1, SuperPointNet, the KITTI and ROS frames, the KITTI
val, the bootstrap, bf16 and the widths 64, 192 and 320) and on the trained
flagship's recorded serving batch, each build is checked against the plain
version (within 1e-5) and its launches alone are timed in two rounds
(builds in order, then in reverse): `kernel_ms` with the inputs read from
memory (`chip_smoke.k3_memory_ms`: launches under a CUDA graph cycling
through copies of the map and points), `kernel_l2_ms` with one input
replayed (`chip_smoke.graph_ms`: it stays in the L2). Each line also holds
the bound (`chip_smoke.k3_bound`), the plain version's and the library's
(`F.grid_sample` + `F.normalize`) times, and an empty kernel's launch under
the same graph harness at the design's grid (the floor a launch pays
whatever it does). Then the card's name and power limit.

    python3 tools/bench_torch_gather.py [--source NAME=PATH ...]

Variants:
  generic     every width takes the generic instantiation (scalar loads);
  threads128  blocks of four warps (kThreads = 128);
  lanes8      8 lanes a point at every family width;
  lanes32     32 lanes a point at D = 128 and 256 (16 at 64, 192, 320);
  points2/4   2 or 4 points a lane group, all their tap loads issued first.
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

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "gather.cu"
OUT_DIR = REPO / "yolopoint_tpu_torch" / "_build" / "bench_gather"
VARIANTS = {
    "generic": {"  if (aligned) {\n": "  if (aligned && false) {\n"},
    "threads128": {"kThreads = 64;": "kThreads = 128;"},
    "lanes8": {"kFamilyLanes = 16;": "kFamilyLanes = 8;"},
    "lanes32": {"return d == 0 ? 32 : kFamilyLanes;": "return d % 128 == 0 ? 32 : kFamilyLanes;"},
    "points2": {"kPoints = 1;": "kPoints = 2;"},
    "points4": {"kPoints = 1;": "kPoints = 4;"},
}
DESIGN_BLOCK = (64, 4)  # the design's threads and points a block, for the empty kernel's grid
# B, Hc, Wc, D, N, dtype, the path whose shape it is
INPUTS = (
    (16, 80, 80, 128, 1000, torch.float32, "serve"),
    (1, 80, 80, 128, 1000, torch.float32, "serve (batch 1)"),
    (8, 80, 80, 128, 1000, torch.bfloat16, None),
    (16, 80, 80, 256, 1000, torch.float32, "serve_families (SuperPointNet)"),
    (8, 80, 80, 256, 1000, torch.float32, "fit_SuperPointNet (val)"),
    (1, 32, 40, 256, 1000, torch.float32, "hpatches_superpoint"),
    (1, 36, 120, 128, 600, torch.float32, "serve_kitti"),
    (1, 44, 80, 128, 600, torch.float32, "ros"),
    (8, 36, 112, 128, 600, torch.float32, "fit_kitti (val)"),
    (16, 32, 40, 64, 600, torch.float32, "bootstrap (val)"),
    (1, 32, 40, 64, 1000, torch.float32, "bootstrap (hpatches)"),
    (16, 80, 80, 192, 1000, torch.float32, None),
    (1, 80, 80, 192, 1000, torch.float32, None),
    (16, 80, 80, 320, 1000, torch.bfloat16, None),
    (1, 80, 80, 320, 1000, torch.float32, None),
)
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int yp_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def ptxas_report(log: str) -> list[dict]:
    """Registers and spills a kernel from `-Xptxas -v` output."""
    kernels, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            kernels.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kernels[-1]["registers"] = int(m.group(1))
    names = [k["kernel"] for k in kernels]
    try:  # demangled where the host has c++filt
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        for k, n in zip(kernels, out):
            k["kernel"] = n
    except (OSError, subprocess.CalledProcessError):
        pass
    return kernels


def build_all(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Compile every source, all nvcc processes at once, with `-Xptxas -v`;
    raises with the compiler's output if one fails. Prints each source's
    kernels' registers and spills."""
    from yolopoint_tpu_torch.ops import _build

    procs = {}
    for name, text in texts.items():
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "gather.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "lib.so"),
               str(d / "gather.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(OUT_DIR / name / "lib.so"))
        if name == "empty":
            lib.yp_empty.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
            lib.yp_empty.restype = ctypes.c_int
        else:
            print(json.dumps({"ptxas": name, "kernels": ptxas_report(out + err)}), flush=True)
            lib.yp_sample_descriptors.argtypes = _build._SIGNATURES["yp_sample_descriptors"]
            lib.yp_sample_descriptors.restype = ctypes.c_int
        libs[name] = lib
    return libs


def runner(lib):
    """`run(desc, pts)`: one launch of `lib`'s K3 into a new output tensor."""
    def run(desc, pts):
        B, Hc, Wc, D = desc.shape
        N = pts.shape[1]
        out = torch.empty((B, N, D), dtype=torch.float32, device=desc.device)
        code = lib.yp_sample_descriptors(desc.data_ptr(), int(desc.dtype == torch.bfloat16),
                                         pts.data_ptr(), out.data_ptr(), B, Hc, Wc, D, N, 8,
                                         torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"K3 launch failed with CUDA error {code}")
        return out
    return run


def trained_input() -> tuple[torch.Tensor, torch.Tensor]:
    """K3's input on the trained flagship's serving batch, recorded as
    `chip_smoke.jax_weights_serve` serves it."""
    import chip_smoke
    from yolopoint_tpu_torch.data.synthetic import SyntheticShapes
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, deploy_model

    run = REPO / "artifacts" / chip_smoke.JAX_RUNS[0]
    meta = json.loads((run / "best_meta.json").read_text())
    with chip_smoke.compiled_codec_only():
        model, dtype, names, _ = deploy_model(str(run), "YOLOPoint", "s", None, f32=False)
    pipe = InferencePipeline(model, chip_smoke.SERVE_CONFIG, compute_dtype=dtype)
    shapes = SyntheticShapes(meta["config"]["data"], "val", names)
    frames = torch.from_numpy(
        np.stack([shapes.get(i)["image"] for i in range(chip_smoke.JAX_SERVE_BATCH)]))
    with chip_smoke.kernel_input_probes() as rec:
        pipe(frames)
    (desc, pts, _), = rec["k3"].values()
    return desc, pts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH",
                    help="another gather.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_gather: no CUDA device is available", file=sys.stderr)
        return 2
    # `tools/profile.py` would shadow the standard `profile` module
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops import _build, cuda_gather

    set_determinism()
    base = SOURCE.read_text()
    texts = {"design": base}
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
    texts["empty"] = EMPTY
    libs = build_all(texts)
    empty = libs.pop("empty")
    _build.library()  # the port's own build, for the trained input's pipeline

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for B, Hc, Wc, D, N, dtype, path in INPUTS:
        desc = torch.randn(B, Hc, Wc, D, generator=gen, device="cuda")
        desc = (desc / desc.norm(dim=-1, keepdim=True)).to(dtype)
        xm, ym = Wc * 8 - 1.0, Hc * 8 - 1.0
        pts = torch.rand(B, N, 2, generator=gen, device="cuda") * torch.tensor([xm, ym],
                                                                                device="cuda")
        cases.append((desc, pts, path))
    cases.append((*trained_input(), "jax_weights_serve (trained flagship)"))

    runs = {name: runner(lib) for name, lib in libs.items()}
    for desc, pts, path in cases:
        B, Hc, Wc, D = desc.shape
        N = pts.shape[1]
        ref = cuda_gather.sample_descriptors_torch(desc, pts, 8)
        bound_ms, bound_by = chip_smoke.k3_bound(desc, pts, 8)
        blocks = -(-B * N // DESIGN_BLOCK[1])
        line = {"path": path, "shape": [B, Hc, Wc, D, N], "dtype": str(desc.dtype)[6:],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "plain_ms": chip_smoke.cuda_ms(
                    lambda: cuda_gather.sample_descriptors_torch(desc, pts, 8), 5),
                "library_ms": chip_smoke.cuda_ms(chip_smoke.k3_library(desc, pts, 8), 10),
                "empty_kernel_ms": chip_smoke.graph_ms(
                    lambda: empty.yp_empty(blocks, DESIGN_BLOCK[0],
                                           torch.cuda.current_stream().cuda_stream))}
        for name, run in runs.items():
            got = run(desc, pts)
            torch.cuda.synchronize()
            line[name] = {"max_abs_err": float((got - ref).abs().max()), "kernel_ms": [],
                          "kernel_l2_ms": []}
            if not line[name]["max_abs_err"] <= 1e-5:
                raise AssertionError(f"{name} at {line['shape']}: {line[name]['max_abs_err']}")
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                run = runs[name]
                line[name]["kernel_ms"].append(chip_smoke.k3_memory_ms(desc, pts, 8, run))
                line[name]["kernel_l2_ms"].append(chip_smoke.graph_ms(lambda: run(desc, pts)))
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
