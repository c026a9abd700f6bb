#!/usr/bin/env python3
"""Where a serving request's time goes on the GPU, for the PyTorch port.

Runs YOLOPoint-S (nc=80, 640x640, bf16, BN folded, seeded random weights)
through `yolopoint_tpu_torch`'s `InferencePipeline` at the benchmark
operating point (the one `chip_smoke.py` serves), and for batch 1 and 16
profiles, with `torch.profiler`, a steady window of whole requests (uint8
upload + forward + decode), of the forward alone and of the decode alone
(on fixed forward outputs). Prints one JSON line per (batch, stage): host
wall time per request, device kernel time per request, the device's busy
share of the window (union of kernel intervals over the window), the
number of kernels per request, and the kernels (grouped by template) that
take the most device time.

    python3 tools/profile_torch_serve.py [--requests 10]

The profiler adds host overhead, so wall times here run above the ones
`chip_smoke.py` measures without it; device kernel times are unaffected.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespace noise and template
    or argument lists, so that instances of one template add up."""
    n = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    for ch in "<(":
        i = n.find(ch)
        if i > 0:
            n = n[:i]
    return n.strip()


def profile_stage(fn, requests: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_name: dict[str, float] = {}
    for e, (s, t) in zip(kernels, spans):
        by_name[short_name(e.name)] = by_name.get(short_name(e.name), 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    kernel_us = sum(by_name.values())
    window_us = (max(t for _, t in spans) - min(s for s, _ in spans)) if spans else 0.0
    return {
        "wall_ms_per_request": wall_s * 1e3 / requests,
        "device_ms_per_request": kernel_us / 1e3 / requests,
        "busy_share": busy_us(spans) / (wall_s * 1e6),
        "busy_share_of_kernel_window": busy_us(spans) / window_us if window_us else 0.0,
        "kernels_per_request": len(kernels) / requests,
        "top_kernels_ms_per_request": {n: us / 1e3 / requests for n, us in top},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.frontend import InferencePipeline

    set_determinism()
    pipe = InferencePipeline(chip_smoke.folded_yolopoint_s(0, torch.bfloat16, "cuda"),
                             chip_smoke.SERVE_CONFIG, compute_dtype=torch.bfloat16,
                             device="cuda")
    gen = torch.Generator().manual_seed(2)
    with torch.inference_mode():
        for B in (1, 16):
            frames = torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8, generator=gen)
            x = frames.cuda()
            raw = pipe.forward(x)
            stages = {
                "request": lambda: pipe(frames),  # host upload + forward + decode
                "forward": lambda: pipe.forward(x),
                "decode": lambda: pipe.decode(raw),
            }
            for stage, fn in stages.items():
                line = {"batch": B, "stage": stage, **profile_stage(fn, args.requests)}
                print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
