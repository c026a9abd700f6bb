#!/usr/bin/env python3
"""What the bf16 casts of the port's convolutions and SiLU cost the serving
path, in one process on one card.

The port adds a bf16 conv's bias to the convolution already rounded to bf16,
as the JAX package does (`models.blocks.Conv2d`), and takes the SiLU's
sigmoid in f32 (`F.silu`), where the JAX program rounds each of its steps
(`x * (1 / (1 + exp(-x)))`) to bf16. YOLOPoint-S (nc=80, 640x640, bf16, BN
folded, seeded random weights) serves uint8 batches of 1 and 16 at the
benchmark operating point, as `tools/profile_torch_serve.py` does, with:
  port             the port as it is;
  torch_bias       `nn.Conv2d`'s own bias (cuDNN adds it after the
                   convolution as well: the same numbers);
  jax_silu_steps   the JAX program's SiLU as its five bf16 operations;
  jax_silu_table   the same SiLU as one gather from a table of its value at
                   every bf16 input (65536 entries).
Each runs in turns (in order, then in reverse) and prints the p50 and
minimum of host wall time of `--requests` whole requests (upload, forward,
decode, synchronized) and the median time of the forward between CUDA
events. Then the card's name and power limit.

    python3 tools/bench_torch_serve_casts.py [--requests 30]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]


def jax_silu_steps(x: torch.Tensor) -> torch.Tensor:
    """The JAX program's SiLU, each step in the tensor's type."""
    return x * (1 / (1 + torch.exp(-x)))


@contextlib.contextmanager
def casts(name: str, device: torch.device):
    """The port's blocks with the casts of `name` while inside."""
    from yolopoint_tpu_torch.models import blocks

    saved = F.silu, blocks.Conv2d.forward
    plain_silu = F.silu
    if name == "torch_bias":
        blocks.Conv2d.forward = torch.nn.Conv2d.forward
    elif name == "jax_silu_steps":
        F.silu = lambda x, inplace=False: (jax_silu_steps(x) if x.dtype == torch.bfloat16
                                           else plain_silu(x))
    elif name == "jax_silu_table":
        bits = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        table = jax_silu_steps(bits).to(device)  # indexed by the bits read as int16
        F.silu = lambda x, inplace=False: (table[x.view(torch.int16).int()]
                                           if x.dtype == torch.bfloat16 else plain_silu(x))
    try:
        yield
    finally:
        F.silu, blocks.Conv2d.forward = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_serve_casts: no CUDA device is available", file=sys.stderr)
        return 2
    # `tools/profile.py` would shadow the standard `profile` module
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.frontend import InferencePipeline

    set_determinism()
    pipe = InferencePipeline(chip_smoke.folded_yolopoint_s(0, torch.bfloat16, "cuda"),
                             chip_smoke.SERVE_CONFIG, compute_dtype=torch.bfloat16,
                             device="cuda")
    gen = torch.Generator().manual_seed(2)
    names = ("port", "torch_bias", "jax_silu_steps", "jax_silu_table")
    with torch.inference_mode():
        for B in (1, 16):
            frames = torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8, generator=gen)
            x = frames.cuda()
            for name in names + names[::-1]:
                with casts(name, x.device):
                    for _ in range(3):  # warm-up
                        pipe(frames)
                    torch.cuda.synchronize()
                    wall = []
                    for _ in range(args.requests):
                        t0 = time.perf_counter()
                        pipe(frames)
                        torch.cuda.synchronize()
                        wall.append((time.perf_counter() - t0) * 1e3)
                    forward_ms = chip_smoke.cuda_ms(lambda: pipe.forward(x), args.requests)
                print(json.dumps({"batch": B, "casts": name, "request_ms_p50":
                                  statistics.median(wall), "request_ms_min": min(wall),
                                  "forward_ms": forward_ms}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
