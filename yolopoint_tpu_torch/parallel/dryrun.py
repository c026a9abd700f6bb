"""The port's multi-device dry run: the twin of the JAX package's
`__graft_entry__.dryrun_multichip`.

    python -m yolopoint_tpu_torch.parallel.dryrun --nproc N [--device cuda|cpu]
        [--backend nccl|gloo] [--timeout SECONDS]

Starts N processes, one rank each, that join one process group (NCCL on
the card, gloo on the CPU; `--backend gloo` lets ranks share a card) and
run, on the JAX gate's tiny shapes:
  1. one data-parallel train step: YOLOPoint-n, nc = 3, 32x32, one sample a
     rank, photometric and homographic augmentation and the warped pair on;
     the loss must be finite and the parameters must move, equally on every
     rank;
  2. the EMA + accumulation check of a micro conv model under the same
     all-reduce (`_spmd_ema_accum_microcheck`): the parameters hold
     mid-accumulation, move after the window, and the EMA shadow moves;
  3. the spatially sharded forward (`parallel.spatial`) on a
     `(max(N / 4, 1), N / that)` layout: the gathered `semi` finite and
     within 1e-4 of the whole-image forward. Its images are 32 rows a
     spatial shard (the JAX gate splits 32 rows over the mesh, which the
     partitioner pads; here a shard holds whole stride-32 rows);
and an all-reduce of ones on the ranks' devices (so a world of one still
calls the backend once). Rank 0 prints the JAX gate's summary line,
`dryrun_multichip(N): loss=... param_delta=... spatial_semi=(B, Hc, Wc, 65)
wall=...s OK`. The workers share a deadline (`parallel.launch`); a failing
or late worker fails the run (exit code 1) and the others are stopped.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

NC, H, W = 3, 32, 32
AUG = {
    "photometric": {
        "enable": True,
        "params": {"random_brightness": {"max_abs_change": 20},
                   "random_contrast": {"strength_range": [0.7, 1.3]},
                   "additive_gaussian_noise": {"stddev_range": [0, 8]}},
        "params_light": {"random_brightness": {"max_abs_change": 20}},
    },
    "homographic": {
        "enable": True,
        "params": {"perspective": True, "scaling": True, "rotation": True,
                   "translation": True, "patch_ratio": 0.85},
        "valid_border_margin": 2,
    },
    "warped_pair": {},
}


def _global_batch(n: int) -> dict:
    """The JAX gate's batch: one sample a rank, from `default_rng(0)`."""
    import numpy as np

    rng = np.random.default_rng(0)
    return {
        "image": rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32),
        "points": rng.uniform(0, H - 4, (n, 16, 2)).astype(np.float32),
        "point_mask": np.ones((n, 16), bool),
        "boxes": np.concatenate([rng.integers(0, NC, (n, 4, 1)).astype(np.float32),
                                 rng.uniform(0.3, 0.7, (n, 4, 2)).astype(np.float32),
                                 rng.uniform(0.1, 0.3, (n, 4, 2)).astype(np.float32)], -1),
        "box_mask": np.ones((n, 4), bool),
    }


def _l1_delta(a, b) -> float:
    return float(sum((x - y).abs().sum() for x, y in zip(a, b)))


def _same_on_ranks(values, mesh, what: str) -> None:
    from yolopoint_tpu_torch.parallel.mesh import all_gather_rows

    flat = all_gather_rows(values[None].to(mesh.device), mesh)
    if not bool((flat == flat[0]).all()):
        raise AssertionError(f"{what} differ between ranks")


def ema_accum_microcheck(mesh) -> None:
    """Gradient accumulation (2 micro-steps) and EMA under the all-reduce,
    on a micro conv model: held mid-window, moved after it, EMA moved."""
    import torch

    from yolopoint_tpu_torch.parallel.mesh import all_reduce_mean, shard_batch
    from yolopoint_tpu_torch.training.ema import ema_update
    from yolopoint_tpu_torch.training.state import make_optimizer

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.SiLU(),
                                torch.nn.Conv2d(8, 4, 3, padding=1)).to(mesh.device)
    x = shard_batch(torch.ones((mesh.size * 2, 3, 8, 8), device=mesh.device), mesh)
    opt = make_optimizer(model, learning_rate=1e-2, accumulate_steps=2)
    params = dict(model.named_parameters())
    ema = {k: v.detach().clone() for k, v in params.items()}
    snaps = [[p.detach().clone() for p in params.values()]]
    emas = [[e.clone() for e in ema.values()]]
    for count in (1, 2):
        for p in params.values():
            p.grad = None
        (model(x) ** 2).mean().backward()
        grads = [p.grad for p in params.values()]
        all_reduce_mean(grads, mesh)
        opt.update(grads)
        ema_update(ema, params, count, decay=0.99, tau=1.0)
        snaps.append([p.detach().clone() for p in params.values()])
        emas.append([e.clone() for e in ema.values()])
    if _l1_delta(snaps[0], snaps[1]) != 0:
        raise AssertionError("micro params moved mid-accumulation (the window should hold)")
    if not _l1_delta(snaps[0], snaps[2]) > 0:
        raise AssertionError("micro optimizer produced no update after the accumulation window")
    if not _l1_delta(emas[0], emas[2]) > 0:
        raise AssertionError("micro EMA shadow did not move")


def worker(rank: int, n: int, addr: str, device: str, backend: str | None = None) -> None:
    t0 = time.perf_counter()
    import numpy as np
    import torch
    import torch.distributed as dist

    from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.parallel.mesh import (
        broadcast_tensors,
        initialize_multi_host,
        shard_batch,
        shutdown,
    )
    from yolopoint_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_mesh,
        shard_images,
        spatial_sharded_forward,
    )
    from yolopoint_tpu_torch.training.agent import rank_seed
    from yolopoint_tpu_torch.training.state import create_train_state, make_optimizer
    from yolopoint_tpu_torch.training.step import (
        LossWeights,
        draw_step,
        make_train_step,
        rescale_yolo_gains,
    )
    from yolopoint_tpu_torch.utils.device import set_determinism

    torch.set_num_threads(max((os.cpu_count() or 2) // n, 1))
    set_determinism()
    mesh = initialize_multi_host(addr, n, rank, device=device, backend=backend)
    dev = mesh.device
    say = print if mesh.is_main else (lambda *a, **k: None)
    try:
        ones = torch.ones(1, device=dev)
        dist.all_reduce(ones)
        if float(ones) != n:
            raise AssertionError(f"all-reduce of ones gave {float(ones)} on {n} ranks")

        torch.manual_seed(0)
        model = build_model("YOLOPoint", "n", nc=NC, device=dev)
        broadcast_tensors(list(model.parameters()) + list(model.buffers()), mesh)
        opt = make_optimizer(model, learning_rate=1e-3, lrf=0.1, total_epochs=2,
                             steps_per_epoch=2)
        state = create_train_state(model, opt)
        weights = LossWeights(num_samples_per_image=8, num_masked_non_matches_per_match=4)
        step = make_train_step(model, AUG, rescale_yolo_gains(ObjectLossConfig(), NC, W),
                               weights, NC, mesh=mesh)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in shard_batch(_global_batch(n), mesh).items()}
        gen = torch.Generator(device=dev).manual_seed(rank_seed(1, rank))
        draws = draw_step(gen, tuple(batch["image"].shape), AUG, weights)
        say(f"dryrun_multichip: setup done at t+{time.perf_counter() - t0:.1f}s; running the "
            "data-parallel train step", flush=True)
        before = [p.detach().clone() for p in model.parameters()]
        aux = step(state, batch, draws)
        loss = float(aux["loss"])
        say(f"dryrun_multichip: train step done at t+{time.perf_counter() - t0:.1f}s",
            flush=True)
        if not np.isfinite(loss) or float(aux["nonfinite_skip"]):
            raise AssertionError(f"non-finite loss {loss}")
        delta = _l1_delta(before, [p.detach() for p in model.parameters()])
        if not delta > 0:
            raise AssertionError("optimizer produced no update")
        _same_on_ranks(torch.cat([p.detach().reshape(-1) for p in model.parameters()]), mesh,
                       "parameters after the step")

        ema_accum_microcheck(mesh)
        say(f"dryrun_multichip: EMA+accum microcheck done at "
            f"t+{time.perf_counter() - t0:.1f}s", flush=True)

        sp = make_spatial_mesh(mesh, data=max(n // 4, 1))
        images = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (n, 3, H * sp.spatial, W)).astype(np.float32)).to(dev)
        out = gather_spatial(spatial_sharded_forward(model, sp)(shard_images(images, sp)), sp)
        with torch.no_grad():
            ref = model.eval()(images)
        semi = out["semi"]
        err = float((semi - ref["semi"]).abs().max())
        if not bool(torch.isfinite(semi).all()) or err > 1e-4:
            raise AssertionError(f"spatial forward: finite {bool(torch.isfinite(semi).all())}, "
                                 f"max error against the whole image {err}")
        wall = time.perf_counter() - t0
        shape = tuple(semi.permute(0, 2, 3, 1).shape)  # the JAX gate's NHWC
        say(f"dryrun_multichip({n}): loss={loss:.4f} param_delta={delta:.3e} "
            f"spatial_semi={shape} wall={wall:.1f}s OK", flush=True)
    finally:
        shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                        help="default: the GPU (ranks that outnumber the cards need --backend "
                             "gloo)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl on cuda, gloo on cpu; gloo lets ranks share a card")
    parser.add_argument("--timeout", type=float, default=300.0,
                        help="seconds the workers may take, start-up included")
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--addr", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.nproc, args.addr, args.device, args.backend)
        return 0

    from yolopoint_tpu_torch.parallel.launch import run_ranks

    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cmd = [sys.executable, "-m", "yolopoint_tpu_torch.parallel.dryrun", "--nproc",
           str(args.nproc), "--device", args.device]
    cmd += ["--backend", args.backend] if args.backend else []
    try:
        done = run_ranks(args.nproc, lambda r, addr: cmd + ["--addr", addr, "--worker", str(r)],
                         args.timeout, env=env, capture=False)
    except TimeoutError:
        print(f"dryrun: a worker took more than {args.timeout:.0f} s", file=sys.stderr)
        return 1
    codes = [code for code, _ in done]
    if any(codes):
        print(f"dryrun: workers exited with {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
