"""Gloo worker processes for the port's data-parallel tests (no JAX here).

`run_workers(n, "module:function", inputs, tmp)` starts `n` Python processes
(`python -m tests.torch_dist`, through `parallel.launch.run_ranks`), each of
which joins a gloo process group on the CPU through
`parallel.mesh.initialize_multi_host` (a free localhost port, explicit size
and rank), loads `inputs` (a `torch.save` file), calls
`function(mesh, inputs)` and `torch.save`s what it returns. The workers
share a deadline, so a hung collective fails its test instead of the suite;
on the deadline or a failure all workers are stopped. Returns the workers'
results in rank order.

The worker functions of the tests are below: they import only the port.
"""

from __future__ import annotations

import importlib
import os
import sys
from pathlib import Path

import torch

from yolopoint_tpu_torch.parallel.launch import free_port, run_ranks  # noqa: F401 (tests use it)

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 300  # seconds a worker may take, start-up included


def run_workers(n: int, target: str, inputs: dict, tmp: Path,
                timeout: float = WORKER_TIMEOUT) -> list:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    done = run_ranks(n, lambda r, addr: [sys.executable, "-m", "tests.torch_dist", target,
                                         str(r), str(n), addr, str(tmp)],
                     timeout, env=env, cwd=REPO)
    for r, (code, log) in enumerate(done):
        assert code == 0, f"worker {r} of {target} failed ({code}):\n{log[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _main(target: str, rank: int, n: int, addr: str, tmp: str) -> None:
    torch.set_num_threads(1)
    from yolopoint_tpu_torch.parallel.mesh import initialize_multi_host, shutdown

    mesh = initialize_multi_host(addr, n, rank, device="cpu")
    try:
        module, fn = target.split(":")
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        out = getattr(importlib.import_module(module), fn)(mesh, inputs)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        shutdown()


# ---------------------------------------------------------------- worker functions

def _model(inputs: dict):
    from yolopoint_tpu_torch.models import build_model

    model = build_model(inputs.get("family", "YOLOPoint"), inputs.get("version", "n"),
                        nc=inputs.get("nc", 80), device="cpu")
    model.load_state_dict(inputs["state_dict"])
    return model


def _state_snapshot(model, state) -> dict:
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "ema": {n: t.clone() for n, t in (state.ema_params or {}).items()},
            "mu": [m.clone() for m in state.optimizer.mu],
            "acc": [a.clone() for a in state.optimizer.acc]}


def dp_step_worker(mesh, inputs: dict) -> dict:
    """The port's DP train step on this rank's rows of each global batch,
    with this rank's draws (`inputs["draws"][step][rank]`). Returns each
    micro-step's scalars and state."""
    from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
    from yolopoint_tpu_torch.parallel.mesh import shard_batch
    from yolopoint_tpu_torch.training import state as tstate
    from yolopoint_tpu_torch.training import step as tstep

    model = _model(inputs)
    opt = tstate.make_optimizer(model, **inputs["opt"])
    state = tstate.create_train_state(model, opt, ema=True)
    hw, nc = inputs["hw"], inputs["nc"]
    fn = tstep.make_train_step(model, inputs["aug"],
                               tstep.rescale_yolo_gains(ObjectLossConfig(**inputs["obj"]), nc, hw),
                               tstep.LossWeights(**inputs["weights"]), nc,
                               accum=inputs["opt"]["accumulate_steps"], mesh=mesh)
    out = {"aux": [], "states": [_state_snapshot(model, state)]}
    for batch, draws in zip(inputs["batches"], inputs["draws"]):
        local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
        aux = fn(state, local, draws[mesh.rank])
        out["aux"].append({k: float(v) for k, v in aux.items()})
        out["states"].append(_state_snapshot(model, state))
        out.setdefault("steps", []).append(state.step)
    return out


def pipeline_worker(mesh, inputs: dict) -> dict:
    """`InferencePipeline.sharded()` on the global batch."""
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline

    pipe = InferencePipeline(_model(inputs), inputs["config"], device="cpu")
    return {k: v.clone() for k, v in pipe.sharded(mesh)(inputs["images"]).items()}


def spatial_worker(mesh, inputs: dict) -> dict:
    """`spatial_sharded_forward` on the layout `inputs["data"]` x spatial:
    this rank's shard of the outputs and the gathered ones."""
    from yolopoint_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_mesh,
        shard_images,
        spatial_sharded_forward,
    )

    sp = make_spatial_mesh(mesh, data=inputs.get("data", 1))
    images = torch.from_numpy(inputs["images"])
    local = spatial_sharded_forward(_model(inputs), sp)(shard_images(images, sp))
    return {"local": local, "full": gather_spatial(local, sp)}


def collectives_worker(mesh, inputs: dict) -> dict:
    """The mesh's collectives and batch helpers on this rank."""
    import numpy as np

    from yolopoint_tpu_torch.parallel import mesh as pm

    r = mesh.rank
    ts = [torch.full((2, 3), float(r + 1)), torch.arange(4, dtype=torch.float32) * (r + 1),
          torch.tensor([r + 1], dtype=torch.float64)]
    pm.all_reduce_mean(ts, mesh)
    b = [torch.full((3,), float(r))]
    pm.broadcast_tensors(b, mesh)
    batch = {"x": np.arange(8 * 2).reshape(8, 2), "names": [f"n{i}" for i in range(8)]}
    stacked = np.arange(3 * 8).reshape(3, 8)
    return {"mean": ts, "broadcast": b[0], "slice": pm.process_local_batch_slice(8),
            "world": (pm.world_size(), pm.rank()), "shard": pm.shard_batch(batch, mesh),
            "shard_stacked": pm.shard_batch(stacked, mesh, leading_stack=True),
            "gathered": pm.all_gather_rows(torch.tensor([[r, r]], dtype=torch.bool), mesh)}


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
