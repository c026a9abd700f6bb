"""The process group, the rank's rows and the all-reduce of data parallelism.

Counterpart of `yolopoint_tpu/parallel/mesh.py`, over `torch.distributed`.
The JAX package runs one controller over a device mesh, shards the batch on
its `data` axis and reduces with `pmean` inside a `shard_map`-ped step. Here
each rank is a process with one device (`torchrun`, or workers started by
the caller): it loads its own rows of the global batch, runs the step on
them, and averages the gradients, the BatchNorm statistics and the scalars
with the other ranks in one coalesced all-reduce.

`Mesh` stands for the JAX `make_mesh` / `data_sharding` pair: the world
size, this process's rank and its device. It has no sharding semantics of
its own.

Backends: NCCL for CUDA ranks, gloo for CPU ones. NCCL refuses a
communicator in which two ranks share a GPU, so a rank without a GPU of its
own (more local ranks than devices) raises, unless the caller asks for gloo
by name: gloo's collectives take CUDA tensors but stage them through the
host, so sharing a card is a test setup that is only ever chosen, never
fallen into.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)
# the environment `torchrun` gives every rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel world as this process sees it."""

    size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None  # None: one process, no group

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def default_backend(device_type: str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ones."""
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank_device(device_type: str, backend: Optional[str], local: int) -> torch.device:
    """The device of local rank `local`: `cuda:<local>`, or the CPU. Local
    ranks past the device count share the cards round-robin only where
    `backend` is gloo, asked for by name; otherwise that raises."""
    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU run")
    n = torch.cuda.device_count()
    if local >= n and backend != "gloo":
        raise RuntimeError(
            f"local rank {local} has no GPU of its own ({n} visible): NCCL cannot put two "
            "ranks on one GPU; ask for the gloo backend by name to share a card (its "
            "collectives stage the card's tensors through the host)")
    return torch.device("cuda", local % n)


def initialize_multi_host(coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          device: str | torch.device = "cuda",
                          backend: Optional[str] = None) -> Mesh:
    """Join the data-parallel process group and return the `Mesh`.

    The group's address, size and rank come from the arguments
    (`coordinator_address` as `host:port`), else from `torchrun`'s
    environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`). With
    neither, the world is this one process (size 1, no group), as the JAX
    single-host case. A group that was asked for and cannot be joined
    raises. `device` is the device type ("cuda" or "cpu"); the rank's device
    is `cuda:<LOCAL_RANK>` (`rank_device`), made current. `backend` defaults
    to `default_backend` (NCCL on CUDA, where a rank sharing a GPU raises);
    gloo on CUDA is taken only when asked for here.
    """
    dev_type = torch.device(device).type
    if dist.is_initialized():
        backend = dist.get_backend()
        dev = rank_device(dev_type, backend, local_rank())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return Mesh(dist.get_world_size(), dist.get_rank(), dev, backend)
    explicit = coordinator_address is not None or num_processes is not None
    from_env = all(k in os.environ for k in TORCHRUN_ENV)
    if not explicit and not from_env:
        dev = rank_device(dev_type, None, 0)
        return Mesh(1, 0, dev, None)
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id go together")
        size, rank = int(num_processes), int(process_id)
        init = f"tcp://{coordinator_address}"
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        init = "env://"
        local = local_rank()
    backend = backend or default_backend(dev_type)
    dev = rank_device(dev_type, backend, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank,
                            timeout=TIMEOUT, **kwargs)
    return Mesh(size, rank, dev, backend)


def make_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The current world: the process group's where one is joined, else
    this one process on `device`."""
    dev = torch.device(device)
    if not dist.is_initialized():
        return Mesh(1, 0, dev, None)
    return initialize_multi_host(device=dev.type)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (nothing at world size 1)."""
    if mesh.size > 1:
        dist.barrier(device_ids=[mesh.device.index] if mesh.backend == "nccl" else None)


def foreign_card_bytes(mesh: Mesh) -> dict:
    """The peak bytes this process's allocator took on each visible card
    other than the rank's own: 0 where every tensor of the rank, its threads'
    included, stayed on its card (a thread that never set its device works on
    card 0). Empty for a CPU rank."""
    if mesh.device.type != "cuda":
        return {}
    return {d: torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())
            if d != mesh.device.index}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_rows(global_batch: int, size: int, rank_: int) -> slice:
    """Rank `rank_`'s rows of a global batch split over `size` ranks."""
    if global_batch % size:
        raise ValueError(f"the global batch {global_batch} does not split over {size} ranks")
    per = global_batch // size
    return slice(per * rank_, per * (rank_ + 1))


def process_local_batch_slice(global_batch: int) -> slice:
    """Which rows of the global batch this process feeds: the ranks take
    disjoint, covering, equal shares in rank order."""
    return rank_rows(global_batch, world_size(), rank())


def shard_batch(batch: Any, mesh: Mesh, leading_stack: bool = False) -> Any:
    """This rank's rows of a host or device batch: a dict, list or tuple of
    arrays, tensors or lists (a batch's `names`), cut on the first dim, or
    on the second with `leading_stack` (a stacked batch whose first dim is
    the micro-step, `training.step.make_multi_step`)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, leading_stack) for k, v in batch.items()}
    if mesh.size == 1:
        return batch
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        axis = 1 if leading_stack else 0
        sl = rank_rows(batch.shape[axis], mesh.size, mesh.rank)
        return batch[:, sl] if leading_stack else batch[sl]
    if isinstance(batch, (list, tuple)) and not leading_stack:
        return batch[rank_rows(len(batch), mesh.size, mesh.rank)]
    raise TypeError(f"cannot shard a {type(batch).__name__}")


def _buckets(tensors: Sequence[torch.Tensor]):
    """`(group, flat bucket)` a dtype: the tensors of that dtype flattened
    into one tensor."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return [(group, torch.cat([t.reshape(-1) for t in group])) for group in by_dtype.values()]


def _unflatten(group: Sequence[torch.Tensor], bucket: torch.Tensor) -> None:
    for t, flat in zip(group, torch.split(bucket, [t.numel() for t in group])):
        t.copy_(flat.view_as(t))


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average `tensors` over the ranks, in place, in one all-reduce a dtype
    (the tensors flattened into one bucket). At world size 1 nothing is
    called. Every rank gets the same bytes: the sum is reduced once and
    shared, then divided by the world size on each rank alike."""
    if mesh.size == 1 or not tensors:
        return
    for group, bucket in _buckets(tensors):
        dist.all_reduce(bucket)
        bucket /= mesh.size
        _unflatten(group, bucket)


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Copy rank `src`'s values of `tensors` to every rank, in place, one
    broadcast a dtype."""
    if mesh.size == 1 or not tensors:
        return
    for group, bucket in _buckets(tensors):
        dist.broadcast(bucket, src)
        _unflatten(group, bucket)


# gloo reduces and gathers no bool or bfloat16: such tensors cross as these
_WIRE = {torch.bool: torch.uint8, torch.bfloat16: torch.float32}


def all_gather(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's `t` (the same shape on all), in rank order."""
    wire = t.to(_WIRE.get(t.dtype, t.dtype)).contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire)
    return [p.to(t.dtype) for p in parts]


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `t` concatenated on the first dim in rank order."""
    return t if mesh.size == 1 else torch.cat(all_gather(t, mesh))
