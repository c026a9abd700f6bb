"""Data parallelism and spatial sharding over `torch.distributed`.

Counterpart of `yolopoint_tpu/parallel/`: the process group and the rank's
rows (`mesh`), and the forward with the image rows split over ranks, the
halo rows exchanged by hand (`spatial`). `python -m
yolopoint_tpu_torch.parallel.dryrun --nproc N` is the port's twin of the JAX
package's multi-device dry run.
"""

from yolopoint_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_mean,
    broadcast_tensors,
    initialize_multi_host,
    make_mesh,
    process_local_batch_slice,
    shard_batch,
)
from yolopoint_tpu_torch.parallel.spatial import (
    SpatialMesh,
    gather_spatial,
    make_spatial_mesh,
    shard_images,
    spatial_sharded_forward,
)

__all__ = [
    "Mesh", "SpatialMesh", "all_gather_rows", "all_reduce_mean", "broadcast_tensors",
    "gather_spatial", "initialize_multi_host", "make_mesh", "make_spatial_mesh",
    "process_local_batch_slice", "shard_batch", "shard_images", "spatial_sharded_forward",
]
