"""Descriptor sampling at keypoints.

Counterpart of `sample_descriptors` in `yolopoint_tpu/ops/sampling.py` and
of its TPU fast path `sample_descriptors_pallas`: both become K3
(`cuda_gather`), exact in f32 on every device. `sample_descriptors(desc,
points, cell_size=8)` takes the `(B, Hc, Wc, D)` coarse map and `(B, N, 2)`
full-resolution `(x, y)` points and returns `(B, N, D)` unit descriptors.
"""

from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda as sample_descriptors

__all__ = ["sample_descriptors"]
