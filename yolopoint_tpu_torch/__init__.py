"""PyTorch/CUDA port of `yolopoint_tpu`: the YOLOPoint serving path,
training and validation, the HPatches evaluation and pseudo-label export on
an NVIDIA Hopper GPU.

Plain tensor code is PyTorch; the Pallas kernels of those paths (keypoint
NMS, box NMS, descriptor sampling; the homography warp that stands for both
Pallas warps) are CUDA C++ kernels under `ops/csrc/`, built with nvcc into
one shared library at first use and loaded with ctypes (`ops/_build.py`). The JAX package stays the reference;
nothing here imports it or JAX.

Entry points run on the GPU unless the caller passes `device="cpu"`; every
kernel wrapper takes its plain PyTorch version only for a CPU tensor.
"""

from yolopoint_tpu_torch.utils.device import resolve_device, set_determinism

__all__ = ["resolve_device", "set_determinism"]
