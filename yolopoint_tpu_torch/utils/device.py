"""Device resolution and numeric settings for the port.

The JAX package picks its backend implicitly; here every entry point takes
an explicit `device=` that defaults to the GPU, and a missing GPU raises
rather than silently running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a `torch.device`, defaulting to `"cuda"`.

    Raises if a CUDA device is asked for (explicitly or by default) and none
    is available: the port runs on the CPU only when the caller says so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def set_determinism() -> None:
    """Run float32 matmuls and cuDNN convolutions in full f32.

    PyTorch's defaults differ between the two (cuDNN convolutions run in
    TF32, matmuls in full f32); comparisons with a reference need both in
    full f32, so both flags are set explicitly.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
