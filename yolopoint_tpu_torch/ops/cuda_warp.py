"""K4 + K5: the homography image warp (CUDA kernel `csrc/warp.cu`).

One kernel stands for both Pallas warps of `yolopoint_tpu/ops/pallas_warp.py`:
`_kernel` (K5, whole image resident, for shapes where `warp_fits_pallas`
holds, e.g. the descriptor loss's (B, 80, 80, 1) cell mask) and `_wkernel`
(K4, windowed, e.g. the (B, 640, 640, 3) augmentation warps). It computes
the exact f32 `_warp_image_xla` of `yolopoint_tpu/ops/geometry.py`, whose
port is `warp_image_plain` in `ops/geometry.py`: the plain version, the CPU
path and the kernel's reference on the card.

Each launch counts under `"K5"` where this module's copy of the TPU gate
`warp_fits_pallas` holds for the shape and under `"K4"` otherwise, so a run
shows which Pallas kernel each call replaced.

Gradient: as in the JAX package (`_warp_mxu_bwd`), the backward is the
plain version's autograd; warps act on batch inputs in training, never on
the gradient path.
"""

from __future__ import annotations

import torch

from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.geometry import grid_axes, warp_image_plain

MAX_C = 4
MODES = ("bilinear", "nearest")
_VMEM_BUDGET = 10_000_000  # the TPU kernel's budget, kept for the gate


def _pick_bh(H: int, W: int, C: int) -> int:
    """The TPU kernel's row block (`pallas_warp._pick_bh`); 0 = no fit."""
    img_bytes = C * H * W * 2 * 2
    for bh in (32, 16, 8):
        if H % bh:
            continue
        M = bh * W
        work = M * H * 2 + M * W * (2 + 2 + 4) + M * C * 4
        if img_bytes + work <= _VMEM_BUDGET:
            return bh
    return 0


def warp_fits_pallas(shape, mode: str = "bilinear") -> bool:
    """Copy of the TPU gate `pallas_warp.warp_fits_pallas`: True where the
    JAX package would run the resident kernel K5 (else the windowed K4)."""
    B, H, W, C = shape
    return C <= 4 and _pick_bh(H, W, C) > 0


def _launch(img: torch.Tensor, hom: torch.Tensor, mode: str) -> torch.Tensor:
    B, H, W, C = img.shape
    ys, xs = grid_axes(H, W, img.device)
    out = torch.empty_like(img)
    code = _build.library().yp_warp_image(
        img.data_ptr(), hom.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
        B, H, W, C, int(mode == "nearest"), _build.stream_ptr(img),
    )
    _build.check(code, "warp_image")
    _build.launch_counts["K5" if warp_fits_pallas(img.shape, mode) else "K4"] += 1
    return out


class _WarpImage(torch.autograd.Function):
    """The kernel forward; the plain version's autograd backward."""

    @staticmethod
    def forward(ctx, img, hom, mode):
        ctx.mode = mode
        ctx.save_for_backward(img, hom)
        return _launch(img, hom, mode)

    @staticmethod
    def backward(ctx, grad_out):
        img, hom = ctx.saved_tensors
        with torch.enable_grad():
            img_ = img.detach().requires_grad_(ctx.needs_input_grad[0])
            hom_ = hom.detach().requires_grad_(ctx.needs_input_grad[1])
            out = warp_image_plain(img_, hom_, ctx.mode)
            wrt = [t for t in (img_, hom_) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True,
                                             materialize_grads=True))
        return (next(grads) if ctx.needs_input_grad[0] else None,
                next(grads) if ctx.needs_input_grad[1] else None, None)


def warp_image_cuda(img: torch.Tensor, homography_inv: torch.Tensor,
                    mode: str = "bilinear") -> torch.Tensor:
    """K4/K5: `(B, H, W, C<=4)` f32 images, `(B, 3, 3)` or `(3, 3)` f32
    output -> source homographies (normalized coords) -> `(B, H, W, C)` f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if img.device.type == "cpu":
        return warp_image_plain(img, homography_inv, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode}")
    _build.require_cuda(img, "img", (torch.float32,), 4)
    B, H, W, C = img.shape
    if C > MAX_C:
        raise ValueError(f"the warp kernel takes at most {MAX_C} channels, got {C}")
    hom = homography_inv.reshape(-1, 3, 3)
    if hom.shape[0] not in (1, B):
        raise ValueError(f"homographies {tuple(homography_inv.shape)} do not match batch {B}")
    hom = hom.expand(B, 3, 3).contiguous()
    _build.require_cuda(hom, "homography_inv", (torch.float32,), 3)
    return _WarpImage.apply(img, hom, mode)
