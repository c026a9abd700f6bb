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

The kernel works on 32x32 output tiles and samples each tile from its exact
source window in shared memory, or from global memory where the window
does not fit the budget (`TILE`, `WINDOW_BYTES`: copies of the constants of
`csrc/warp.cu`). It adds one per tile of the second kind to a counter on
the device (`global_tile_count`); `tile_windows` and `window_bytes`
compute each tile's window as the kernel does, so a run can say which
branch its tiles take.

Gradient: as in the JAX package (`_warp_mxu_bwd`), the backward is the
plain version's autograd; warps act on batch inputs in training, never on
the gradient path.
"""

from __future__ import annotations

import math

import torch

from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.geometry import _source_pixels, grid_axes, warp_image_plain

MAX_C = 4
MODES = ("bilinear", "nearest")
TILE = 32               # output tile edge of `csrc/warp.cu` (kTile)
WINDOW_BYTES = 24 * 1024  # its shared-memory window budget (kWindowBytes)
_VMEM_BUDGET = 10_000_000  # the TPU kernel's budget, kept for the gate
_global_tiles: dict[int, torch.Tensor] = {}  # device index -> the kernel's counter


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


def tile_grid(H: int, W: int) -> tuple[int, int]:
    """`(tiles_x, tiles_y)`: the kernel's grid over one image; the tiles at
    the right and bottom edges are cut to the frame."""
    return -(-W // TILE), -(-H // TILE)


def tile_windows(hom: torch.Tensor, shape, mode: str = "bilinear"):
    """`(xmin, xmax, ymin, ymax)`, each `(B, tiles_y, tiles_x)` f32: the
    source window of each output tile as the kernel reduces it, the
    bounding box of the tile's in-frame taps (bilinear `floor` and
    `floor + 1`, nearest `floor(s + 0.5)`, from the plain version's source
    coordinates); `xmax < xmin` where no tap lies in the frame."""
    B, H, W, C = shape
    sx, sy = _source_pixels(hom, H, W, B)
    if mode == "nearest":
        x0, y0 = torch.floor(sx + 0.5), torch.floor(sy + 0.5)
        x1, y1 = x0, y0
    else:
        x0, y0 = torch.floor(sx), torch.floor(sy)
        x1, y1 = x0 + 1, y0 + 1
    xi0, xi1 = (x0 >= 0) & (x0 <= W - 1), (x1 >= 0) & (x1 <= W - 1)  # False for NaN
    yi0, yi1 = (y0 >= 0) & (y0 <= H - 1), (y1 >= 0) & (y1 <= H - 1)
    hit = (xi0 | xi1) & (yi0 | yi1)
    tx, ty = tile_grid(H, W)

    def reduce(v, fill, fn):
        v = torch.nn.functional.pad(torch.where(hit, v, fill),
                                    (0, tx * TILE - W, 0, ty * TILE - H), value=fill)
        return fn(fn(v.reshape(B, ty, TILE, tx, TILE), 4).values, 2).values

    return (reduce(torch.where(xi0, x0, x1), math.inf, torch.min),
            reduce(torch.where(xi1, x1, x0), -math.inf, torch.max),
            reduce(torch.where(yi0, y0, y1), math.inf, torch.min),
            reduce(torch.where(yi1, y1, y0), -math.inf, torch.max))


def window_bytes(hom: torch.Tensor, shape, mode: str = "bilinear") -> torch.Tensor:
    """`(B, tiles_y, tiles_x)` int64 shared-memory bytes of each tile's
    window (`tile_windows`) as the kernel copies it: rows of float columns
    `[xmin * C, (xmax + 1) * C)`, widened to 16-byte chunks where the row
    pitch `W * C` is a multiple of 4 (and the tensors 16-byte aligned, as
    fresh allocations are); 0 where no tap lies in the frame. A tile whose
    bytes exceed `WINDOW_BYTES` samples from global memory."""
    B, H, W, C = shape
    xmin, xmax, ymin, ymax = tile_windows(hom, shape, mode)
    empty = xmax < xmin
    c0, c1 = torch.where(empty, 0, xmin) * C, torch.where(empty, 0, xmax + 1) * C
    if (W * C) % 4 == 0:
        c0, c1 = torch.floor(c0 / 4) * 4, torch.ceil(c1 / 4) * 4
    rows = torch.where(empty, 0, ymax - ymin + 1)
    return ((c1 - c0) * rows * 4).to(torch.int64)


def _device_index(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def global_tile_count(device) -> int:
    """The tiles that sampled from global memory on CUDA `device` so far,
    over every launch (reads the device counter, so it synchronizes)."""
    counter = _global_tiles.get(_device_index(device))
    return 0 if counter is None else int(counter.item())


def _counter_ptr(device: torch.device) -> int:
    """The device's counter of global-branch tiles, made at its first launch;
    0 (no counting) for a first launch inside CUDA graph capture, where an
    allocation would belong to the graph's pool and its zeroing would not
    run."""
    index = _device_index(device)
    if index not in _global_tiles:
        if torch.cuda.is_current_stream_capturing():
            return 0
        _global_tiles[index] = torch.zeros(1, dtype=torch.int32, device=device)
    return _global_tiles[index].data_ptr()


def _launch(img: torch.Tensor, hom: torch.Tensor, mode: str) -> torch.Tensor:
    B, H, W, C = img.shape
    ys, xs = grid_axes(H, W, img.device)
    out = torch.empty_like(img)
    code = _build.library().yp_warp_image(
        img.data_ptr(), hom.data_ptr(), xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
        B, H, W, C, int(mode == "nearest"), _counter_ptr(img.device),
        _build.stream_ptr(img),
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
