"""K1 and K6: fused keypoint NMS (CUDA kernels in `csrc/nms_keys.cu`).

Counterparts of `nms_tile_keys` (the Pallas kernel `_kernel_keys`, K1) and
`nms_tile_reduce` (the Pallas kernel `_kernel`, K6) in
`yolopoint_tpu/ops/pallas_nms.py`. Both compute, for a `(B, H, W)`
heatmap, threshold -> iterative `simple_nms` (edges read as -inf) ->
border zeroing, in f32:
  K1 then packs each survivor into an order-preserving int32 key
     `(f32 bits & ~pos_mask) | (dy*t + dx)` and keeps the max key of each
     t x t tile, returning `(B, H/t * W/t)` int32 keys (0 marks an empty
     tile). Top-k over the keys yields scores and positions at once.
  K6 writes the full `(B, H, W)` f32 suppressed map, for any H and W;
     `nms_tile_reduce` reduces it per tile to the exact f32 max and the
     position of the max key (the last survivor of a tied plateau).

`nms_tile_keys_torch` and `nms_suppressed_map_torch` are the plain PyTorch
versions: the CPU path and the kernels' references on the card.

`tile_config` mirrors the kernel's choice of block interior and its shared
memory (`configure` in `csrc/nms_keys.cu`), and the tests emulate the tiling
from it. Where no interior fits (large radii), the kernel takes its
global-memory branch, in a scratch the wrapper allocates, and the wrapper
counts the launch under its own key (`_plan`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops import _build


# The launch configuration of `csrc/nms_keys.cu` (the tests check each
# against the source's `constexpr` of the same role).
THREADS = 256
BLOCKS_PER_SM = 3            # blocks of the large interior on one SM
SMS = 132                    # SMs of the H100 SXM
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024         # per block, taken by the runtime
SMEM_LIMIT = 227 * 1024      # a block's dynamic shared memory at most
WORD = 32                    # staged pixels per mask word
CHUNK = 8                    # pixels per staged chunk (16 bytes of bf16)
LARGE_INTERIOR = (64, 128)   # rows x columns of a block's interior
SMALL_INTERIOR = (32, 64)
MAX_STAGED_RATIO = 16        # staged pixels of a block per interior pixel, at most
GLOBAL_SCRATCH_BYTES = 15    # a pixel's scratch in the global branch


@dataclass(frozen=True)
class TileConfig:
    """A block's interior (TH x TW), halo, staged rows SH, staged row pitch
    SP (pixels, from a first column rounded down to a multiple of CHUNK),
    mask words NW per staged row, and its shared memory in bytes."""

    TH: int
    TW: int
    halo: int
    SH: int
    SP: int
    NW: int
    smem: int


def staged_shape(TH: int, TW: int, halo: int, elem: int) -> TileConfig:
    """The staged tile of a TH x TW interior: two planes of scores at the
    input's width and one plane of mask words."""
    SH = TH + 2 * halo
    SP = (TW + 2 * halo + 2 * CHUNK - 2) // CHUNK * CHUNK
    NW = -(-SP // WORD)
    return TileConfig(TH, TW, halo, SH, SP, NW, SH * SP * 2 * elem + SH * NW * 4)


def tile_config(B: int, H: int, W: int, elem: int, radius: int, iterations: int,
                tile: int = 1) -> TileConfig | None:
    """The kernel's interior for a launch: LARGE_INTERIOR where BLOCKS_PER_SM
    of its blocks fit on an SM and its grid fills every SM with them, else
    SMALL_INTERIOR; rounded up to the tile, then shrunk by whole tiles
    (rows first) until it fits SMEM_LIMIT. None (the global branch) where
    nothing fits, or where what fits stages more than MAX_STAGED_RATIO times
    its interior's pixels."""
    t, halo = tile, (2 * iterations - 1) * radius

    def up(v):
        return -(-v // t) * t

    TH, TW = map(up, LARGE_INTERIOR)
    fits = (staged_shape(TH, TW, halo, elem).smem + SMEM_RESERVED) * BLOCKS_PER_SM <= SMEM_PER_SM
    if not fits or B * -(-H // TH) * -(-W // TW) < SMS * BLOCKS_PER_SM:
        TH, TW = map(up, SMALL_INTERIOR)
    while staged_shape(TH, TW, halo, elem).smem > SMEM_LIMIT and TH > t:
        TH -= t
    while staged_shape(TH, TW, halo, elem).smem > SMEM_LIMIT and TW > t:
        TW -= t
    cfg = staged_shape(TH, TW, halo, elem)
    if cfg.smem > SMEM_LIMIT or cfg.SH * cfg.SP > MAX_STAGED_RATIO * TH * TW:
        return None
    return cfg


def _plan(heatmap: torch.Tensor, radius: int, iterations: int, tile: int,
          key: str) -> tuple[str, int]:
    """The launch-count key and the global scratch in bytes of a launch: the
    shared-memory kernel (`key`, no scratch) where `tile_config` finds an
    interior, else the global branch (`key + "_global"`, GLOBAL_SCRATCH_BYTES
    a pixel)."""
    B, H, W = heatmap.shape
    if tile_config(B, H, W, heatmap.element_size(), radius, iterations, tile) is not None:
        return key, 0
    return key + "_global", B * H * W * GLOBAL_SCRATCH_BYTES


def _scratch(heatmap: torch.Tensor, nbytes: int) -> torch.Tensor | None:
    return torch.empty(nbytes, dtype=torch.uint8, device=heatmap.device) if nbytes else None


def pos_bits_for(t: int) -> int:
    """Low mantissa bits that carry the in-tile position dy*t + dx."""
    return max((t * t - 1).bit_length(), 1)


def _maxpool2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 window max with -inf padding (`max_pool2d` pads with -inf)."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, radius: int, iterations: int = 3) -> torch.Tensor:
    """Iterative non-maximum suppression of a `(B, H, W)` score map.

    Round 1 keeps strict window maxima; each later round re-admits maxima of
    the map with every kept point's window zeroed. Counterpart of
    `yolopoint_tpu/ops/keypoints.py:simple_nms`.
    """
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool2d(scores, radius)
    for _ in range(iterations - 1):
        supp_mask = _maxpool2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool2d(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _check_shape(heatmap: torch.Tensor, t: int) -> None:
    if heatmap.dim() != 3:
        raise ValueError(f"heatmap must be (B, H, W), got {tuple(heatmap.shape)}")
    _, H, W = heatmap.shape
    if H % t or W % t:
        raise ValueError(f"H and W must be multiples of the tile {t}, got {H}x{W}")


def _check_nms_args(radius: int, iterations: int) -> None:
    if iterations < 1 or radius < 0:
        raise ValueError(f"need iterations >= 1 and radius >= 0, got {iterations}, {radius}")


def nms_suppressed_map_torch(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
) -> torch.Tensor:
    """Plain PyTorch version of K6 (any device): the f32 `(B, H, W)` map of
    thresholded scores kept by `simple_nms` inside the border, 0 elsewhere."""
    if heatmap.dim() != 3:
        raise ValueError(f"heatmap must be (B, H, W), got {tuple(heatmap.shape)}")
    _, H, W = heatmap.shape
    s = heatmap.float()
    s = torch.where(s >= conf_thresh, s, torch.zeros_like(s))
    s = simple_nms(s, radius, iterations)
    ys = torch.arange(H, device=s.device)[:, None]
    xs = torch.arange(W, device=s.device)[None, :]
    ok = (xs >= border) & (xs < W - border) & (ys >= border) & (ys < H - border)
    return torch.where(ok, s, torch.zeros_like(s))


def nms_suppressed_map(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
) -> torch.Tensor:
    """K6: `(B, H, W)` f32/bf16 heatmap, any H and W -> the f32 suppressed map.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if heatmap.device.type == "cpu":
        return nms_suppressed_map_torch(heatmap, conf_thresh, radius, iterations, border)
    _build.require_cuda(heatmap, "heatmap", (torch.float32, torch.bfloat16), 3)
    _check_nms_args(radius, iterations)
    key, nbytes = _plan(heatmap, radius, iterations, 1, "K6")
    scratch = _scratch(heatmap, nbytes)
    B, H, W = heatmap.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=heatmap.device)
    code = _build.library().yp_nms_suppressed_map(
        heatmap.data_ptr(), int(heatmap.dtype == torch.bfloat16), out.data_ptr(),
        scratch.data_ptr() if nbytes else None, B, H, W, float(conf_thresh), int(radius),
        int(iterations), int(border), _build.stream_ptr(heatmap),
    )
    _build.check(code, "nms_suppressed_map")
    _build.launch_counts[key] += 1
    return out


def _pixel_keys(nmsed: torch.Tensor, t: int) -> torch.Tensor:
    """Per pixel of a suppressed map, the int32 key of K1's packing (0 where
    nothing survived)."""
    _, H, W = nmsed.shape
    pos_mask = (1 << pos_bits_for(t)) - 1
    ys = torch.arange(H, dtype=torch.int32, device=nmsed.device)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=nmsed.device)[None, :]
    pos = (ys % t) * t + xs % t
    return torch.where(nmsed > 0.0, (nmsed.view(torch.int32) & ~pos_mask) | pos, 0)


def _tile_max(x: torch.Tensor, t: int) -> torch.Tensor:
    """`(B, H, W)` -> `(B, H/t * W/t)` max of each t x t tile, row-major tiles."""
    B, H, W = x.shape
    return x.reshape(B, H // t, t, W // t, t).amax(dim=(2, 4)).reshape(B, -1)


def nms_tile_keys_torch(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
    tile: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device). Math in f32."""
    t = tile or max(int(radius), 1)
    _check_shape(heatmap, t)
    s = nms_suppressed_map_torch(heatmap, conf_thresh, radius, iterations, border)
    return _tile_max(_pixel_keys(s, t), t)


def nms_tile_keys(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
    tile: int | None = None,
) -> torch.Tensor:
    """K1: `(B, H, W)` f32/bf16 heatmap -> `(B, H/t * W/t)` int32 tile keys.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    t = tile or max(int(radius), 1)
    if heatmap.device.type == "cpu":
        return nms_tile_keys_torch(heatmap, conf_thresh, radius, iterations, border, t)
    _build.require_cuda(heatmap, "heatmap", (torch.float32, torch.bfloat16), 3)
    _check_shape(heatmap, t)
    _check_nms_args(radius, iterations)
    key, nbytes = _plan(heatmap, radius, iterations, t, "nms_tile_keys")
    scratch = _scratch(heatmap, nbytes)
    B, H, W = heatmap.shape
    keys = torch.empty((B, (H // t) * (W // t)), dtype=torch.int32, device=heatmap.device)
    code = _build.library().yp_nms_tile_keys(
        heatmap.data_ptr(), int(heatmap.dtype == torch.bfloat16), keys.data_ptr(),
        scratch.data_ptr() if nbytes else None, B, H, W, float(conf_thresh), int(radius),
        int(iterations), int(border), t, _build.stream_ptr(heatmap),
    )
    _build.check(code, "nms_tile_keys")
    _build.launch_counts[key] += 1
    return keys


def nms_tile_reduce(
    heatmap: torch.Tensor,
    conf_thresh: float,
    radius: int,
    iterations: int = 3,
    border: int = 4,
    tile: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threshold + NMS + border (K6), then per t x t tile the exact f32 max
    and the in-tile position `dy*t + dx` of the max key (the last survivor
    of a tied plateau; 0 for an empty tile), as the JAX package's
    `_tile_reduce_window` takes them. H and W must be tile multiples.

    Returns `(tile_max (B, H/t * W/t) f32, tile_arg (B, H/t * W/t) int32)`.
    """
    t = tile or max(int(radius), 1)
    _check_shape(heatmap, t)
    nmsed = nms_suppressed_map(heatmap, conf_thresh, radius, iterations, border)
    key = _tile_max(_pixel_keys(nmsed, t), t)
    pos_mask = (1 << pos_bits_for(t)) - 1
    return _tile_max(nmsed, t), torch.where(key > 0, key & pos_mask, 0)
