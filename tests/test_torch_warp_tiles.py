"""The warp kernel's tiling (`ops/csrc/warp.cu`, wrapper `ops/cuda_warp.py`),
without JAX, so that the `gpu`-marked test here also runs on a machine
with a card and no JAX (`--noconftest`: `tests/conftest.py` imports JAX).

On the CPU: the tile grid covers the frame; the constants the wrapper
mirrors match `csrc/warp.cu` and fit the card's shared memory; the
kernel's shared-memory branch emulated in torch (each tile's window cut as
the kernel copies it, each tap read at the kernel's index) equals the plain
version bit for bit, which holds only if every in-frame tap lies in its
tile's window; the window sizes send the s640 augmentation's tiles to
shared memory and zoom-out and w2 sign-change tiles to global memory.

On the card (`gpu`): the kernel against its plain version at the K4 and
K5 shapes, ragged tiles, W * C odd, one (3, 3) homography, a zoom-out and
a w2 sign change, with the global-branch tiles it counts.
"""

import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolopoint_tpu_torch.ops import cuda_warp
from yolopoint_tpu_torch.ops import geometry as tgeo
from yolopoint_tpu_torch.ops.homography import sample_homography_batch

torch.set_num_threads(1)

PARAMS = dict(patch_ratio=0.85, perspective=True, scaling=True, rotation=True, translation=True)


def image(shape, seed=3):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def zoom_out(hom):
    """Output -> source homographies that first scale the output 3x: each
    32-pixel tile reaches ~100 source pixels."""
    return (np.linalg.inv(hom) @ np.diag([3.0, 3.0, 1.0])).astype(np.float32)


def sign_change(hom):
    """w2 = 0.6 x + 0.3 y + 0.2 (then `hom`) changes sign inside the frame."""
    tilt = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.3, 0.2]])
    return (hom @ tilt).astype(np.float32)


def s640_homs(B, seed=0):
    """As the s640 augmentation samples them (`configs/synthetic_s640.yaml`)."""
    gen = torch.Generator().manual_seed(seed)
    return sample_homography_batch(gen, B, **PARAMS, perspective_amplitude_x=0.2,
                                   perspective_amplitude_y=0.2, scaling_amplitude=0.2,
                                   max_angle=1.57).numpy()


def kernel_constants() -> dict:
    """The `constexpr int k... = ...;` lines of `csrc/warp.cu`, in order."""
    src = (Path(tgeo.__file__).parent / "csrc" / "warp.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([\w\s*/+-]+);", src):
        consts[name] = int(eval(expr, {}, dict(consts)))
    return consts


def test_kernel_constants_match_wrapper_and_fit_shared_memory():
    k = kernel_constants()
    assert k["kTile"] == cuda_warp.TILE and k["kWindowBytes"] == cuda_warp.WINDOW_BYTES
    assert k["kThreads"] * k["kPix"] == k["kTile"] ** 2
    for C in range(1, cuda_warp.MAX_C + 1):
        block = k["kTile"] ** 2 * C * 4 + k["kWindowBytes"] + k["kWarps"] * 4 * 4  # + static
        assert block <= 227 * 1024, C  # a block's shared memory on the H100
    # the blocks per SM that the launch bounds ask for fit the SM's 228 KB at C = 3
    per_block = k["kTile"] ** 2 * 3 * 4 + k["kWindowBytes"] + k["kWarps"] * 16 + 1024
    assert k["kBlocksPerSm"] * per_block <= 228 * 1024
    assert 65536 // (k["kBlocksPerSm"] * k["kThreads"]) >= 32  # registers a thread


@pytest.mark.parametrize("H,W", [(640, 640), (80, 80), (101, 94), (37, 53), (1, 1), (33, 31)])
def test_tile_grid_covers_frame(H, W):
    tx, ty = cuda_warp.tile_grid(H, W)
    T = cuda_warp.TILE
    assert (tx - 1) * T < W <= tx * T and (ty - 1) * T < H <= ty * T
    covered = np.zeros((ty * T, tx * T), bool)
    for i, j in itertools.product(range(ty), range(tx)):
        covered[i * T:(i + 1) * T, j * T:(j + 1) * T] = True
    assert covered[:H, :W].all()


def emulate_window_branch(img, hom, mode, vec):
    """The kernel's shared-memory branch in torch: each tile's window cut
    from the image as the kernel copies it (rows of float columns
    [c0, c1), widened to 16-byte chunks when `vec`) into a flat buffer, and
    every tap read from it at the kernel's index
    `(y - ymin) * pitch + x * C - c0 + c`, 0 off the frame. An in-frame tap
    outside its tile's window reads the wrong value or no value at all."""
    B, H, W, C = img.shape
    T = cuda_warp.TILE
    sx, sy = tgeo._source_pixels(hom, H, W, B)
    xmin, xmax, ymin, ymax = cuda_warp.tile_windows(hom, img.shape, mode)
    out = torch.empty_like(img)
    rows = img.reshape(B, H, W * C)
    for b, ty, tx in itertools.product(range(B), *map(range, xmin.shape[1:])):
        x_lo, x_hi, y_lo, y_hi = (int(v) if math.isfinite(v) else 0 for v in (
            float(xmin[b, ty, tx]), float(xmax[b, ty, tx]),
            float(ymin[b, ty, tx]), float(ymax[b, ty, tx])))
        c0, c1 = x_lo * C, (x_hi + 1) * C
        if vec:
            c0, c1 = c0 // 4 * 4, -(-c1 // 4) * 4
        flat = rows[b, y_lo:y_hi + 1, c0:c1].reshape(-1)  # empty for an empty window
        pitch = c1 - c0
        tile = (slice(ty * T, (ty + 1) * T), slice(tx * T, (tx + 1) * T))
        px, py = sx[b][tile], sy[b][tile]

        def read(x, y):
            inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
            idx = torch.where(inside, (y - y_lo) * pitch + x * C - c0, 0.0).long()
            vals = [flat[idx + c] if inside.any() else torch.zeros_like(px) for c in range(C)]
            return torch.where(inside[..., None], torch.stack(vals, -1), 0.0)

        if mode == "nearest":
            out[b][tile] = read(torch.floor(px + 0.5), torch.floor(py + 0.5))
            continue
        x0, y0 = torch.floor(px), torch.floor(py)
        wx, wy = (px - x0)[..., None], (py - y0)[..., None]
        top = read(x0, y0) * (1 - wx) + read(x0 + 1, y0) * wx
        bot = read(x0, y0 + 1) * (1 - wx) + read(x0 + 1, y0 + 1) * wx
        out[b][tile] = top * (1 - wy) + bot * wy
    return out


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind,shape", [
    ("s640", (2, 70, 90, 3)), ("s640", (3, 101, 94, 4)), ("s640", (1, 37, 53, 2)),
    ("zoom_out", (2, 96, 128, 1)), ("sign_change", (2, 64, 96, 3)),
])
def test_window_branch_emulation_matches_plain(kind, shape, mode):
    hom = s640_homs(shape[0], seed=11)
    hom = {"s640": hom, "zoom_out": zoom_out(hom), "sign_change": sign_change(hom)}[kind]
    img = torch.from_numpy(image(shape, seed=4))
    hom = torch.from_numpy(hom)
    ref = tgeo.warp_image_plain(img, hom, mode)
    for vec in {False, (shape[2] * shape[3]) % 4 == 0}:
        got = emulate_window_branch(img, hom, mode, vec)
        assert torch.equal(got.isnan(), ref.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))


def test_window_sizes_pick_the_branch():
    """The s640 augmentation's tiles fit the shared budget at C = 3; a 3x
    zoom-out and a w2 sign change send some tiles to global memory."""
    T, budget = cuda_warp.TILE, cuda_warp.WINDOW_BYTES
    hom = torch.from_numpy(s640_homs(16, seed=5))
    assert int(cuda_warp.window_bytes(hom, (16, 320, 320, 3)).max()) <= budget
    shape = (4, 320, 320, 3)
    zoom = cuda_warp.window_bytes(torch.from_numpy(zoom_out(s640_homs(4))), shape)
    assert (zoom > budget).any() and (zoom == 0).any()  # inner tiles global, outer empty
    tilt = cuda_warp.window_bytes(torch.from_numpy(sign_change(s640_homs(4))), shape)
    assert (tilt > budget).any()
    # a window never exceeds the frame's own rows of 16-byte chunks
    assert int(tilt.max()) <= 320 * (-(-320 * 3 // 4) * 4) * 4 and T == 32


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,mode", [
    ("s640", (4, 640, 640, 3), "bilinear"),
    ("s640", (32, 80, 80, 1), "nearest"),
    ("s640", (3, 101, 94, 4), "bilinear"),
    ("s640", (3, 101, 94, 4), "nearest"),
    ("single", (1, 37, 53, 2), "bilinear"),
    ("single", (1, 37, 53, 2), "nearest"),
    ("zoom_out", (8, 640, 640, 3), "bilinear"),
    ("sign_change", (4, 640, 640, 3), "bilinear"),
    ("sign_change", (4, 640, 640, 3), "nearest"),
])
def test_kernel_matches_plain_on_card(kind, shape, mode):
    """Nearest bit-equal, bilinear within 1e-5 (NaN at the same pixels);
    the tiles that took the global branch are those whose window exceeds
    the budget (`window_bytes`), and the zoom-out takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the warp kernel has no CPU mode")
    img = torch.from_numpy(image(shape)).cuda()
    hom = s640_homs(shape[0], seed=2)
    hom = {"s640": hom, "single": hom[0], "zoom_out": zoom_out(hom),
           "sign_change": sign_change(hom)}[kind]
    hom = torch.from_numpy(hom).cuda()
    before = cuda_warp.global_tile_count(img.device)
    got = cuda_warp.warp_image_cuda(img, hom, mode)
    global_tiles = cuda_warp.global_tile_count(img.device) - before
    ref = tgeo.warp_image_plain(img, hom, mode)
    nan = ref.isnan()
    assert torch.equal(got.isnan(), nan)
    if mode == "nearest":
        assert torch.equal(got, ref)
    else:
        assert float(torch.where(nan, 0.0, (got - ref).abs()).max()) <= 1e-5
    window = cuda_warp.window_bytes(hom, shape, mode)
    assert global_tiles == int((window > cuda_warp.WINDOW_BYTES).sum())
    if kind == "zoom_out":
        assert global_tiles > 0
