"""The keypoint NMS kernel's tiling (`ops/csrc/nms_keys.cu`, wrapper
`ops/cuda_nms.py`; K1 keys and K6 maps), without JAX, so that the
`gpu`-marked tests here also run on a machine with a card and no JAX
(`--noconftest`: `tests/conftest.py` imports JAX).

On the CPU: the constants the wrapper mirrors match `csrc/nms_keys.cu`, and
every configuration fits the card's shared memory and the blocks-per-SM
target; the kernel's tiling emulated in torch (each block's staged tile cut
as the kernel cuts it, from a first column rounded down to a chunk; NMS on
the staged tile with the window clipped at its edge, each round only on the
rows and columns the kernel computes, scores suppressed in place as -0.0,
uncomputed scratch as NaN; the interior written) equals
`nms_suppressed_map_torch` bit for bit, and differs from it once the halo
is cut by one pixel; the mask words' dilation (funnel shifts across words,
an OR over rows, bytes per chunk) equals the max-pool dilation.

Where no interior fits (large radii), the kernel's global-memory branch:
the wrappers plan it instead of raising, and its round structure emulated
in torch (separable window maxima along rows then columns, the kept mask
dilated the same way, suppressed scores as +0.0) equals
`nms_suppressed_map_torch` bit for bit.

On the card (`gpu`): K1 keys and K6 maps equal to their plain versions at
the emulated shapes, in bf16 and f32, at both interiors and past the
statically compiled radii, and through the global branch at r = 15 (f32)
and r = 22 (bf16) on (16, 660, 660).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolopoint_tpu_torch.ops import cuda_nms
from yolopoint_tpu_torch.ops.cuda_nms import (
    nms_suppressed_map,
    nms_suppressed_map_torch,
    nms_tile_keys,
    nms_tile_keys_torch,
)

torch.set_num_threads(1)

CONF, BORDER = 0.015, 4
SHAPES = [(640, 640), (101, 94), (37, 53), (1, 1)]
RADII = [0, 1, 3, 4, 5, 7]


def heatmap(seed, B, H, W, dtype=torch.bfloat16, n_peaks=120, edge_peaks=24):
    """A background around CONF (bf16 makes plateaus of equal values there),
    sparse peaks, a band of peaks along the bottom and right edges (inside
    and outside the border), and two tied plateaus: a 2x3 block of the
    map's largest value and a 2x5 block (the inputs of
    `tests/test_torch_k6.py`)."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.02, (B, H, W)).astype(np.float32)
    for b in range(B):
        hm[b, rng.integers(0, H, n_peaks), rng.integers(0, W, n_peaks)] = \
            rng.uniform(0.1, 1.0, n_peaks)
        ys = rng.integers(max(H - 12, 0), H, edge_peaks)
        xs = rng.integers(0, W, edge_peaks)
        hm[b, ys, xs] = rng.uniform(0.05, 0.9, edge_peaks)
        hm[b, xs % H, rng.integers(max(W - 12, 0), W, edge_peaks)] = \
            rng.uniform(0.05, 0.9, edge_peaks)
        hm[b, 24:26, 24:27] = 0.9999
        hm[b, 40:42, 11:16] = 0.6
    return torch.from_numpy(hm).to(dtype)


def _tile(H, W, r):
    """K1's tile: the radius where it divides the map, else 1."""
    t = max(r, 1)
    return t if H % t == 0 and W % t == 0 else 1


def kernel_constants() -> dict:
    """The `constexpr int k... = ...;` lines of `csrc/nms_keys.cu`, in order."""
    src = (Path(cuda_nms.__file__).parent / "csrc" / "nms_keys.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([\w\s*/+-]+);", src):
        consts[name] = int(eval(expr, {}, dict(consts)))
    return consts


def test_kernel_constants_match_wrapper_and_fit_shared_memory():
    k = kernel_constants()
    assert (k["kThreads"], k["kBlocksPerSm"], k["kSms"], k["kWord"], k["kChunk"]) == (
        cuda_nms.THREADS, cuda_nms.BLOCKS_PER_SM, cuda_nms.SMS, cuda_nms.WORD, cuda_nms.CHUNK)
    assert (k["kSmemPerSm"], k["kSmemReserved"], k["kSmemLimit"]) == (
        cuda_nms.SMEM_PER_SM, cuda_nms.SMEM_RESERVED, cuda_nms.SMEM_LIMIT)
    assert (k["kLargeTH"], k["kLargeTW"]) == cuda_nms.LARGE_INTERIOR
    assert (k["kSmallTH"], k["kSmallTW"]) == cuda_nms.SMALL_INTERIOR
    assert (k["kMaxStagedRatio"], k["kGlobalScratchBytes"]) == (
        cuda_nms.MAX_STAGED_RATIO, cuda_nms.GLOBAL_SCRATCH_BYTES)
    assert cuda_nms.SMEM_LIMIT <= 227 * 1024  # a block's shared memory on the H100
    assert 65536 // (k["kBlocksPerSm"] * k["kThreads"]) >= 64  # registers a thread
    # the large interior keeps kBlocksPerSm blocks on an SM at the serve path's
    # radii (bf16), and every configuration of the paths fits a block
    for r in (3, 4):
        cfg = cuda_nms.staged_shape(*cuda_nms.LARGE_INTERIOR, 5 * r, 2)
        assert (cfg.smem + cuda_nms.SMEM_RESERVED) * cuda_nms.BLOCKS_PER_SM <= cuda_nms.SMEM_PER_SM
    for elem in (2, 4):
        for r in range(9):
            for B, H, W in ((16, 640, 640), (1, 640, 640), (2, 101, 94)):
                cfg = cuda_nms.tile_config(B, H, W, elem, r, 3, 1)
                assert cfg is not None and cfg.smem <= cuda_nms.SMEM_LIMIT, (elem, r, B)


@pytest.mark.parametrize("B,elem,r,want", [
    (16, 2, 4, "large"), (8, 2, 4, "large"), (16, 2, 3, "large"), (1, 2, 4, "small"),
    (8, 4, 4, "small"), (2, 2, 7, "small"),
])
def test_tile_config_picks_the_interior(B, elem, r, want):
    """The serve path's B = 16 and the val path's B = 8 fill the card with
    large interiors; batch 1 and f32 (2 blocks an SM at most) take the small
    one."""
    t = _tile(640, 640, r)
    cfg = cuda_nms.tile_config(B, 640, 640, elem, r, 3, t)
    interior = {"large": cuda_nms.LARGE_INTERIOR, "small": cuda_nms.SMALL_INTERIOR}[want]
    assert (cfg.TH, cfg.TW) == tuple(-(-v // t) * t for v in interior)


# B, H, W, dtype, radius: no interior fits at 3 iterations
LARGE_RADII = [(16, 640, 640, torch.float32, 15), (16, 640, 640, torch.bfloat16, 22),
               (1, 64, 64, torch.float32, 60)]


def test_wrapper_raises_where_no_interior_fits():
    """Where no block interior fits (r = 15 in f32 and r = 22 in bf16 at
    (16, 640, 640), r = 60 on a 64 x 64 map), the wrappers plan the global
    branch, counted under its own key with its scratch, and do not raise;
    the serve path's radius 4 keeps the shared-memory kernel."""
    for B, H, W, dtype, r in LARGE_RADII:
        hm = torch.zeros((), dtype=dtype).expand(B, H, W)
        for t in (1, r):
            assert cuda_nms.tile_config(B, H, W, hm.element_size(), r, 3, t) is None, (r, t)
        for key in ("K6", "nms_tile_keys"):
            assert cuda_nms._plan(hm, r, 3, 1, key) == (
                key + "_global", B * H * W * cuda_nms.GLOBAL_SCRATCH_BYTES)
    hm = torch.zeros((), dtype=torch.bfloat16).expand(16, 640, 640)
    assert cuda_nms._plan(hm, 4, 3, 4, "nms_tile_keys") == ("nms_tile_keys", 0)


# ------------------------------------------------------- tiling emulation


def _maxpool(x, ky, kx):
    """Window max of (N, SH, SP) over ky x kx, clipped at the edge; NaN
    propagates (stale scratch)."""
    return F.max_pool2d(x[:, None], (2 * ky + 1, 2 * kx + 1), stride=1, padding=(ky, kx))[:, 0]


def emulate_tiles(heat, conf, r, iterations, border, interior=None, halo_cut=0):
    """The kernel's K6 map, block by block, in torch (all blocks at once).

    Each block stages rows [by*TH - halo, +SH) and columns [gx0, +SP) with
    gx0 = (bx*TW - halo) rounded down to a CHUNK, -inf outside the image;
    round k computes the kernel's rows and columns only (the interior plus
    e = 2*(iterations-k)*r; scratch elsewhere is NaN), suppresses scores in
    place as -0.0 on the chunks the kernel touches, and tests maxima as the
    kernel does; the interior's kept pixels take the thresholded heatmap."""
    B, H, W = heat.shape
    halo = (2 * iterations - 1) * r
    if interior is None:
        cfg = cuda_nms.tile_config(B, H, W, heat.element_size(), r, iterations, 1)
        interior = (cfg.TH, cfg.TW)
    TH, TW = interior
    halo -= halo_cut
    cfg = cuda_nms.staged_shape(TH, TW, halo, heat.element_size())
    SH, SP, C = cfg.SH, cfg.SP, cuda_nms.CHUNK
    nby, nbx = -(-H // TH), -(-W // TW)
    gy0 = torch.arange(nby) * TH - halo
    gx0 = torch.div(torch.arange(nbx) * TW - halo, C, rounding_mode="floor") * C
    oy, ox = halo, torch.arange(nbx) * TW - gx0                       # interior in the tile
    rows = gy0[:, None] + torch.arange(SH)                            # (nby, SH)
    cols = gx0[:, None] + torch.arange(SP)                            # (nbx, SP)
    inside = (((rows >= 0) & (rows < H))[:, None, :, None]
              & ((cols >= 0) & (cols < W))[None, :, None, :])         # (nby, nbx, SH, SP)
    s = heat.float()
    s = torch.where(s >= conf, s, 0.0)
    s = torch.where(s == 0, 0.0, s)                                   # -0.0 -> +0.0
    tile = s[:, rows.clamp(0, H - 1)][:, :, :, cols.clamp(0, W - 1)]  # (B, nby, SH, nbx, SP)
    tile = tile.permute(0, 1, 3, 2, 4)
    ss = torch.where(inside, tile, -torch.inf).reshape(-1, SH, SP)
    inside = inside.expand(B, -1, -1, -1, -1).reshape(-1, SH, SP)
    maxb = torch.zeros_like(ss, dtype=torch.bool)
    ys = torch.arange(SH)[:, None]
    xs = torch.arange(SP)[None, :]
    oxb = ox[None, None, :, None, None].expand(B, nby, nbx, 1, 1).reshape(-1, 1, 1)

    def area(y_lo, y_hi, x_lo, x_hi):  # staged rows and columns, x per block
        return (ys >= y_lo) & (ys < y_hi) & (xs >= x_lo) & (xs < x_hi)

    def chunks(x_lo, x_hi):  # the chunks covering [x_lo, x_hi), as column bounds
        return x_lo.div(C, rounding_mode="floor") * C, -(-x_hi // C) * C

    for k in range(1, iterations + 1):
        e = 2 * (iterations - k) * r
        ya, yb, xa, xb = oy - e, oy + TH + e, oxb - e, oxb + TW + e
        if k > 1:
            supp = (_maxpool(_maxpool(maxb.float(), r, 0), 0, r) > 0) & inside
            zone = area(ya - r, yb + r, *chunks(xa - r, xb + r))
            ss = torch.where(supp & zone, -0.0, ss)
        tmp = torch.full_like(ss, torch.nan)
        zone = area(ya - r, yb + r, *chunks(xa, xb))
        tmp = torch.where(zone, _maxpool(ss, 0, r), tmp)
        m = _maxpool(tmp, r, 0)
        free = ~(torch.signbit(ss) & (ss == 0))
        maxb |= free & (ss == m) & inside & area(ya, yb, xa, xb)

    iy = oy + torch.arange(TH)
    ix = oxb.reshape(-1, 1) + torch.arange(TW)                        # (N, TW)
    kept = maxb[torch.arange(maxb.shape[0])[:, None, None], iy[None, :, None], ix[:, None, :]]
    kept = kept.reshape(B, nby, nbx, TH, TW).permute(0, 1, 3, 2, 4).reshape(B, nby * TH, nbx * TW)
    kept = kept[:, :H, :W]
    gy, gx = torch.arange(H)[:, None], torch.arange(W)[None, :]
    kept &= (gy >= border) & (gy < H - border) & (gx >= border) & (gx < W - border)
    return torch.where(kept, torch.where(heat.float() >= conf, heat.float(), 0.0), 0.0)


@pytest.mark.parametrize("r", RADII)
@pytest.mark.parametrize("H,W", SHAPES)
def test_tiling_emulation_equals_plain(H, W, r):
    """Both interiors, iterations 1-3: bit-equal (the staged geometry does
    not depend on the input's width; f32 also at the interior it picks)."""
    hm = heatmap(10 * r + H % 7, 1, H, W)
    for it in (1, 2, 3):
        want = nms_suppressed_map_torch(hm, CONF, r, it, BORDER)
        for interior in (cuda_nms.LARGE_INTERIOR, cuda_nms.SMALL_INTERIOR):
            got = emulate_tiles(hm, CONF, r, it, BORDER, interior)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (it, interior)
        if H < 640:
            hm32 = heatmap(10 * r + H % 7 + 1, 2, H, W, torch.float32)
            want = nms_suppressed_map_torch(hm32, CONF, r, it, BORDER)
            got = emulate_tiles(hm32, CONF, r, it, BORDER)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (it, "f32")
    assert int((want > 0).sum()) > 0 or H * W == 1


def chain(H, W, r, iterations, row, col):
    """Zeros but for 2*iterations scores decreasing down one column, r rows
    apart, the last at (row, col): the first decides, through every round,
    whether the last is kept, (2*iterations-1)*r rows away (the halo)."""
    hm = torch.zeros(1, H, W)
    for k in range(2 * iterations):
        hm[0, row - (2 * iterations - 1 - k) * r, col] = 0.9 - 0.1 * k
    return hm.bfloat16()


@pytest.mark.parametrize("r,it", [(4, 3), (3, 2), (7, 3), (1, 2)])
def test_tiling_emulation_needs_the_whole_halo(r, it):
    """A chain of suppressions ending on a block's first interior row: the
    emulation equals the plain version, and once the halo is one pixel short
    the chain's first score is out of the tile and the last one flips."""
    for TH, TW in (cuda_nms.LARGE_INTERIOR, cuda_nms.SMALL_INTERIOR):
        hm = chain(160, 192, r, it, 2 * TH, 50)  # a block's first row
        want = nms_suppressed_map_torch(hm, CONF, r, it, BORDER)
        assert torch.equal(emulate_tiles(hm, CONF, r, it, BORDER, (TH, TW)), want)
        cut = emulate_tiles(hm, CONF, r, it, BORDER, (TH, TW), halo_cut=1)
        assert float(want[0, 2 * TH, 50]) == 0.0 and float(cut[0, 2 * TH, 50]) > 0, (TH, TW)


# ------------------------------------------------------- global branch


def emulate_global(heat, conf, r, iterations, border):
    """The global branch's K6 map, pass by pass as the kernel runs them:
    threshold; window max along rows, then along columns (out-of-image
    pixels out of the window); the maxima test; each later round dilates the
    kept mask along rows, then columns, replaces the suppressed scores by
    +0.0, takes the window max again and adds the new maxima outside the
    suppressed area; then the border."""
    B, H, W = heat.shape

    def row_max(x):
        return F.max_pool2d(x[:, None], (1, 2 * r + 1), 1, (0, r))[:, 0]

    def col_max(x):
        return F.max_pool2d(x[:, None], (2 * r + 1, 1), 1, (r, 0))[:, 0]

    s = heat.float()
    s = torch.where(s >= conf, s, 0.0)
    kept = s == col_max(row_max(s))
    for _ in range(iterations - 1):
        sup = col_max(row_max(kept.float())) > 0
        z = torch.where(sup, 0.0, s)
        kept = kept | ((z == col_max(row_max(z))) & ~sup)
    gy, gx = torch.arange(H)[:, None], torch.arange(W)[None, :]
    kept &= (gy >= border) & (gy < H - border) & (gx >= border) & (gx < W - border)
    return torch.where(kept, s, 0.0)


@pytest.mark.parametrize("r,H,W", [(15, 160, 176), (22, 176, 154), (60, 64, 64)])
def test_global_branch_emulation_equals_plain(r, H, W):
    """Iterations 1-3, bf16 and f32: bit-equal, with survivors. Where it
    fits, a chain of four scores r rows apart makes the later rounds count:
    the third is kept from the second round on."""
    row = H - BORDER - 1
    fits = row - 3 * r >= 0
    for dtype in (torch.bfloat16, torch.float32):
        hm = heatmap(r + H, 2, H, W, dtype, n_peaks=40)
        if fits:
            hm[1] = chain(H, W, r, 2, row, W // 2)[0].to(dtype)
        for it in (1, 2, 3):
            want = nms_suppressed_map_torch(hm, CONF, r, it, BORDER)
            got = emulate_global(hm, CONF, r, it, BORDER)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (dtype, it)
            assert int((want > 0).sum()) > 0
            if fits:
                assert (float(want[1, row - r, W // 2]) > 0) == (it > 1), (dtype, it)
    assert fits or r == 60


# ------------------------------------------------------- mask-word dilation

U32 = 0xFFFFFFFF


def _funnel_l(lo, hi, m):
    """`__funnelshift_l(lo, hi, m)`: the upper word of (hi:lo) << m."""
    return (((hi << 32) | lo) << m >> 32) & U32


def _funnel_r(lo, hi, m):
    """`__funnelshift_r(lo, hi, m)`: the lower word of (hi:lo) >> m."""
    return (((hi << 32) | lo) >> m) & U32


def words_of(mask):
    """(H, W) bool -> (H, NW) int64 words, bit j of word w = pixel 32w + j."""
    H, W = mask.shape
    NW = -(-W // 32)
    bits = F.pad(mask.long(), (0, NW * 32 - W)).reshape(H, NW, 32)
    return (bits << torch.arange(32)).sum(-1)


def dilate_words(words, r):
    """The kernel's row dilation (funnel shifts across words, for any r) and
    its column OR taken byte by byte as `suppress` reads it, as words."""
    H, NW = words.shape
    pad = torch.zeros(H, NW + 2 * (r // 32 + 2), dtype=torch.int64)
    o = r // 32 + 2
    pad[:, o:o + NW] = words

    def word(j):  # the words at offset j from each word, 0 off the row
        return pad[:, o + j:o + j + NW]

    h = words.clone()
    for k in range(1, r + 1):
        s, m = divmod(k, 32)
        h |= _funnel_l(word(-s - 1), word(-s), m) | _funnel_r(word(s), word(s + 1), m)
    hb8 = torch.stack([(h >> (8 * i)) & 0xFF for i in range(4)], -1).reshape(H, NW * 4)
    out = torch.zeros_like(hb8)
    for y in range(H):
        for j in range(max(y - r, 0), min(y + r, H - 1) + 1):
            out[y] |= hb8[j]
    return (out.reshape(H, NW, 4) << (8 * torch.arange(4))).sum(-1)


@pytest.mark.parametrize("H,W,r,density", [
    (40, 176, 4, 0.03), (33, 50, 3, 0.05), (20, 31, 1, 0.1), (9, 64, 0, 0.2),
    (24, 100, 7, 0.02), (12, 200, 40, 0.01), (30, 96, 8, 0.5),
])
def test_word_dilation_equals_maxpool(H, W, r, density):
    rng = np.random.default_rng(H * W + r)
    mask = torch.from_numpy(rng.random((H, W)) < density)
    want = F.max_pool2d(mask.float()[None, None], 2 * r + 1, 1, r)[0, 0] > 0
    row = words_of(torch.ones(H, W, dtype=torch.bool))  # the kernel reads no bit past W
    got = dilate_words(words_of(mask), r) & row
    assert torch.equal(got, words_of(want))
    assert int(mask.sum()) > 0


# ------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("H,W", SHAPES)
def test_kernels_equal_plain_on_the_card(H, W, dtype):
    """K6 maps and K1 keys at every radius of the emulation, iterations 1-3,
    at batch 1 (small interior) and batch 16 at 640 (large, bf16)."""
    _cuda()
    for r in RADII + [9]:  # 9: past the statically compiled radii
        for B in (1, 16) if (H, W) == (640, 640) else (2,):
            hm = heatmap(r + B, B, H, W, dtype).cuda()
            for it in (1, 2, 3):
                got = nms_suppressed_map(hm, CONF, r, it, BORDER)
                want = nms_suppressed_map_torch(hm, CONF, r, it, BORDER)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (r, B, it)
                t = _tile(H, W, r)
                got = nms_tile_keys(hm, CONF, r, it, BORDER, t)
                want = nms_tile_keys_torch(hm, CONF, r, it, BORDER, t)
                assert torch.equal(got, want), ("keys", r, B, it)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,r", [(torch.float32, 15), (torch.bfloat16, 22)],
                         ids=["f32-r15", "bf16-r22"])
def test_global_branch_equal_plain_on_the_card(dtype, r):
    """K6 maps and K1 keys (tile r, which divides 660) at (16, 660, 660),
    iterations 1-3: through the global branch at 3 iterations (and where
    `_plan` picks it at fewer), counted under the key `_plan` gives."""
    _cuda()
    from yolopoint_tpu_torch.ops import _build

    hm = heatmap(r, 16, 660, 660, dtype).cuda()
    for it in (1, 2, 3):
        plans = [cuda_nms._plan(hm, r, it, 1, "K6")[0],
                 cuda_nms._plan(hm, r, it, r, "nms_tile_keys")[0]]
        assert it < 3 or plans == ["K6_global", "nms_tile_keys_global"]
        before = dict(_build.launch_counts)
        got = nms_suppressed_map(hm, CONF, r, it, BORDER)
        want = nms_suppressed_map_torch(hm, CONF, r, it, BORDER)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), it
        got = nms_tile_keys(hm, CONF, r, it, BORDER, r)
        want = nms_tile_keys_torch(hm, CONF, r, it, BORDER, r)
        assert torch.equal(got, want), ("keys", it)
        assert int((want > 0).sum()) > 0
        for key in plans:
            assert _build.launch_counts[key] - before.get(key, 0) == 1, (key, it)


@pytest.mark.gpu
def test_k6_kernel_bit_equal_on_the_card():
    _cuda()
    for dtype, (H, W), r in ((torch.float32, (101, 94), 5), (torch.bfloat16, (640, 640), 4)):
        hm = heatmap(r, 2, H, W, dtype).to("cuda")
        got = nms_suppressed_map(hm, CONF, r, 3, BORDER)
        want = nms_suppressed_map_torch(hm, CONF, r, 3, BORDER)
        assert torch.equal(got, want)
