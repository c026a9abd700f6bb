"""The greedy box-NMS kernel's decomposition (`ops/csrc/box_nms.cu`, wrapper
`ops/cuda_box_nms.py`; K2), without JAX, so that the `gpu`-marked tests here
also run on a machine with a card and no JAX (`--noconftest`:
`tests/conftest.py` imports JAX).

On the CPU: the constants the wrapper mirrors match `csrc/box_nms.cu`; the
kernel's mask phase emulated in torch (its CTAs mapped to row blocks and
column words as the kernel maps them, each word a warp's ballot of column
32w + j against row i, only the words from the diagonal on, row blocks
without a valid box left unwritten, pairs with no intersection decided
without the division where the threshold is >= 0) equals the overlap mask of
`greedy_nms_keep_torch`; its scan emulated on that mask, with every word the
kernel does not write filled with noise (the kept rows' words of earlier
blocks ORed per lane, then across the warp, and each 32-row block resolved
serially from its diagonal words) equals `greedy_nms_keep_torch`. Taking the
early-out at a negative threshold would change the mask.

On the card (`gpu`): the kernel's keep masks equal to the plain version on
the same inputs.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolopoint_tpu_torch.ops import cuda_box_nms
from yolopoint_tpu_torch.ops.cuda_box_nms import (
    greedy_nms_keep,
    greedy_nms_keep_torch,
    overlap_mask_torch,
)
from yolopoint_tpu_torch.ops.nms import MAX_WH

torch.set_num_threads(1)

WORD = 32


def kernel_constants() -> dict:
    """The `constexpr int k... = ...;` lines of `csrc/box_nms.cu`, in order."""
    src = (Path(cuda_box_nms.__file__).parent / "csrc" / "box_nms.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([\w\s*/+-]+);", src):
        consts[name] = int(eval(expr, {}, dict(consts)))
    return consts


def test_kernel_constants_match_wrapper():
    k = kernel_constants()
    assert (k["kWord"], k["kMaxK"], k["kMaxWarps"], k["kSms"], k["kFillCtas"]) == (
        cuda_box_nms.WORD, cuda_box_nms.MAX_K, cuda_box_nms.MAX_WARPS, cuda_box_nms.SMS,
        cuda_box_nms.FILL_CTAS)
    assert k["kMaxWords"] * k["kWord"] == k["kMaxK"] <= 64 * k["kWord"]  # a lane's uint64 of blocks
    # the scan's ring of column words fits the default shared memory
    assert k["kScanDepth"] * k["kMaxK"] * 4 + 1024 <= k["kSmemDefault"] == 48 * 1024


@pytest.mark.parametrize("B,K,warps", [
    (16, 512, 8), (8, 1024, 8), (4, 2048, 8), (1, 512, 1), (1, 1024, 2), (1, 1, 1),
])
def test_launch_config_fills_the_card(B, K, warps):
    """Large launches take 8-warp CTAs; B = 1 at K = 512 takes one warp a
    CTA, so that its 136 blocks of 32 x 32 bits spread over the SMs."""
    W, ctas = cuda_box_nms.launch_config(B, K)
    assert W == warps
    assert B * ctas >= cuda_box_nms.FILL_CTAS or W == 1


# ------------------------------------------------------- inputs


def make_boxes(seed, B, K, kind):
    """(boxes (B, K, 4) f32, valid (B, K) bool) of one kind:
      random      centres in 640 x 640, sides 5-150, 85% valid;
      classes     the same, offset by MAX_WH times a class in 0-4 (as the
                  class-offset boxes of the NMS are);
      chain       every box overlaps its neighbours (IoU 0.54), greedy keeps
                  every other one;
      duplicates  random boxes, each repeated in a run of copies;
      invalid     random boxes, none valid;
      edge        zero-area boxes (alone and duplicated), NaN coordinates,
                  boxes nested in others, and random ones."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 640, (B, K, 2))
    wh = rng.uniform(5, 150, (B, K, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    valid = rng.uniform(size=(B, K)) < 0.85
    if kind == "classes":
        boxes += (rng.integers(0, 5, (B, K, 1)) * MAX_WH).astype(np.float32)
    elif kind == "chain":
        x = np.arange(K, dtype=np.float32) * 3.0
        boxes[:] = np.stack([x, np.zeros_like(x), x + 10.0, np.full_like(x, 10.0)], -1)
        valid[:] = True
    elif kind == "duplicates":
        src = np.minimum(np.cumsum(rng.integers(0, 2, (B, K)), 1), K - 1)
        boxes = np.take_along_axis(boxes, src[..., None], 1)
    elif kind == "invalid":
        valid[:] = False
    elif kind == "edge":
        pick = rng.integers(0, 5, (B, K))
        x0 = boxes[..., 0]
        boxes[..., 2] = np.where(pick == 0, x0, boxes[..., 2])      # zero width
        boxes[..., 3] = np.where(pick == 1, boxes[..., 1], boxes[..., 3])  # zero height
        boxes[..., 0] = np.where(pick == 2, np.nan, x0)
        boxes[..., 3] = np.where((pick == 3) & (np.arange(K) % 2 == 0), np.nan, boxes[..., 3])
        boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]  # duplicates of any kind
        inner = boxes[:, 2::9].copy()
        inner[..., :2] += 1.0
        inner[..., 2:] -= 1.0
        boxes[:, 3::9] = inner[:, :boxes[:, 3::9].shape[1]]               # nested boxes
    return torch.from_numpy(np.ascontiguousarray(boxes)), torch.from_numpy(valid)


# ------------------------------------------------------- mask phase


def intersection(boxes):
    """(B, K, K) f32 intersection areas as the kernel rounds them (min / max
    passing NaN on, clamp at 0 keeping NaN)."""
    a, c = boxes[:, :, None, :], boxes[:, None, :, :]
    w = torch.minimum(a[..., 2], c[..., 2]) - torch.maximum(a[..., 0], c[..., 0])
    h = torch.minimum(a[..., 3], c[..., 3]) - torch.maximum(a[..., 1], c[..., 1])
    w = torch.where(w < 0, 0.0, w)
    h = torch.where(h < 0, 0.0, h)
    return w * h


def pair_bits(boxes, thr, early_out=True, early_out_negative=False):
    """(B, K, K): the kernel's `overlaps` of row i and column j, each f32
    operation as the kernel rounds it; where `inter == 0` and the early-out
    applies (thr >= 0, or any thr with `early_out_negative`) the bit is 0
    without the division."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    inter = intersection(boxes)
    den = area[:, :, None] + area[:, None, :] - inter + torch.tensor(1e-7, dtype=torch.float32)
    bits = inter / den > thr
    if early_out and (thr >= 0 or early_out_negative):
        bits = torch.where(inter == 0, False, bits)
    return bits


def cta_tasks(B, K):
    """The (row block, column word) pairs the kernel's CTAs make, from
    `launch_config` and the kernel's map of a CTA index to its row block."""
    W, ctas = cuda_box_nms.launch_config(B, K)
    nw = -(-K // WORD)
    tasks = []
    for x in range(ctas):
        rb, c, n = 0, x, -(-nw // W)
        while c >= n:
            c -= n
            rb += 1
            n = -(-(nw - rb) // W)
        tasks += [(rb, rb + c * W + warp) for warp in range(W) if rb + c * W + warp < nw]
    return tasks


def emulate_mask(boxes, valid, thr, noise_seed=0, **bits_kw):
    """The kernel's bitmask, `(B, nw, 32 nw)` int64 words, m[b, w, i] = word
    w of row i; every word it does not write is noise."""
    B, K, _ = boxes.shape
    nw = -(-K // WORD)
    KP = nw * WORD
    bits = pair_bits(boxes, thr, **bits_kw)
    later = torch.arange(K)[None, :] > torch.arange(K)[:, None]
    bits &= later & valid[:, None, :] & valid[:, :, None]
    bits = torch.nn.functional.pad(bits, (0, KP - K, 0, KP - K))
    words = (bits.reshape(B, KP, nw, WORD).long() << torch.arange(WORD)).sum(-1)  # (B, KP, nw)
    rng = np.random.default_rng(noise_seed)
    m = torch.from_numpy(rng.integers(0, 2 ** 32, (B, nw, KP)))
    tasks = cta_tasks(B, K)
    assert sorted(tasks) == [(rb, w) for rb in range(nw) for w in range(rb, nw)]  # each once
    vpad = torch.nn.functional.pad(valid, (0, KP - K))
    for b in range(B):
        for rb, w in tasks:
            rows = slice(rb * WORD, rb * WORD + WORD)
            if not vpad[b, rows].any():
                continue  # no valid row in the block: nothing reads its words
            cols = vpad[b, w * WORD:w * WORD + WORD]
            m[b, w, rows] = words[b, rows, w] if cols.any() else 0
    return m


def unpack_upper(m, valid):
    """(B, K, K) bool from the mask's words that the kernel writes: those
    that hold some column j > i, of rows in a block with a valid row."""
    B, nw, KP = m.shape
    K = valid.shape[1]
    bits = (m.permute(0, 2, 1)[..., None] >> torch.arange(WORD)) & 1  # (B, KP, nw, 32)
    bits = bits.reshape(B, KP, KP).bool()
    i = torch.arange(KP)[:, None]
    j = torch.arange(KP)[None, :]
    vpad = torch.nn.functional.pad(valid, (0, KP - K))
    written = vpad.reshape(B, nw, WORD).any(-1).repeat_interleave(WORD, 1)  # (B, KP)
    return (bits & (j // WORD >= i // WORD) & written[:, :, None])[:, :K, :K]


def emulate_scan(m, valid):
    """The kernel's scan of each image, as one warp runs it."""
    B, nw, KP = m.shape
    K = valid.shape[1]
    m = m.numpy().astype(np.uint64)
    vpad = np.zeros((B, KP), bool)
    vpad[:, :K] = valid.numpy()
    keep = np.zeros((B, KP), bool)
    full = (1 << WORD) - 1
    for b in range(B):
        kept_rows = np.zeros(KP, bool)
        for w in range(nw):
            vbits = sum(1 << lane for lane in range(WORD) if vpad[b, w * WORD + lane])
            if not vbits:
                continue
            col = m[b, w]
            acc = np.where(kept_rows[:w * WORD], col[:w * WORD], 0)  # per lane, earlier blocks
            removed = int(np.bitwise_or.reduce(acc, initial=np.uint64(0))) | (~vbits & full)
            diag = col[w * WORD:(w + 1) * WORD]
            for r in range(WORD):
                if not (removed >> r) & 1:
                    removed |= int(diag[r])
            kept = ~removed & full
            for lane in range(WORD):
                kept_rows[w * WORD + lane] = keep[b, w * WORD + lane] = bool((kept >> lane) & 1)
    return torch.from_numpy(keep[:, :K])


# K, kinds, B: every kind at the small K; the chain (whose plain fixpoint
# takes K rounds) up to 512
CASES = [(K, kind, 2) for K in (1, 31, 32, 33) for kind in
         ("random", "classes", "chain", "duplicates", "invalid", "edge")]
CASES += [(512, kind, 2) for kind in ("random", "classes", "chain", "duplicates", "edge")]
CASES += [(1024, "classes", 2), (1024, "edge", 1), (2048, "random", 1), (2048, "classes", 1)]


@pytest.mark.parametrize("thr", [0.45, 0.0, -0.1])
@pytest.mark.parametrize("K,kind,B", CASES)
def test_mask_emulation_equals_plain_overlap(K, kind, B, thr):
    boxes, valid = make_boxes(K + len(kind), B, K, kind)
    m = emulate_mask(boxes, valid, thr)
    want = overlap_mask_torch(boxes, valid, thr)
    assert torch.equal(unpack_upper(m, valid), want)
    if (kind == "chain" and K > 1) or (kind in ("random", "classes", "edge") and K >= 512):
        assert want.any()


@pytest.mark.parametrize("K,kind,B", [c for c in CASES if c[0] <= 512])
def test_early_out_needs_a_threshold_of_at_least_zero(K, kind, B):
    """At thr = -0.1 a valid later pair with no intersection overlaps (an
    IoU of 0 is > -0.1); an early-out taken there drops exactly those."""
    boxes, valid = make_boxes(K + len(kind), B, K, kind)
    want = overlap_mask_torch(boxes, valid, -0.1)
    bad = unpack_upper(emulate_mask(boxes, valid, -0.1, early_out_negative=True), valid)
    later = torch.arange(K)[None, :] > torch.arange(K)[:, None]
    disjoint = (intersection(boxes) == 0) & later & valid[:, :, None] & valid[:, None, :]
    assert torch.equal(want ^ bad, disjoint)
    if kind in ("random", "classes", "chain", "duplicates") and K >= 31:
        assert disjoint.any()


@pytest.mark.parametrize("thr", [0.45, 0.0, -0.1])
@pytest.mark.parametrize("K,kind,B", CASES)
def test_scan_emulation_equals_plain(K, kind, B, thr):
    boxes, valid = make_boxes(K + len(kind), B, K, kind)
    keep = emulate_scan(emulate_mask(boxes, valid, thr, noise_seed=K), valid)
    want = greedy_nms_keep_torch(boxes, valid, thr)
    assert torch.equal(keep, want)
    if kind == "chain" and thr == 0.45:
        assert want[:, 0::2].all() and not want[:, 1::2].any()
    if kind == "invalid":
        assert not want.any()


def test_cpu_tensors_take_the_plain_version():
    boxes, valid = make_boxes(3, 2, 64, "classes")
    before = sum(cuda_box_nms._build.launch_counts.values())
    assert torch.equal(greedy_nms_keep(boxes, valid, 0.45), greedy_nms_keep_torch(boxes, valid, 0.45))
    assert sum(cuda_box_nms._build.launch_counts.values()) == before


# ------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the box NMS kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("thr", [0.45, 0.0, -0.1])
def test_kernel_equal_plain_on_the_card(thr):
    """Every input of the emulation, and the serve and val shapes."""
    _cuda()
    from yolopoint_tpu_torch.ops import _build

    cases = CASES + [(512, "random", 16), (1024, "random", 8), (2048, "random", 4),
                     (512, "invalid", 16), (1024, "chain", 1)]
    for K, kind, B in cases:
        boxes, valid = make_boxes(K + len(kind), B, K, kind)
        before = _build.launch_counts["greedy_nms_keep"]
        got = greedy_nms_keep(boxes.cuda(), valid.cuda(), thr)
        want = greedy_nms_keep_torch(boxes.cuda(), valid.cuda(), thr)
        assert torch.equal(got, want), (K, kind, B, thr)
        assert _build.launch_counts["greedy_nms_keep"] - before == 1


@pytest.mark.gpu
def test_kernel_reuses_its_scratch_across_shapes():
    """Calls that grow and shrink the scratch, back to back on one stream,
    each equal to the plain version (the arrival counters return to 0)."""
    _cuda()
    for K, kind, B in [(2048, "random", 4), (33, "edge", 2), (1024, "classes", 8),
                       (512, "chain", 2), (2048, "classes", 1)] * 2:
        boxes, valid = make_boxes(K, B, K, kind)
        got = greedy_nms_keep(boxes.cuda(), valid.cuda(), 0.45)
        assert torch.equal(got.cpu(), greedy_nms_keep_torch(boxes, valid, 0.45)), (K, kind, B)
