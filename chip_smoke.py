#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolopoint_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build      compile the CUDA kernels from `yolopoint_tpu_torch/ops/csrc/`
             (one nvcc process a source, all at once, linked into one
             library loaded with ctypes) and time it;
  kernel     per kernel and input, the kernel against its plain PyTorch
             version on the card (K1 keys bit-equal at batch 16, 1 and 8
             f32, and at the export's (1, 640, 640) and HPatches' (1, 256,
             320) f32, K2 keep masks equal, K3 within 1e-5), with median times
             from CUDA events, `kernel_ms` (its launches alone under a CUDA
             graph) and the bound's share of it, and the launches the check
             made; K3 also `library_ms`, `F.grid_sample` + `F.normalize` on
             the same inputs (held to 1e-5 of the plain version first);
  kernel     (K2 val tiles) K2 on the inputs of every K2 launch of one
             `TrainAgent.validate` batch of the val phase's config (the
             tiles of the box-NMS scan, recorded by wrapping the NMS
             module's `greedy_nms_keep`): each keep mask equal, the tile and
             valid counts, times per tile;
  kernel     (warp) the homography warp kernel (K4 and K5) against its plain
             version: bilinear within 1e-5 at (32, 640, 640, 3), nearest
             bit-equal at (32, 80, 80, 1), and the other `WARP_INPUTS` (the
             export's views (50, 640, 640, 3) and warps back (50, 640, 640,
             1), a zoom-out that reaches the global branch,
             a w2 sign change, ragged tiles, W * C odd, C = 2 and 4, one
             (3, 3) homography), NaN at the same pixels; the tiles that took
             the global branch (the kernel's counter) equal to those whose
             window exceeds the budget; `kernel_ms` the launches alone under
             a CUDA graph beside the wrapper's `ms`; with `F.grid_sample` on
             the same inputs, in the same mode, as the library yardstick.
             Fails if more than 5% of the train path's K4 tiles, or none of
             the zoom-out's, take the global branch;
  kernel     (K6) the suppressed keypoint map bit-equal to its plain version
             at (16, 640, 640) bf16 radius 4, at (1, 256, 320) f32, and at
             two inputs no tile divides, with `kernel_ms` as K1; no single
             PyTorch call computes it;
  kernel     (large radii) K6 at (16, 640, 640) f32 r=15 and (1, 64, 64) f32
             r=60, K1 at (16, 660, 660) bf16 r=22 (tile 22): launches no
             block interior fits, through the global-memory branch (counted
             under its own key, `branch`), bit-equal, with `kernel_ms`;
  reference  YOLOPoint-S in f32 on a small input: the forward on the card
             against the CPU, and the decode on the card (kernels) against
             the CPU decode (plain versions) of the same forward outputs:
             boxes at the 0.25 gate, boxes at the 0.001 gate (the nc=5 s640
             model's predictions decoded on the card; at least one box,
             counts and classes equal, coordinates within 1e-4), keypoints
             at radii 3 and 7 (K6; equal);
  serve      YOLOPoint-S (nc=80, 640x640, bf16, BN folded, seeded random
             weights) through `InferencePipeline` at the benchmark operating
             point, on uint8 batches of 1 and 16; checks shapes, finiteness
             and that K1, K2 and K3 each launched on this path;
  serve_untiled
             the same pipeline at NMS radius 3 (640 is no multiple of 3),
             batch 16: keypoints through K6, one launch per request, no K1;
  serve_frame
             `InferencePipeline.process_frame(frame, img_size=640)` on a
             720x1280 uint8 frame (the demo operating point): the resize
             without OpenCV, then one K1, K2 and K3 launch per frame;
  train_reference
             one micro-step of the train step, f32 with TF32 off,
             YOLOPoint-n at 128x128, B=2: on the card (kernels) against the
             CPU (plain versions), same weights, batch and random draws;
             losses within 1e-4 relative, gradient norms within 1e-3;
  train      `TrainAgent` on the training config of
             `configs/synthetic_s640.yaml` (YOLOPoint-S, nc=5, 640x640, B=32,
             bf16, accum 2): 2 warm-up and 6 timed micro-steps (3 optimizer
             updates) on seeded uint8 batches; time per micro-step, a
             CUDA-event split, peak memory and every loss term; checks
             finite losses, parameters moving only on update steps, the EMA
             moving, and 2 K4 + 1 K5 warp launches per micro-step;
  val_reference
             the val step in f32 with TF32 off, YOLOPoint-n nc=5 at 128x128,
             B=2, on the card against the CPU (same weights, batch, draws):
             losses within 1e-4 relative; the decode of the card's heatmap,
             descriptor map and predictions equal on both (keypoints equal,
             descriptors within 1e-5, detections matched within 1e-4, more
             than 0 boxes);
  val        `TrainAgent.validate` on the s640 config with its val
             augmentation (YOLOPoint-S, nc=5, 640x640, B=8, bf16): 1 warm-up
             and 4 timed batches (the 32 images of the extended metrics);
             time per batch, a CUDA-event split, candidates and detections
             per image, peak memory and every scalar; checks finite scalars,
             more than 2048 candidates per image (the tiled box-NMS scan)
             and K1-K5 launched on this path;
  fit        the training entry: `training.cli.main` on
             `configs/synthetic_s640.yaml` (read and written by the port's
             YAML code) cut to 128 train and 16 val images, 2 epochs, val
             and a checkpoint every epoch (YOLOPoint-S, nc=5, 640x640, B=32,
             bf16, accum 2, EMA; the set rendered on the host without
             OpenCV and put on the card), then `--resume` to 3 epochs, then
             a warm start from a seeded nc=80 reference-schema file with
             shrink-perturb: render seconds per image, seconds per epoch, ms
             per micro-step beside `train`'s, ms per val batch, checkpoint
             writes, peak memory, the resident set's GB, every val scalar
             and file; checks finite losses and scalars, the files and
             `done.json` against the schedule, the resumed state equal to
             the saved one tensor by tensor, only Detect tensors mismatched
             in the warm start, and K1-K5 launched on this path;
  hpatches   `evaluation.hpatches_runner.main` (the CLI's fused bf16 path,
             256x320) on 2 scenes x 5 pairs written at run time in the
             HPatches layout (PPM images warped on the card, `H_1_n`
             files), with seeded YOLOPoint-n weights saved in the reference
             schema and read by the port's loader: the metrics, ms per pair,
             and 2 launches a pair of K1, K2 and K3;
  hpatches_reference
             one of those pairs in f32: the decode of the same raw outputs
             on the card and on the CPU, keypoints equal, descriptors within
             1e-5, the mutual matches and every pair metric equal;
  export     `export.export_pseudo_labels` at the settings of
             `configs/synthetic_s640_export.yaml` (YOLOPoint-S, nc=5, N = 50
             views, 640x640, f32, BN unfolded): 1 warm-up and 4 seeded grey
             images; seconds per image, a CUDA-event split, peak memory, 3
             K4 and 1 K1 launches an image, the warp's global-branch tiles
             per warp, and every file's points;
  export_reference
             the aggregate heatmap of one 128x128 image, N = 4 views, on the
             card against the CPU within 1e-5, and the keypoints of the
             card's aggregate equal on both.
Then a `{"kernels": [...]}` summary line (K2 with its val-tile times, K1 and
K6 with their global branch's key, launches on every path, the lines at the
shapes of the paths other than the kernel's own, and checked lines), the
card's name and power limit as
`nvidia-smi` reports them, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure raises, so the exit code is non-zero; without a GPU, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
SERVE_CONFIG = {  # the benchmark operating point of the JAX package's bench.py
    "detection_threshold": 0.015, "nms": 4, "top_k": 1000, "conf_thresh": 0.25,
    "iou_thresh": 0.45, "max_det": 300, "heatmap_dtype": "bf16", "max_nms": 512,
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of `fn` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- kernels


def heatmap_batch(gen, B, H, W, dtype):
    """Probability-like maps: a background around the 0.015 threshold (bf16
    makes plateaus of equal values there) plus sparse peaks."""
    dev = gen.device
    hm = torch.rand(B, H, W, generator=gen, device=dev) * 0.02
    n = B * H * W // 400
    idx = torch.randint(0, B * H * W, (n,), generator=gen, device=dev)
    hm.view(-1)[idx] = torch.rand(n, generator=gen, device=dev) * 0.9 + 0.1
    return hm.to(dtype)


def nms_bound(hm, out, radius: int, it: int) -> tuple[float, str]:
    """K1's and K6's bound: one read of the heatmap and one write of the
    output, against 2r compares a pixel for each of the 2*it-1 separable
    window maxima (both directions) plus 15 for the rest, over the f32 rate
    (which counts an FMA as two operations; a max or a compare is one
    instruction, so at the f32 instruction rate the same count takes twice
    as long)."""
    B, H, W = hm.shape
    n_bytes = hm.numel() * hm.element_size() + out.numel() * out.element_size()
    n_ops = B * H * W * ((1 + 2 * (it - 1)) * 2 * 2 * radius + 15)
    return bound(n_bytes, n_ops)


def check_k1(gen, B, dtype, reps, H=640, W=640):
    """K1, the tile keys at the serve path's operating point, against its
    plain version: bit-equal. `ms` times the wrapper between two events,
    `kernel_ms` its launches alone under a CUDA graph (`graph_ms`)."""
    from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_keys, nms_tile_keys_torch

    conf, r, it, border = 0.015, 4, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    got = nms_tile_keys(hm, conf, r, it, border)
    ref = nms_tile_keys_torch(hm, conf, r, it, border)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        n_bad = int((got != ref).sum())
        raise AssertionError(f"K1 {dtype} keys differ from the plain version in {n_bad} tiles")
    ms = cuda_ms(lambda: nms_tile_keys(hm, conf, r, it, border), reps)
    kernel_ms = graph_ms(lambda: nms_tile_keys(hm, conf, r, it, border))
    plain_ms = cuda_ms(lambda: nms_tile_keys_torch(hm, conf, r, it, border), max(reps // 4, 3))
    bound_ms, bound_by = nms_bound(hm, got, r, it)
    return {
        "kernel": "nms_tile_keys", "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "survivors": int((ref > 0).sum()), "max_abs_err": int((got - ref).abs().max()),
        "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
    }


def check_k6(gen, B, H, W, dtype, radius, reps):
    """K6, the suppressed map, against its plain version: bit-equal; times
    as `check_k1`."""
    from yolopoint_tpu_torch.ops.cuda_nms import nms_suppressed_map, nms_suppressed_map_torch

    conf, it, border = 0.015, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    got = nms_suppressed_map(hm, conf, radius, it, border)
    ref = nms_suppressed_map_torch(hm, conf, radius, it, border)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"K6 {dtype} {(B, H, W)} r={radius}: {n_bad} pixels differ")
    ms = cuda_ms(lambda: nms_suppressed_map(hm, conf, radius, it, border), reps)
    kernel_ms = graph_ms(lambda: nms_suppressed_map(hm, conf, radius, it, border))
    plain_ms = cuda_ms(lambda: nms_suppressed_map_torch(hm, conf, radius, it, border),
                       max(reps // 4, 3))
    bound_ms, bound_by = nms_bound(hm, got, radius, it)
    return {
        "kernel": "K6", "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "radius": radius, "survivors": int((ref > 0).sum()),
        "max_abs_err": float((got - ref).abs().max()), "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
    }


# kernel, B, H, W, dtype, radius: launches that no block interior fits (3
# iterations), which take the global-memory branch; K1's tile is the radius
LARGE_RADIUS_INPUTS = (
    ("K6", 16, 640, 640, torch.float32, 15),
    ("K1", 16, 660, 660, torch.bfloat16, 22),
    ("K6", 1, 64, 64, torch.float32, 60),
)


def check_large_radius(gen, kernel, B, H, W, dtype, radius):
    """K1 keys or a K6 map through the global-memory branch, bit-equal to
    the plain version; the launch must count under the branch's own key."""
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.cuda_nms import (nms_suppressed_map, nms_suppressed_map_torch,
                                                  nms_tile_keys, nms_tile_keys_torch)

    conf, it, border = 0.015, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    hm[:, H // 2, W // 2] = 1.0  # above every drawn peak: at least one survivor at any radius
    if kernel == "K1":
        key = "nms_tile_keys_global"

        def fn():
            return nms_tile_keys(hm, conf, radius, it, border, radius)

        def plain():
            return nms_tile_keys_torch(hm, conf, radius, it, border, radius)
    else:
        key = "K6_global"

        def fn():
            return nms_suppressed_map(hm, conf, radius, it, border)

        def plain():
            return nms_suppressed_map_torch(hm, conf, radius, it, border)
    before = _build.launch_counts[key]
    got = fn()
    if _build.launch_counts[key] - before != 1:
        raise AssertionError(f"{kernel} r={radius}: the global branch did not count a launch")
    ref = plain()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        n_bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"{kernel} {dtype} {(B, H, W)} r={radius}: {n_bad} values differ")
    survivors = int((ref > 0).sum())
    if survivors == 0:
        raise AssertionError(f"{kernel} r={radius}: nothing survived")
    kernel_ms = graph_ms(fn, count=5, reps=3)
    bound_ms, bound_by = nms_bound(hm, got, radius, it)
    return {
        "kernel": kernel, "branch": key, "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "radius": radius, "survivors": survivors, "max_abs_err": 0,
        "ms": cuda_ms(fn, 5), "kernel_ms": kernel_ms,
        "plain_ms": cuda_ms(plain, 1, warmup=0), "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
    }


def nms_boxes(gen, B, K):
    """Random boxes as in the JAX package's box-NMS tests; the last image is
    an overlapping chain (greedy keeps every other box)."""
    dev = gen.device
    ctr = torch.rand(B, K, 2, generator=gen, device=dev) * 640
    wh = torch.rand(B, K, 2, generator=gen, device=dev) * 145 + 5
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    valid = torch.rand(B, K, generator=gen, device=dev) < 0.85
    x = torch.arange(K, dtype=torch.float32, device=dev) * 3.0  # neighbours: IoU 0.54
    boxes[-1] = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
    valid[-1] = True
    return boxes.contiguous(), valid


def k2_bound(tiles) -> tuple[float, str]:
    """K2's bound over `(boxes, valid, thr)` inputs: the boxes, validity and
    keep mask once each (bytes), against one IoU and compare (14 operations)
    for each pair of valid boxes of an image, the pairs this data needs."""
    n_bytes = n_ops = 0
    for boxes, valid, _ in tiles:
        n_bytes += boxes.numel() * 4 + 2 * valid.numel()
        nv = valid.sum(dim=1).double()
        n_ops += float((nv * (nv - 1) / 2).sum()) * 14
    return bound(n_bytes, n_ops)


def check_k2(gen, B, K, reps):
    """K2 on random boxes (the last image an overlapping chain) against its
    plain version: equal. `ms` the wrapper between two events, `kernel_ms`
    its launches alone under a CUDA graph."""
    from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep, greedy_nms_keep_torch

    iou = 0.45
    boxes, valid = nms_boxes(gen, B, K)
    got = greedy_nms_keep(boxes, valid, iou)
    ref = greedy_nms_keep_torch(boxes, valid, iou)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"K2 keep masks differ at K={K}: {int((got != ref).sum())} boxes")
    if not ref[-1, 0::2].all() or ref[-1, 1::2].any():
        raise AssertionError("K2 chain image: greedy must keep exactly the even boxes")
    ms = cuda_ms(lambda: greedy_nms_keep(boxes, valid, iou), reps)
    kernel_ms = graph_ms(lambda: greedy_nms_keep(boxes, valid, iou))
    plain_ms = cuda_ms(lambda: greedy_nms_keep_torch(boxes, valid, iou), 3, warmup=1)
    bound_ms, bound_by = k2_bound([(boxes, valid, iou)])
    return {
        "kernel": "greedy_nms_keep", "shape": [B, K], "kept": int(ref.sum()),
        "valid": int(valid.sum()), "max_abs_err": int((got.int() - ref.int()).abs().max()),
        "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
    }


def step_agent(cfg, loader, val_loader=None, seed: int = 0, device: str = "cuda"):
    """A `TrainAgent` for the phases that drive its steps directly, in a
    temporary run directory that is removed when the agent goes."""
    from yolopoint_tpu_torch.training import TrainAgent

    run_dir = tempfile.mkdtemp(prefix="yolopoint_run_")
    agent = TrainAgent(cfg, run_dir, loader, val_loader, seed=seed, device=device)
    weakref.finalize(agent, shutil.rmtree, run_dir, ignore_errors=True)
    return agent


def record_val_tiles(seed: int, device: str = "cuda") -> list:
    """The `(boxes, valid, iou_thres)` inputs of every K2 launch of one
    `TrainAgent.validate` batch (the val phase's config, weights and first
    batch): the tiles of the box-NMS scan, recorded by wrapping the name
    `greedy_nms_keep` in `yolopoint_tpu_torch.ops.nms` for that batch."""
    from yolopoint_tpu_torch.ops import nms as nms_module

    cfg = s640_train_config()
    B, (H, W) = cfg["training_params"]["val_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = SeededBatches(seed + 4, B, H, W, len(cfg["names"]), B, device, distinct=1)
    agent = step_agent(cfg, loader, loader.batches[:1], seed=seed, device=device)
    tiles, real = [], nms_module.greedy_nms_keep

    def recording(boxes, valid, iou_thres):
        tiles.append((boxes.clone(), valid.clone(), float(iou_thres)))
        return real(boxes, valid, iou_thres)

    nms_module.greedy_nms_keep = recording
    try:
        agent.validate()
    finally:
        nms_module.greedy_nms_keep = real
    torch.cuda.synchronize()
    return tiles


def check_k2_tiles(tiles, reps: int = 5):
    """K2 on the tiles of one val batch (`record_val_tiles`): each keep mask
    equal to the plain version's; times for all tiles, per tile."""
    from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep, greedy_nms_keep_torch

    def run(fn):
        return [fn(b, v, t) for b, v, t in tiles]

    for i, (got, ref) in enumerate(zip(run(greedy_nms_keep), run(greedy_nms_keep_torch))):
        if not torch.equal(got, ref):
            raise AssertionError(f"K2 val tile {i}: {int((got != ref).sum())} boxes differ")
    n = len(tiles)
    nv = torch.stack([v.sum(dim=1) for _, v, _ in tiles]).cpu()  # (tiles, B)
    bound_ms, bound_by = k2_bound(tiles)
    kernel_ms = graph_ms(lambda: run(greedy_nms_keep), count=2) / n
    return {
        "kernel": "greedy_nms_keep", "input": "val tiles", "shape": list(tiles[0][1].shape),
        "tiles": n, "tiles_with_valid": int((nv.sum(dim=1) > 0).sum()),
        "valid": int(nv.sum()), "valid_per_image_max": int(nv.max()),
        "iou_thres": tiles[0][2], "max_abs_err": 0,
        "ms": cuda_ms(lambda: run(greedy_nms_keep), reps) / n, "kernel_ms": kernel_ms,
        "kernel_ms_all_tiles": kernel_ms * n,
        "plain_ms": cuda_ms(lambda: run(greedy_nms_keep_torch), 1, warmup=0) / n,
        "bound_ms": bound_ms / n, "bound_by": bound_by, "bound_share": bound_ms / n / kernel_ms,
    }


def check_k3(gen, B, dtype, reps):
    """K3 against its plain version (within 1e-5); `kernel_ms` as K2's, and
    `library_ms` for `F.grid_sample` + `F.normalize` on the same inputs."""
    import torch.nn.functional as F

    from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda, sample_descriptors_torch

    Hc, Wc, D, N, cell = 80, 80, 128, 1000, 8
    dev = gen.device
    desc = torch.randn(B, Hc, Wc, D, generator=gen, device=dev)
    desc = (desc / desc.norm(dim=-1, keepdim=True)).to(dtype)
    pts = torch.rand(B, N, 2, generator=gen, device=dev) * (Wc * cell - 1)
    pts[:, :4] = torch.tensor([[0.0, 0.0], [639.0, 639.0], [636.5, 3.0], [2.0, 637.9]],
                              device=dev)  # corners and edges: taps outside the map
    got = sample_descriptors_cuda(desc, pts, cell)
    ref = sample_descriptors_torch(desc, pts, cell)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"K3 {dtype}: max abs error {err} > 1e-5")
    ms = cuda_ms(lambda: sample_descriptors_cuda(desc, pts, cell), reps)
    kernel_ms = graph_ms(lambda: sample_descriptors_cuda(desc, pts, cell))
    plain_ms = cuda_ms(lambda: sample_descriptors_torch(desc, pts, cell), max(reps // 4, 3))

    # the library yardstick: `F.grid_sample` (align corners, zeros outside)
    # on the NCHW view of the map, in f32, then `F.normalize`
    grid = torch.stack([pts[..., 0] / (Wc * cell / 2.0) - 1.0,
                        pts[..., 1] / (Hc * cell / 2.0) - 1.0], dim=-1)[:, None]

    def lib():
        x = F.grid_sample(desc.float().permute(0, 3, 1, 2), grid, mode="bilinear",
                          padding_mode="zeros", align_corners=True)
        return F.normalize(x[:, :, 0].permute(0, 2, 1), dim=-1)

    library_err = float((lib() - ref).abs().max())
    if not library_err <= 1e-5:
        raise AssertionError(f"K3 {dtype}: F.grid_sample + F.normalize off by {library_err} > 1e-5")
    library_ms = cuda_ms(lib, reps)
    # bytes: the distinct map pixels the points tap, the points, the output
    cx = ((pts[..., 0] / (Wc * cell / 2.0) - 1.0 + 1.0) * 0.5 * (Wc - 1)).floor().long()
    cy = ((pts[..., 1] / (Hc * cell / 2.0) - 1.0 + 1.0) * 0.5 * (Hc - 1)).floor().long()
    taps = set()
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = cx + dx, cy + dy
            ok = (x >= 0) & (x < Wc) & (y >= 0) & (y < Hc)
            lin = torch.arange(B, device=dev)[:, None] * Hc * Wc + y * Wc + x
            taps.update(lin[ok].tolist())
    n_bytes = len(taps) * D * desc.element_size() + pts.numel() * 4 + got.numel() * 4
    n_ops = B * N * D * 14  # 4-tap blend, square-sum, scale
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "kernel": "sample_descriptors", "shape": [B, Hc, Wc, D, N],
        "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
        "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_max_abs": library_err, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_share": bound_ms / kernel_ms,
    }


WARP_HOMOGRAPHIC = {  # configs/synthetic_s640.yaml, data.augmentation.homographic.params
    "perspective": True, "scaling": True, "rotation": True, "translation": True,
    "patch_ratio": 0.85, "perspective_amplitude_x": 0.2, "perspective_amplitude_y": 0.2,
    "scaling_amplitude": 0.2, "max_angle": 1.57,
}


def warp_pixels_read(hom, B, H, W, mode) -> int:
    """The distinct in-frame source pixels that the warp's taps read (four
    bilinear taps or one nearest tap per output pixel), from the plain
    version's source coordinates."""
    from yolopoint_tpu_torch.ops import geometry

    sx, sy = geometry._source_pixels(hom, H, W, B)
    if mode == "nearest":
        x0, y0, offsets = torch.floor(sx + 0.5), torch.floor(sy + 0.5), ((0, 0),)
    else:
        x0, y0, offsets = torch.floor(sx), torch.floor(sy), ((0, 0), (1, 0), (0, 1), (1, 1))
    read = torch.zeros(B * H * W, dtype=torch.bool, device=hom.device)
    base = torch.arange(B, device=hom.device)[:, None, None] * (H * W)
    for dx, dy in offsets:
        x, y = x0 + dx, y0 + dy
        ok = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)  # False for NaN
        lin = base + torch.where(ok, y * W + x, 0.0).long()
        read[lin[ok]] = True
    return int(read.sum())


EXPORT_HOMOGRAPHIC = {  # configs/synthetic_s640_export.yaml, export.homography
    "perspective": True, "scaling": True, "rotation": True, "translation": True,
    "patch_ratio": 0.85,
}


def warp_homographies(gen, kind: str, B: int) -> torch.Tensor:
    """Output -> source homographies for a warp check input:
      s640            sampled as the s640 augmentation samples them;
      single          one such (3, 3) homography, which the wrapper expands;
      export_forward  the export's views: the identity, then B - 1 draws
                      with its parameters;
      export_inverse  their inverses: the warps that bring the export's N
                      heatmaps and masks back, which zoom out;
      zoom_out        those inverses after a 3x zoom-out of the output, so
                      that inner tiles' windows exceed the shared budget;
      sign_change     w2 = 0.6 x + 0.3 y + 0.2 (then an s640 homography)
                      crosses zero inside the frame, and taps near the line
                      fly across it."""
    from yolopoint_tpu_torch.ops.homography import sample_homography_batch

    dev = gen.device
    if kind == "s640":
        return sample_homography_batch(gen, B, **WARP_HOMOGRAPHIC)
    if kind == "single":
        return sample_homography_batch(gen, 1, **WARP_HOMOGRAPHIC)[0]
    if kind in ("export_forward", "export_inverse", "zoom_out"):
        views = sample_homography_batch(gen, B - 1, **EXPORT_HOMOGRAPHIC)
        views = torch.cat([torch.eye(3, device=dev)[None], views])
        if kind == "export_forward":
            return views.contiguous()
        inv = torch.linalg.inv(views)
        if kind == "zoom_out":
            inv = inv @ torch.diag(torch.tensor([3.0, 3.0, 1.0], device=dev))
        return inv.contiguous()
    if kind == "sign_change":
        tilt = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.3, 0.2]], device=dev)
        return (sample_homography_batch(gen, B, **WARP_HOMOGRAPHIC) @ tilt).contiguous()
    raise ValueError(kind)


def graph_ms(fn, count: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of `fn` on the device alone: `count` calls
    captured in one CUDA graph, replayed `reps` times, median per call."""
    fn()  # first-call allocations and caches outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    del graph
    return statistics.median(times)


def check_warp(gen, B, H, W, C, mode, reps, homs="s640"):
    """The warp kernel against its plain version on (B, H, W, C) f32 images
    in [0, 1) and the homographies `homs` of `warp_homographies`.

    Gates: nearest bit-equal, bilinear within 1e-5, NaN (a pixel whose
    coordinates are not finite, bilinear) at the same pixels; the tiles the
    kernel's counter saw take the global branch equal to those whose window,
    from the plain version's coordinates (`window_bytes`), exceeds the
    shared budget. `ms` times `warp_image_cuda` (argument checks, the
    homographies made contiguous, the launch); `kernel_ms` the launches
    alone (`graph_ms`); `plain_ms` the plain version; `library_ms`
    `F.grid_sample` (NCHW input, zeros, align_corners=True, the same mode)
    with the normalized source grid precomputed, and `library_kernel_ms`
    the same under a graph. Its nearest mode rounds ties to even where the
    warp rounds half up, so there it computes nearly, not exactly, the same
    function: `library_differing_pixels` counts where it differs."""
    import torch.nn.functional as F

    from yolopoint_tpu_torch.ops import cuda_warp, geometry

    img = torch.rand(B, H, W, C, generator=gen, device=gen.device)
    hom = warp_homographies(gen, homs, B)
    what = f"warp {mode} {(B, H, W, C)} {homs}"
    before = cuda_warp.global_tile_count(img.device)
    got = cuda_warp.warp_image_cuda(img, hom, mode)
    global_tiles = cuda_warp.global_tile_count(img.device) - before
    ref = geometry.warp_image_plain(img, hom, mode)
    torch.cuda.synchronize()
    nan = ref.isnan()
    if not torch.equal(got.isnan(), nan):
        raise AssertionError(f"{what}: NaN at other pixels than the plain version")
    err = float(torch.where(nan, 0.0, (got - ref).abs()).max())
    n_diff = int(((got != ref) & ~nan).any(-1).sum())
    if mode == "nearest" and n_diff:
        raise AssertionError(f"{what}: {n_diff} pixels differ from the plain version")
    if not err <= 1e-5:
        raise AssertionError(f"{what}: max abs error {err} > 1e-5")
    tx, ty = cuda_warp.tile_grid(H, W)
    tiles = B * tx * ty
    window = cuda_warp.window_bytes(hom, img.shape, mode)
    expected = int((window > cuda_warp.WINDOW_BYTES).sum())
    if global_tiles != expected:
        raise AssertionError(f"{what}: {global_tiles} tiles took the global branch, "
                             f"the windows say {expected}")
    hom_c = hom.reshape(-1, 3, 3).expand(B, 3, 3).contiguous()
    ms = cuda_ms(lambda: cuda_warp.warp_image_cuda(img, hom, mode), reps)
    kernel_ms = graph_ms(lambda: cuda_warp._launch(img, hom_c, mode))
    plain_ms = cuda_ms(lambda: geometry.warp_image_plain(img, hom, mode), 3, warmup=1)
    src = geometry.warp_points(geometry._normalized_grid(H, W, img.device).reshape(-1, 2), hom)
    grid = src.reshape(B, H, W, 2)
    x = img.permute(0, 3, 1, 2).contiguous()

    def lib():
        return F.grid_sample(x, grid, mode=mode, padding_mode="zeros", align_corners=True)

    lib_diff = torch.where(nan, 0.0, (lib().permute(0, 2, 3, 1) - ref).abs())
    library_err = float(lib_diff.max())
    library_err = library_err if math.isfinite(library_err) else None
    library_differing = int((lib_diff > 1e-5).any(-1).sum())
    del lib_diff
    library_ms = cuda_ms(lib, reps)
    library_kernel_ms = graph_ms(lib)
    # bytes: the distinct source pixels the taps read, the output, the
    # homographies and the grid axes
    n_read = warp_pixels_read(hom, B, H, W, mode)
    n_bytes = n_read * C * 4 + got.numel() * 4 + hom_c.numel() * 4 + (H + W) * 4
    n_ops = B * H * W * (20 + (12 + 9 * C if mode == "bilinear" else 4))
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "kernel": "K5" if cuda_warp.warp_fits_pallas(img.shape) else "K4", "shape": [B, H, W, C],
        "mode": mode, "homographies": homs, "max_abs_err": err, "differing_pixels": n_diff,
        "nan_pixels": int(nan.any(-1).sum()), "ms": ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, "library_kernel_ms": library_kernel_ms,
        "library_max_abs": library_err, "library_differing_pixels": library_differing,
        "source_read_share": n_read / (B * H * W),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
        "tiles": tiles, "global_tiles": global_tiles, "global_tile_share": global_tiles / tiles,
        "window_kb_max": int(window.max()) / 1024,
    }


# B, H, W, C, mode, homographies, the path whose warp this is (None: no
# path): the K4 and K5 shapes of the train path, the export's three warps
# (the views at C = 3, the heatmaps and masks back at C = 1), two more of
# each mode, and inputs that force each branch and edge (global branch, w2
# sign change, ragged tiles, W * C not a multiple of 4, C = 2 and 4, one
# (3, 3) homography)
WARP_INPUTS = (
    (32, 640, 640, 3, "bilinear", "s640", "train"),
    (32, 80, 80, 1, "nearest", "s640", "train"),
    (50, 640, 640, 3, "bilinear", "export_forward", "export"),
    (50, 640, 640, 1, "bilinear", "export_inverse", "export"),
    (50, 640, 640, 1, "bilinear", "export_forward", None),
    (8, 240, 320, 3, "bilinear", "s640", None),
    (32, 640, 640, 1, "nearest", "s640", None),
    (8, 640, 640, 3, "bilinear", "zoom_out", None),
    (4, 640, 640, 3, "bilinear", "sign_change", None),
    (4, 640, 640, 3, "nearest", "sign_change", None),
    (3, 101, 94, 4, "bilinear", "s640", None),
    (3, 101, 94, 4, "nearest", "s640", None),
    (1, 37, 53, 2, "bilinear", "single", None),
    (1, 37, 53, 2, "nearest", "single", None),
)


def check_warps(gen, reps: int = 20) -> list[dict]:
    """Every warp input of `WARP_INPUTS`, one line each (with the launches
    the check made and its `path`); fails if the train path's K4 input
    sends more than 5% of its tiles to the global branch, or the zoom-out
    input none (the export's shares are reported, not gated)."""
    from yolopoint_tpu_torch.ops import _build

    lines = []
    for B, H, W, C, mode, homs, path in WARP_INPUTS:
        before = sum(_build.launch_counts.values())
        line = check_warp(gen, B, H, W, C, mode, reps, homs)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        line["path"] = path
        lines.append(line)
        if path == "train" and line["kernel"] == "K4" and line["global_tile_share"] > 0.05:
            raise AssertionError(f"warp {(B, H, W, C)} {homs}: {line['global_tile_share']:.3f} "
                                 "of the tiles took the global branch (> 0.05)")
        if homs == "zoom_out" and line["global_tiles"] == 0:
            raise AssertionError("warp zoom-out input: no tile took the global branch")
    return lines


# ---------------------------------------------------------------- model


@torch.no_grad()
def random_weights(model: torch.nn.Module, seed: int) -> dict:
    """Seeded random weights: conv kernels uniform in +-1/sqrt(fan_in),
    BatchNorm affine and running statistics away from the identity."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            b = mod.weight[0].numel() ** -0.5
            uniform(mod.weight, -b, b)
        elif isinstance(mod, torch.nn.BatchNorm2d):
            uniform(mod.weight, 0.5, 1.5)
            uniform(mod.bias, -0.3, 0.3)
            uniform(mod.running_mean, -0.5, 0.5)
            uniform(mod.running_var, 0.5, 2.0)
    return model.state_dict()


def folded_yolopoint_s(seed: int, dtype, device, nc: int = 80):
    from yolopoint_tpu_torch.models import build_model, fold_batch_norm

    state = random_weights(build_model("YOLOPoint", "s", nc=nc, device="cpu"), seed)
    model = build_model("YOLOPoint", "s", nc=nc, fused=True, device="cpu")
    model.load_state_dict(fold_batch_norm(state))
    return model.to(device=device, dtype=dtype).eval()


def same_points(a_pts, a_valid, b_pts, b_valid) -> bool:
    a = sorted(map(tuple, a_pts[a_valid].tolist()))
    b = sorted(map(tuple, b_pts[b_valid].tolist()))
    return a == b


def same_detections(det_g: dict, det_c: dict, what: str, atol: float) -> dict:
    """Card and CPU detections of the same inputs, slot by slot: the same
    valid slots (more than 0), classes equal, coordinates within `atol`."""
    det_g = {k: v.cpu() for k, v in det_g.items()}
    ok = det_c["valid"]
    if not torch.equal(det_g["valid"], ok) or not bool(ok.any()):
        raise AssertionError(f"{what}: detections card {det_g['valid'].sum(1).tolist()} "
                             f"vs CPU {ok.sum(1).tolist()}")
    err = float((det_g["boxes"][ok] - det_c["boxes"][ok]).abs().max())
    if not torch.equal(det_g["classes"][ok], det_c["classes"][ok]) or not err <= atol:
        raise AssertionError(f"{what}: classes differ or coordinates by {err} > {atol}")
    return {"boxes_compared": int(ok.sum()), "per_image": ok.sum(1).tolist(),
            "box_max_abs": err}


@torch.inference_mode()
def check_reference(seed: int, device: str = "cuda"):
    """f32 YOLOPoint-S on one 256x256 frame: the forward on the card against
    the CPU (TF32 off), then each decode stage on the card (kernels) against
    the CPU (plain versions) on the same inputs, copied from the card: boxes
    at the serving gate 0.25 (nc=80) and at 0.001 (the s640 model, nc=5,
    where boxes pass with random weights; box NMS of the card's decoded
    predictions), and keypoints at radii 3 and 7 (no tile divides 256: K6)."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops import (_build, batched_box_nms, cells_to_heatmap,
                                         extract_keypoints, fused_detect_nms, sample_descriptors)

    cfg = dict(SERVE_CONFIG, heatmap_dtype="f32")
    gpu = InferencePipeline(folded_yolopoint_s(seed, torch.float32, device), cfg, device=device)
    cpu = InferencePipeline(folded_yolopoint_s(seed, torch.float32, "cpu"), cfg, device="cpu")
    img = torch.randint(0, 256, (1, 256, 256, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(seed + 1))
    out_g = gpu.forward(img.to(device))
    out_c = cpu.forward(img)
    fwd_err = {
        "semi": float((out_g["semi"].cpu() - out_c["semi"]).abs().max()),
        "desc": float((out_g["desc"].cpu() - out_c["desc"]).abs().max()),
        "objects": max(float((g.cpu() - c).abs().max())
                       for g, c in zip(out_g["objects"], out_c["objects"])),
    }
    if not max(fwd_err.values()) <= 1e-3:
        raise AssertionError(f"f32 forward, card vs CPU: {fwd_err} above 1e-3")

    heat = cells_to_heatmap(out_g["semi"].permute(0, 2, 3, 1))
    args = (cfg["detection_threshold"], cfg["nms"], cfg["top_k"])
    pts_g, sc_g, ok_g = extract_keypoints(heat, *args)
    pts_c, sc_c, ok_c = extract_keypoints(heat.cpu(), *args)
    if not same_points(pts_g[0].cpu(), ok_g[0].cpu(), pts_c[0], ok_c[0]) or not torch.equal(
            sc_g.cpu().sort(dim=1).values, sc_c.sort(dim=1).values):
        raise AssertionError("keypoints differ between the card and the CPU")
    n_kp = int(ok_c.sum())
    if n_kp == 0:
        raise AssertionError("no keypoints on the reference frame")

    desc = out_g["desc"].permute(0, 2, 3, 1).contiguous()
    desc_err = float((sample_descriptors(desc, pts_g).cpu()
                      - sample_descriptors(desc.cpu(), pts_g.cpu())).abs().max())
    if not desc_err <= 1e-5:
        raise AssertionError(f"descriptors differ by {desc_err} > 1e-5")

    nms_args = (gpu._anchors_ps, gpu._strides, cfg["conf_thresh"], cfg["iou_thresh"],
                cfg["max_det"], cfg["max_nms"])
    det_g = fused_detect_nms(out_g["objects"], *nms_args)
    det_c = fused_detect_nms([o.cpu() for o in out_g["objects"]], *nms_args)
    nb_g, nb_c = int(det_g["valid"].sum()), int(det_c["valid"].sum())
    bg = det_g["boxes"][det_g["valid"]].cpu()
    bc = det_c["boxes"][det_c["valid"]]
    box_err = float((bg.sort(0).values - bc.sort(0).values).abs().max()) if nb_c else 0.0
    if nb_g != nb_c or not box_err <= 1e-3:
        raise AssertionError(f"boxes {nb_g} vs {nb_c}, max coordinate error {box_err}")

    # box gate 0.001 on the s640 model (nc=5): with nc=80 random weights no
    # score on this frame reaches 0.001, while nc=5's class prior puts part
    # of the anchors above it. Both sides get the card's decoded predictions:
    # neighbouring anchors of random weights predict nearly the same box with
    # scores ~1e-10 apart, so the ulp by which the card's sigmoid differs from
    # the CPU's would reorder them and change which survive.
    s640 = InferencePipeline(folded_yolopoint_s(seed, torch.float32, device, nc=5), cfg,
                             device=device)
    pred = decode_levels(s640.forward(img.to(device))["objects"], s640._anchors_ps,
                         s640._strides)
    low_kw = dict(conf_thres=0.001, iou_thres=cfg["iou_thresh"], max_det=cfg["max_det"],
                  max_nms=cfg["max_nms"])
    low = same_detections(batched_box_nms(pred, **low_kw), batched_box_nms(pred.cpu(), **low_kw),
                          "reference nc=5 conf 0.001", 1e-4)

    # the untiled keypoint path (K6): 256 is no multiple of 3 or 7
    untiled = {}
    for r in (3, 7):
        before = _build.launch_counts["K6"]
        got = extract_keypoints(heat, cfg["detection_threshold"], r, cfg["top_k"])
        if _build.launch_counts["K6"] - before != 1:
            raise AssertionError(f"untiled keypoints r={r}: K6 was not launched")
        want = extract_keypoints(heat.cpu(), cfg["detection_threshold"], r, cfg["top_k"])
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"untiled keypoints r={r} differ between the card and the CPU")
        untiled[str(r)] = int(want[2].sum())
        if untiled[str(r)] == 0:
            raise AssertionError(f"untiled keypoints r={r}: none found")
    return {"phase": "reference", "frame": [256, 256], "forward_max_abs": fwd_err,
            "keypoints": n_kp, "descriptor_max_abs": desc_err, "boxes": nb_c,
            "box_candidates": int(det_c["n_candidates"][0]), "box_max_abs": box_err,
            "conf_0.001": low, "untiled_keypoints": untiled}


@torch.inference_mode()
def serve(seed: int, batches=(1, 16), requests=(20, 8), device: str = "cuda"):
    """The benchmark operating point on uint8 640x640 batches."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), SERVE_CONFIG,
                             compute_dtype=torch.bfloat16, device=device)
    gen = torch.Generator().manual_seed(seed + 2)
    frames = {B: torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8, generator=gen)
              for B in batches}
    for B in batches:  # warm-up: cuDNN plans, allocator, kernels
        for _ in range(2):
            pipe(frames[B])
    torch.cuda.synchronize()

    _build.launch_counts.clear()
    lat, outs = {}, {}
    for B, n in zip(batches, requests):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = pipe(frames[B])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        lat[B], outs[B] = times, out
    launches = dict(_build.launch_counts)

    for B, out in outs.items():
        expect = {"keypoints": (B, 1000, 2), "kp_scores": (B, 1000), "boxes": (B, 300, 4),
                  "box_scores": (B, 300), "descriptors": (B, 1000, 128)}
        for k, shape in expect.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f"serve B={B}: {k} has shape {tuple(out[k].shape)}")
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"serve B={B}: {k} is not finite")
        d = out["descriptors"][out["kp_valid"]]
        if d.numel() and not ((d.norm(dim=-1) - 1.0).abs() <= 1e-4).all():
            raise AssertionError(f"serve B={B}: descriptors are not unit vectors")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"serve: kernel {name} was not launched on the main path")

    # where one request's time goes, forward vs decode, by CUDA events
    split = {}
    for B in batches:
        x = frames[B].to(device)
        raw = pipe.forward(x)
        split[B] = {"forward_ms": cuda_ms(lambda: pipe.forward(x), 5),
                    "decode_ms": cuda_ms(lambda: pipe.decode(raw), 5)}
    result = {
        "phase": "serve", "model": "YOLOPoint-s", "nc": 80, "input": [640, 640],
        "dtype": "bf16", "config": SERVE_CONFIG, "launches": launches,
        "latency_ms_p50": {str(B): statistics.median(t) for B, t in lat.items()},
        "latency_ms_all": {str(B): t for B, t in lat.items()},
        "images_per_s": {str(B): B * 1e3 / statistics.median(t) for B, t in lat.items()},
        "split_ms": {str(B): s for B, s in split.items()},
        "keypoints_per_image": float(outs[batches[-1]]["kp_valid"].sum(1).float().mean()),
        "boxes_per_image": float(outs[batches[-1]]["box_valid"].sum(1).float().mean()),
        "box_candidates_per_image": float(
            outs[batches[-1]]["box_n_candidates"].float().mean()),
    }
    return result, launches


# ---------------------------------------------------------------- training

def s640_train_config() -> dict:
    """`configs/synthetic_s640.yaml`, read by the port's config reader: the
    training config of the step, val and fit phases."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "synthetic_s640.yaml")


LOSS_TERMS = ("loss", "loss_det", "loss_desc", "loss_obj", "obj_box", "obj_obj", "obj_cls")


class SeededBatches:
    """Batches shaped as `device_data.build_host_arrays` shapes them, made on
    `device` from a seed: uint8 images, <= `max_points` keypoints and
    <= `max_boxes` boxes per image, with validity masks. `len()` is the
    configured train length over the batch size (micro-steps per epoch)."""

    def __init__(self, seed, B, H, W, nc, length, device, distinct=4, max_points=256,
                 max_boxes=64):
        gen = torch.Generator(device=device).manual_seed(seed)
        self.n = max(length // B, 1)

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=device)

        def counts(high):
            return torch.randint(high // 2, high + 1, (B, 1), generator=gen, device=device)

        self.batches = []
        for _ in range(distinct):
            k = torch.arange(max_points, device=device)[None]
            m = torch.arange(max_boxes, device=device)[None]
            boxes = torch.cat([torch.randint(0, nc, (B, max_boxes, 1), generator=gen,
                                             device=device).float(),
                               rand(B, max_boxes, 2) * 0.6 + 0.2,
                               rand(B, max_boxes, 2) * 0.25 + 0.05], dim=-1)
            self.batches.append({
                "image": torch.randint(0, 256, (B, H, W, 3), generator=gen, device=device,
                                       dtype=torch.uint8),
                "points": rand(B, max_points, 2) * torch.tensor([W - 1.0, H - 1.0], device=device),
                "point_mask": k < counts(max_points),
                "boxes": boxes,
                "box_mask": m < counts(max_boxes),
            })

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self.batches[i % len(self.batches)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def train_reference(seed: int, device: str = "cuda"):
    """One micro-step of the port's train step in f32 (TF32 off) on the card
    and on the CPU: YOLOPoint-n, 128x128, B=2, the s640 augmentation and
    losses, the same initial weights, batch and pre-drawn random samples
    (drawn once on the CPU). With `accum` 2 the micro-step leaves the
    parameters and fills the optimizer's accumulator with the gradient.
    Gradient norms are held to 1e-3: on the card the backward of the
    descriptor and object losses' gathers are scatter-adds, summed in a
    nondeterministic order."""
    import copy

    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import (LossWeights, create_train_state, draw_step,
                                              make_optimizer, make_train_step,
                                              rescale_yolo_gains)
    from yolopoint_tpu_torch.losses import ObjectLossConfig

    cfg = s640_train_config()
    aug = cfg["data"]["augmentation"]
    sp = cfg["model"]["superpoint"]["sparse_loss"]["params"]
    weights = LossWeights(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce",
                          det_loss_type="ce", num_samples_per_image=sp["num_samples_per_image"],
                          num_masked_non_matches_per_match=sp["num_masked_non_matches_per_match"])
    nc, B, H = len(cfg["names"]), 2, 128
    obj = rescale_yolo_gains(ObjectLossConfig(**{k: cfg["model"]["yolo"][k]
                                                 for k in ("box", "obj", "cls", "anchor_t")}),
                             nc, H)
    torch.manual_seed(seed)
    model_cpu = build_model("YOLOPoint", "n", nc=nc, device="cpu").train()
    batch_cpu = SeededBatches(seed + 1, B, H, H, nc, B, "cpu", distinct=1).batches[0]
    draws_cpu = draw_step(torch.Generator().manual_seed(seed + 2), (B, H, H, 3), aug, weights)

    results = {}
    for dev in ("cpu", device):
        model = copy.deepcopy(model_cpu).to(dev)
        opt = make_optimizer(model, learning_rate=1e-3, lrf=0.1, total_epochs=125,
                             steps_per_epoch=32, grad_clip=10.0, accumulate_steps=2)
        state = create_train_state(model, opt, ema=True)
        step = make_train_step(model, aug, obj, weights, nc, accum=2)
        _build.launch_counts.clear()
        aux = step(state, _to(batch_cpu, dev), _to(draws_cpu, dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        results[dev] = {
            "losses": {k: float(aux[k]) for k in LOSS_TERMS},
            "grad_norms": {n: float(a.norm()) for n, a in zip(opt.names, opt.acc)},
            "launches": dict(_build.launch_counts),
        }
    cpu, gpu = results["cpu"], results[device]
    loss_rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    grad_rel = {n: abs(gpu["grad_norms"][n] - v) / max(v, 1e-12)
                for n, v in cpu["grad_norms"].items() if v > 0}
    worst_grad = max(grad_rel, key=grad_rel.get)
    if not max(loss_rel.values()) <= 1e-4:
        raise AssertionError(f"train_reference: losses card vs CPU {loss_rel} above 1e-4")
    if not grad_rel[worst_grad] <= 1e-3:
        raise AssertionError(f"train_reference: gradient norm of {worst_grad} differs by "
                             f"{grad_rel[worst_grad]} > 1e-3")
    if gpu["launches"].get("K5", 0) != 3 or cpu["launches"]:
        raise AssertionError(f"train_reference: warp launches card {gpu['launches']}, "
                             f"CPU {cpu['launches']} (want 3 K5 on the card, none on the CPU)")
    return {"phase": "train_reference", "model": "YOLOPoint-n", "input": [B, H, H],
            "dtype": "f32", "losses_card": gpu["losses"], "losses_cpu": cpu["losses"],
            "loss_max_rel": max(loss_rel.values()), "grad_norm_max_rel": grad_rel[worst_grad],
            "grad_norm_worst_tensor": worst_grad, "tensors": len(grad_rel),
            "launches_card": gpu["launches"]}


def train(seed: int, warmup: int = 2, steps: int = 6, device: str = "cuda"):
    """`TrainAgent` on the s640 training config: `warmup` untimed and `steps`
    timed micro-steps. A micro-step's time is the host clock around
    `TrainAgent.step` ending in a synchronize; its CUDA-event split is
    `augment` (the random draws and both views), `forward_backward` (two
    forwards, the losses, the backward) and `optimizer` (the finiteness
    check, accumulation or the update, the EMA). Returns the phase line and
    the warp launches of the timed steps."""
    from yolopoint_tpu_torch.ops import _build

    cfg = s640_train_config()
    tp = cfg["training_params"]
    B, (H, W) = tp["train_batch_size"], cfg["data"]["preprocessing"]["resize"]
    loader = SeededBatches(seed + 3, B, H, W, len(cfg["names"]), cfg["data"]["length"]["train"],
                           device)
    agent = step_agent(cfg, loader, seed=seed, device=device)
    if agent.accum != 2 or agent.compute_dtype != torch.bfloat16:
        raise AssertionError(f"train: accum {agent.accum}, dtype {agent.compute_dtype}")
    params = [p for _, p in agent.model.named_parameters()]
    ema0 = {n: t.clone() for n, t in agent.state.ema_params.items()}
    history = agent.train_steps(warmup)
    torch.cuda.synchronize()
    updates_before = agent.optimizer.count

    def flat():
        return torch.cat([p.detach().reshape(-1) for p in params])

    events, phases = [], ("augment", "forward_backward", "optimizer")

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[-1].append((name, ev))

    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    step_ms, moved = [], []
    batches = iter(loader)
    for _ in range(steps):
        before = flat()
        start = torch.cuda.Event(enable_timing=True)
        events.append([])
        t0 = time.perf_counter()
        start.record()
        aux = agent.step(next(batches), on_phase)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in aux.items()})
        moved.append(bool((flat() != before).any()))
        events[-1].insert(0, ("start", start))
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    split = {name: [] for name in phases}
    for evs in events:
        for (_, a), (name, b) in zip(evs, evs[1:]):
            split[name].append(a.elapsed_time(b))
    timed = history[warmup:]
    for h in history:
        bad = [k for k in LOSS_TERMS if not math.isfinite(h[k])]
        if bad or h["nonfinite_skip"] != 0.0:
            raise AssertionError(f"train: non-finite {bad} or skipped step: {h}")
    # micro-steps warmup+1 .. warmup+steps; an update lands on every accum-th
    expect_moved = [(warmup + i + 1) % agent.accum == 0 for i in range(steps)]
    if moved != expect_moved:
        raise AssertionError(f"train: parameters moved on {moved}, expected {expect_moved}")
    ema_moved = max(float((agent.state.ema_params[n] - ema0[n]).abs().max()) for n in ema0)
    if not ema_moved > 0:
        raise AssertionError("train: the EMA did not move")
    if agent.optimizer.count - updates_before != steps // agent.accum:
        raise AssertionError(f"train: {agent.optimizer.count - updates_before} updates in "
                             f"{steps} micro-steps at accum {agent.accum}")
    if launches.get("K4", 0) != 2 * steps or launches.get("K5", 0) != steps:
        raise AssertionError(f"train: warp launches {launches}, want {2 * steps} K4 and {steps} K5")
    med = statistics.median(step_ms)
    return {
        "phase": "train", "model": "YOLOPoint-s", "nc": len(cfg["names"]), "input": [H, W],
        "batch": B, "dtype": "bf16", "accum": agent.accum, "warmup_steps": warmup,
        "timed_steps": steps, "optimizer_updates_timed": agent.optimizer.count - updates_before,
        "ms_per_step_p50": med, "ms_per_step_all": step_ms, "images_per_s": B * 1e3 / med,
        "split_ms_p50": {k: statistics.median(v) for k, v in split.items()},
        "peak_memory_gb": peak / 1e9, "launches": launches,
        "ema_max_move": ema_moved, "params_moved": moved,
        "losses": {k: [h[k] for h in timed] for k in LOSS_TERMS},
    }, launches


@torch.inference_mode()
def serve_untiled(seed: int, B: int = 16, requests: int = 8, device: str = "cuda"):
    """`InferencePipeline` at NMS radius 3, where 640 is no multiple of the
    tile: the keypoints go through K6's map and the exact tile reduction.
    Returns the phase line and the launches of the timed requests."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    cfg = dict(SERVE_CONFIG, nms=3)
    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), cfg,
                             compute_dtype=torch.bfloat16, device=device)
    frames = torch.randint(0, 256, (B, 640, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed + 5))
    for _ in range(2):
        pipe(frames)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pipe(frames)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    if launches.get("K6", 0) != requests or launches.get("nms_tile_keys", 0):
        raise AssertionError(f"serve at radius 3: launches {launches}, want {requests} K6, no K1")
    n_kp = out["kp_valid"].sum(1).float()
    if not torch.isfinite(out["kp_scores"]).all() or not (n_kp > 0).all():
        raise AssertionError("serve at radius 3: no keypoints or non-finite scores")
    return {"phase": "serve_untiled", "model": "YOLOPoint-s", "input": [640, 640], "batch": B,
            "nms": 3, "dtype": "bf16", "latency_ms_p50": statistics.median(times),
            "latency_ms_all": times, "keypoints_per_image": float(n_kp.mean()),
            "launches": launches}, launches


VAL_WEIGHTS = dict(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce", det_loss_type="ce",
                   num_samples_per_image=600, num_masked_non_matches_per_match=100)


def val_reference(seed: int, device: str = "cuda"):
    """The val step in f32 (TF32 off) on the card and on the CPU: YOLOPoint-n
    with seeded weights, nc=5 (multi-label box NMS over 5040 candidate slots:
    the tiled scan), 128x128, B=2, the s640 val augmentation, the same batch
    and random draws. Losses within 1e-4 relative; the decode of the same
    inputs (the card's base heatmap, descriptor map and decoded predictions,
    copied to the CPU) equal: keypoints bit-equal, descriptors within 1e-5,
    detections (multi-label, 30000 candidates: the tiled scan) matched within
    1e-4. The whole step's keypoint and detection counts are reported."""
    import copy

    from yolopoint_tpu_torch.losses import ObjectLossConfig
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.models.detect import decode_levels
    from yolopoint_tpu_torch.ops import (_build, batched_box_nms, extract_keypoints,
                                         sample_descriptors)
    from yolopoint_tpu_torch.training import (LossWeights, draw_step, make_val_step,
                                              rescale_yolo_gains)

    cfg = s640_train_config()
    nc, B, H = len(cfg["names"]), 2, 128
    sp, yolo = cfg["model"]["superpoint"], cfg["model"]["yolo"]
    weights = LossWeights(**VAL_WEIGHTS)
    obj = rescale_yolo_gains(ObjectLossConfig(**{k: yolo[k] for k in ("box", "obj", "cls",
                                                                       "anchor_t")}), nc, H)
    model_cpu = build_model("YOLOPoint", "n", nc=nc, device="cpu")
    random_weights(model_cpu, seed)
    batch_cpu = SeededBatches(seed + 1, B, H, H, nc, B, "cpu", distinct=1).batches[0]
    draws_cpu = draw_step(torch.Generator().manual_seed(seed + 2), (B, H, H, 3),
                          cfg["data"]["val_augmentation"], weights)
    kpt = (sp["detection_threshold"], sp["nms"], sp["top_k"])
    box = dict(conf_thres=yolo["conf_thresh"], iou_thres=yolo["iou_thresh"], max_det=300,
               max_nms=30000, multi_label=True)
    res, models = {}, {}
    for dev in ("cpu", device):
        models[dev] = copy.deepcopy(model_cpu).to(dev)
        step = make_val_step(models[dev], cfg["data"]["val_augmentation"], obj, weights, nc,
                             kpt_conf=kpt[0], kpt_nms=kpt[1], kpt_topk=kpt[2])
        _build.launch_counts.clear()
        res[dev] = step(None, _to(batch_cpu, dev), _to(draws_cpu, dev))
        if dev != "cpu":
            torch.cuda.synchronize()
        res[dev]["launches"] = dict(_build.launch_counts)
    cpu, gpu = res["cpu"], _to(res[device], "cpu")
    loss_rel = {k: abs(float(gpu["losses"][k]) - float(v)) / max(abs(float(v)), 1e-12)
                for k, v in cpu["losses"].items()}
    if not max(loss_rel.values()) <= 1e-4:
        raise AssertionError(f"val_reference: losses card vs CPU {loss_rel} above 1e-4")
    # the whole step's decode, for information: its inputs differ by the
    # forward's f32 rounding, which reorders near-tied boxes (see check_reference)
    end_to_end = {v: {"detections_card": gpu[v]["det"]["valid"].sum(1).tolist(),
                      "detections_cpu": cpu[v]["det"]["valid"].sum(1).tolist(),
                      "keypoints_card": gpu[v]["valid"].sum(1).tolist(),
                      "keypoints_cpu": cpu[v]["valid"].sum(1).tolist()}
                  for v in ("base", "warped")}

    # the decode of the same inputs: the card's base heatmap and predictions
    heat = res[device]["base"]["heatmap"]
    with torch.no_grad():
        x = models[device](res[device]["image"].permute(0, 3, 1, 2).contiguous())
        pred = decode_levels(x["objects"], models[device].Detect.anchors_per_stride(),
                             models[device].Detect.strides)
        desc = x["desc"].permute(0, 2, 3, 1).contiguous()
    kp_g, kp_c = extract_keypoints(heat, *kpt), extract_keypoints(heat.cpu(), *kpt)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) or not kp_c[2].any():
        raise AssertionError("val_reference: keypoints of the same heatmap differ or are none")
    desc_err = float((sample_descriptors(desc, kp_g[0]).cpu()
                      - sample_descriptors(desc.cpu(), kp_c[0])).abs().max())
    if not desc_err <= 1e-5:
        raise AssertionError(f"val_reference: descriptors of the same map differ by {desc_err}")
    same = same_detections(batched_box_nms(pred, **box), batched_box_nms(pred.cpu(), **box),
                           "val_reference, same predictions", 1e-4)
    if int(cpu["base"]["det"]["n_candidates"].min()) <= 0 or pred.shape[1] * nc <= 2048:
        raise AssertionError("val_reference: the tiled scan did not run")
    launches = res[device]["launches"]
    warps = launches.get("K4", 0) + launches.get("K5", 0)  # 128 px images count as K5
    if warps <= 0 or any(launches.get(n, 0) <= 0 for n in ("nms_tile_keys", "greedy_nms_keep",
                                                            "sample_descriptors")):
        raise AssertionError(f"val_reference: launches {launches}, want K1-K3 and the warp")
    if res["cpu"]["launches"]:
        raise AssertionError(f"val_reference: the CPU launched {res['cpu']['launches']}")
    return {"phase": "val_reference", "model": "YOLOPoint-n", "nc": nc, "input": [B, H, H],
            "dtype": "f32", "loss_max_rel": max(loss_rel.values()),
            "losses_card": {k: float(v) for k, v in gpu["losses"].items()},
            "candidates": cpu["base"]["det"]["n_candidates"].tolist(),
            "decode_end_to_end": end_to_end, "detections_same_inputs": same,
            "keypoints_same_inputs": int(kp_c[2].sum()), "descriptor_max_abs": desc_err,
            "launches_card": launches}


def val(seed: int, warmup: int = 1, batches: int = 4, device: str = "cuda"):
    """`TrainAgent.validate` on the s640 config (YOLOPoint-S, nc=5, 640x640,
    B=8 = `val_batch_size`, the val augmentation, seeded weights): `warmup`
    untimed and `batches` timed batches (32 images, all in the extended
    metrics). A batch's time is the host clock from the previous batch's
    metrics to its own; its CUDA-event split: views (the draws and both
    views), forward (two forwards), losses, keypoints, descriptors and
    box_nms (summed over both views), host (the copy to the host and the
    numpy metrics, RANSAC included). Returns the phase line and the
    launches of the timed batches."""
    from yolopoint_tpu_torch.ops import _build

    cfg = s640_train_config()
    B, (H, W) = cfg["training_params"]["val_batch_size"], cfg["data"]["preprocessing"]["resize"]
    nc = len(cfg["names"])
    loader = SeededBatches(seed + 4, B, H, W, nc, B * (warmup + batches), device,
                           distinct=warmup + batches)
    agent = step_agent(cfg, loader, loader.batches[:warmup], seed=seed, device=device)
    if agent.val_aug_config != cfg["data"]["val_augmentation"] or \
            agent.extended_val_n != B * batches:
        raise AssertionError("val: the agent did not take the val config")
    per_batch = []
    val_step = agent.val_step

    def recording(params, batch, draws, on_phase=None):
        out = val_step(params, batch, draws, on_phase)
        per_batch.append({v: (out[v]["det"]["n_candidates"], out[v]["det"]["valid"].sum(1))
                          for v in ("base", "warped")})
        return out

    agent.val_step = recording
    agent.validate()
    torch.cuda.synchronize()
    per_batch.clear()

    marks = []  # (phase name, CUDA event, host time)

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    on_phase("start")
    agent.val_loader = loader.batches[warmup:]
    scalars = agent.validate(on_phase=on_phase)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    batch_ms, split, acc, t_prev = [], [], {}, marks[0][2]
    for (_, a, _), (name, b, tb) in zip(marks, marks[1:]):
        acc[name] = acc.get(name, 0.0) + a.elapsed_time(b)
        if name == "host":  # the end of a batch
            batch_ms.append((tb - t_prev) * 1e3)
            split.append(acc)
            acc, t_prev = {}, tb
    bad = [k for k, v in scalars.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"val: non-finite scalars {bad}")
    cand = torch.stack([c for pb in per_batch for c, _ in pb.values()]).float()
    dets = torch.stack([d for pb in per_batch for _, d in pb.values()]).float()
    if len(batch_ms) != batches or not bool((cand > 2048).all()):
        raise AssertionError(f"val: {len(batch_ms)} batches, candidates {cand.tolist()}")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4", "K5"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"val: kernel {name} was not launched on the val path")
    return {
        "phase": "val", "model": "YOLOPoint-s", "nc": nc, "input": [H, W], "batch": B,
        "dtype": "bf16", "warmup_batches": warmup, "timed_batches": batches,
        "ms_per_batch_p50": statistics.median(batch_ms), "ms_per_batch_all": batch_ms,
        "images_per_s": B * 1e3 / statistics.median(batch_ms),
        "split_ms_p50": {k: statistics.median(s.get(k, 0.0) for s in split) for k in split[0]},
        "candidates_per_image": float(cand.mean()), "candidates_min": float(cand.min()),
        "detections_per_image": float(dets.mean()), "peak_memory_gb": peak / 1e9,
        "scalars": scalars, "launches": launches,
    }, launches


# ---------------------------------------------------------------- the training entry

FIT_OVERRIDES = {  # configs/synthetic_s640.yaml, cut in depth only
    "data": {"length": {"train": 128, "val": 16}},
    "training_params": {"epochs": 2, "val_interval": 1, "save_interval": 1},
}
FIT_KERNELS = ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors", "K4", "K5")


@contextlib.contextmanager
def fit_probes():
    """Class-level timers around the training entry's layers while the CLI
    runs: every `SyntheticShapes._render` (host seconds; on the main thread,
    or in the val loader's worker threads, which share the interpreter lock),
    every micro-step
    (`TrainAgent.step`, host clock to a synchronize; its losses kept), every
    val batch (host clock between the val step's "host" marks), every
    checkpoint write (`CheckpointManager.save`) and the start of every epoch
    (the start of an iteration over the `DeviceDataLoader`). Yields the
    lists they fill."""
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader
    from yolopoint_tpu_torch.data.synthetic import SyntheticShapes
    from yolopoint_tpu_torch.training import TrainAgent
    from yolopoint_tpu_torch.training.checkpoint import CheckpointManager

    rec = {"render_s": [], "render_pool_s": [], "step_ms": [], "step_losses": [],
           "val_batch_ms": [], "val_s": [], "save_s": [], "epoch_start": []}
    real = {(SyntheticShapes, "_render"): SyntheticShapes._render,
            (TrainAgent, "step"): TrainAgent.step, (TrainAgent, "validate"): TrainAgent.validate,
            (CheckpointManager, "save"): CheckpointManager.save,
            (DeviceDataLoader, "__iter__"): DeviceDataLoader.__iter__}

    def render(self, idx):
        cached = idx in self._cache
        t0 = time.perf_counter()
        out = real[(SyntheticShapes, "_render")](self, idx)
        if not cached:  # the loader's worker threads render the val set concurrently
            serial = threading.current_thread() is threading.main_thread()
            rec["render_s" if serial else "render_pool_s"].append(time.perf_counter() - t0)
        return out

    def step(self, batch, on_phase=None):
        t0 = time.perf_counter()
        aux = real[(TrainAgent, "step")](self, batch, on_phase)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["step_losses"].append({k: float(aux[k]) for k in LOSS_TERMS})
        return aux

    def validate(self, epoch=0, on_phase=None):
        marks = [time.perf_counter()]

        def mark(name):
            if name == "host":
                marks.append(time.perf_counter())

        out = real[(TrainAgent, "validate")](self, epoch, mark)
        rec["val_batch_ms"] += [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        rec["val_s"].append(time.perf_counter() - marks[0])
        return out

    def save(self, *args, **kwargs):
        t0 = time.perf_counter()
        real[(CheckpointManager, "save")](self, *args, **kwargs)
        rec["save_s"].append(time.perf_counter() - t0)

    def epoch_batches(self):
        rec["epoch_start"].append(time.perf_counter())
        return real[(DeviceDataLoader, "__iter__")](self)

    wrappers = {"_render": render, "step": step, "validate": validate, "save": save,
                "__iter__": epoch_batches}
    for (cls, name) in real:
        setattr(cls, name, wrappers[name])
    try:
        yield rec
    finally:
        for (cls, name), fn in real.items():
            setattr(cls, name, fn)


def state_tensors(agent) -> dict:
    """Every tensor of an agent's train state, by name (on its device)."""
    opt = agent.optimizer
    out = {f"model.{k}": v for k, v in agent.model.state_dict().items()}
    out.update({f"acc.{i}": a for i, a in enumerate(opt.acc)})
    for i, st in enumerate(opt.adamw.state.values()):
        out.update({f"adamw.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    out.update({f"ema.{k}": v for k, v in (agent.state.ema_params or {}).items()})
    return out


def fit(seed: int, train_ms: float, device: str = "cuda"):
    """The training entry on the card: `configs/synthetic_s640.yaml` written
    by the port's `save_config` to a temporary directory with only
    `FIT_OVERRIDES` changed (YOLOPoint-S, nc=5, 640x640, B=32, bf16, accum 2,
    EMA; 128 train and 16 val images, 2 epochs, validation and a checkpoint
    every epoch), then
      1. `training.cli.main` on it: renders 144 images on the host (4 shapes
         each), puts the training set on the card, 4 micro-steps and 2 val
         batches an epoch;
      2. `--resume` with 3 epochs: the rebuilt agent's state equal to the
         first run's on the card, tensor by tensor, training from epoch 2;
      3. an agent with `pretrained:` a seeded nc=80 YOLOPoint-S file in the
         reference schema and `shrink_perturb` {lam 0.5, sigma 0.01}: only
         Detect tensors mismatch, and the weights moved as configured.
    Checks finite losses and scalars, the checkpoint files and `done.json`
    against the schedule, and K1-K5 launched on this path (both runs).
    Returns the phase line and the path's launches."""
    from yolopoint_tpu_torch.data.device_data import DeviceDataLoader
    from yolopoint_tpu_torch.models.convert import load_weights
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import dict_update, save_config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = dict_update(s640_train_config(), FIT_OVERRIDES)
        save_config(cfg, tmp / "fit.yaml")
        argv = ["--config", str(tmp / "fit.yaml"), "--exper_name", "fit", "--output_dir",
                str(tmp / "logs"), "--data_root", str(tmp / "data"), "--seed", str(seed),
                "--device", device]
        run = tmp / "logs" / "fit"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        with fit_probes() as rec:
            t0 = time.perf_counter()
            agent = cli.main(argv)
            torch.cuda.synchronize()
            wall_run1 = time.perf_counter() - t0
            files_run1 = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
            done1 = json.loads((run / "done.json").read_text())
            epoch_s = [b - a for a, b in zip(rec["epoch_start"], rec["epoch_start"][1:])]
            epoch_s.append(t0 + wall_run1 - rec["epoch_start"][-1])
            runs = {"run1": {k: list(v) for k, v in rec.items() if k != "epoch_start"}}
            for v in rec.values():
                v.clear()
            dict_update(cfg, {"training_params": {"epochs": 3}})
            save_config(cfg, tmp / "fit.yaml")
            resumed = cli.build_agent(argv + ["--resume"])
            saved, now = state_tensors(agent), state_tensors(resumed)
            differ = [k for k in saved if not torch.equal(saved[k], now[k])]
            if set(saved) != set(now) or differ or resumed.start_epoch != 2 \
                    or resumed.global_step != agent.global_step \
                    or resumed.best_fitness != agent.best_fitness:
                raise AssertionError(
                    f"fit: resume differs ({len(differ)} tensors, e.g. {differ[:3]}; start "
                    f"epoch {resumed.start_epoch}, global step {resumed.global_step} vs "
                    f"{agent.global_step}, best {resumed.best_fitness} vs {agent.best_fitness})")
            resumed.train()
            torch.cuda.synchronize()
            runs["resume"] = {k: list(v) for k, v in rec.items() if k != "epoch_start"}
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        done2 = json.loads((run / "done.json").read_text())
        files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
        records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]

        weights = tmp / "yolopoint_s_nc80.pt"
        save_reference_weights(weights, seed, version="s", names=[f"c{i}" for i in range(80)])
        dict_update(cfg, {"shrink_perturb": {"lam": 0.5, "sigma": 0.01}})
        save_config(cfg, tmp / "fit.yaml")
        warm = cli.build_agent(argv[:3] + ["warm"] + argv[4:] + ["--pretrained", str(weights)])
        report = warm.pretrained_report
        source = load_weights(weights)["state_dict"]
        name = "Conv1.conv.weight"
        noise = (warm.model.state_dict()[name].cpu() - 0.5 * source[name]) / 0.01
        ema_start = float((warm.state.ema_params[name] - warm.model.state_dict()[name]).abs().max())

    # every micro-step's losses, from the probe: with 4 micro-steps an epoch and
    # `steps_per_dispatch` 8 no dispatch is full, and the loop, as the JAX one,
    # logs no `training/` record for the leftover micro-steps it runs
    step_losses = runs["run1"]["step_losses"] + runs["resume"]["step_losses"]
    train_loss = [h["loss"] for h in step_losses]
    n_train_records = sum("training/loss" in r for r in records)
    val = [{k[len("validation/"):]: v for k, v in r.items() if k.startswith("validation/")}
           for r in records if "validation/fitness" in r]
    bad = [k for h in step_losses + val for k, x in h.items() if not math.isfinite(x)]
    if len(step_losses) != 12 or bad or len(val) != 3:
        raise AssertionError(f"fit: {len(step_losses)} micro-steps, {len(val)} validations, "
                             f"non-finite {bad}")
    if not isinstance(agent.train_loader, DeviceDataLoader):
        raise AssertionError("fit: the training set did not go to the card")
    want_files = {"config.yml", "metrics.jsonl", "done.json", "best.pt", "best_meta.json",
                  "meta_0.json", "meta_1.json", "ckpts/0.pt", "ckpts/1.pt"}
    if not want_files <= set(files_run1) or \
            (done1["last_epoch"], done1["global_step"], done1["stopped_early"]) != (1, 8, False):
        raise AssertionError(f"fit: run 1 wrote {files_run1}, done {done1}")
    if not want_files | {"meta_2.json", "ckpts/2.pt"} <= set(files) or \
            (done2["last_epoch"], done2["global_step"]) != (2, 12):
        raise AssertionError(f"fit: the resumed run wrote {files}, done {done2}")
    mismatch = report["shape_mismatch"]
    if not mismatch or any(not n.startswith("Detect.") for n in mismatch) or \
            len(report["loaded"]) < 100:
        raise AssertionError(f"fit: warm start loaded {len(report['loaded'])}, mismatched "
                             f"{mismatch}")
    if not (abs(float(noise.mean())) < 0.1 and 0.8 < float(noise.std()) < 1.2) or ema_start:
        raise AssertionError(f"fit: shrink-perturb noise mean {float(noise.mean())} std "
                             f"{float(noise.std())}, EMA off the weights by {ema_start}")
    for k in FIT_KERNELS:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"fit: kernel {k} was not launched on the training entry")
    r1 = runs["run1"]
    renders = r1["render_s"] + runs["resume"]["render_s"]
    pool_renders = r1["render_pool_s"] + runs["resume"]["render_pool_s"]
    steps = r1["step_ms"] + runs["resume"]["step_ms"]
    return {
        "phase": "fit", "model": "YOLOPoint-s", "nc": len(cfg["names"]),
        "input": cfg["data"]["preprocessing"]["resize"],
        "batch": cfg["training_params"]["train_batch_size"], "dtype": "bf16",
        "accum": agent.accum, "overrides": FIT_OVERRIDES,
        "render_images": len(renders), "render_s_per_image": statistics.mean(renders),
        "render_images_val_pool": len(pool_renders),
        "render_s_per_image_val_pool": statistics.mean(pool_renders),
        "epoch_s": epoch_s, "wall_run1_s": wall_run1,
        "ms_per_step_p50": statistics.median(steps), "ms_per_step_all": steps,
        "train_phase_ms_per_step_p50": train_ms,
        "ms_per_val_batch_p50": statistics.median(r1["val_batch_ms"]),
        "val_batch_ms_all": r1["val_batch_ms"] + runs["resume"]["val_batch_ms"],
        "val_s_per_epoch": r1["val_s"], "checkpoint_save_s": r1["save_s"] + runs["resume"]["save_s"],
        "peak_memory_gb": peak / 1e9, "device_dataset_gb": agent.train_loader.nbytes / 1e9,
        "val_scalars": val, "train_loss": train_loss, "training_records": n_train_records,
        "files": files,
        "done": [done1, done2], "resume": {"start_epoch": 2, "tensors_equal": len(saved)},
        "warm_start": {"loaded": len(report["loaded"]), "shape_mismatch": mismatch,
                       "noise_mean": float(noise.mean()), "noise_std": float(noise.std())},
        "launches": launches,
    }, launches


# ---------------------------------------------------------------- serving consumers

# configs/inference.yaml, the demo and ROS operating point, at the serving
# detection threshold 0.015 in place of its 0.12: random weights put the
# heatmap near 1/65, and no keypoint would pass 0.12
INFERENCE_CONFIG = {
    "detection_threshold": 0.015, "nms": 8, "top_k": 600, "border_remove": 4,
    "conf_thresh": 0.25, "iou_thresh": 0.45, "max_det": 300, "filter_pts_in_boxes": True,
}
INFERENCE_IMG_SIZE = 640


def grey_images(seed: int, n: int, H: int, W: int) -> list:
    """`n` seeded grey uint8 `(H, W, 3)` numpy images (one grey plane
    repeated, as `SyntheticShapes.get` returns its renders): flat rectangles
    of random levels on a flat background, with mild noise."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        img = torch.full((H, W), float(torch.randint(30, 220, (1,), generator=gen)))
        for _ in range(24):
            y0 = int(torch.randint(0, H - 8, (1,), generator=gen))
            x0 = int(torch.randint(0, W - 8, (1,), generator=gen))
            h = int(torch.randint(8, max(H // 3, 9), (1,), generator=gen))
            w = int(torch.randint(8, max(W // 3, 9), (1,), generator=gen))
            img[y0:y0 + h, x0:x0 + w] = float(torch.randint(0, 256, (1,), generator=gen))
        img = (img + torch.randn(H, W, generator=gen) * 4.0).round().clamp(0, 255)
        out.append(img.to(torch.uint8)[..., None].expand(H, W, 3).numpy().copy())
    return out


@torch.inference_mode()
def serve_frame(seed: int, requests: int = 8, device: str = "cuda"):
    """`InferencePipeline.process_frame(frame, img_size=640)` on 720x1280
    uint8 frames at the demo operating point (`INFERENCE_CONFIG`;
    YOLOPoint-S, bf16, BN folded): the resize (`ops.resize`, INTER_AREA at
    ratio 0.5) and the crop on the host, then the pipeline on the card.
    Checks the outputs' shapes, that they are finite and mapped back into
    the frame, and one K1, K2 and K3 launch per frame. Returns the phase
    line and the launches of the timed frames."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import _build

    pipe = InferencePipeline(folded_yolopoint_s(seed, torch.bfloat16, device), INFERENCE_CONFIG,
                             compute_dtype=torch.bfloat16, device=device)
    frame = grey_images(seed + 7, 1, 720, 1280)[0]
    frame[..., 2] = frame[..., 0] // 2  # a colour frame
    for _ in range(2):
        pipe.process_frame(frame, INFERENCE_IMG_SIZE)
    torch.cuda.synchronize()
    _build.launch_counts.clear()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pipe.process_frame(frame, INFERENCE_IMG_SIZE)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launch_counts)
    kp = out["keypoints"][out["kp_valid"]]
    if out["keypoints"].shape != (INFERENCE_CONFIG["top_k"], 2) or out["boxes"].shape != (300, 4):
        raise AssertionError(f"process_frame: shapes {out['keypoints'].shape} {out['boxes'].shape}")
    if not all(math.isfinite(float(v.sum())) for v in out.values() if v.dtype.kind == "f"):
        raise AssertionError("process_frame: non-finite outputs")
    if len(kp) == 0 or kp.min() < 0 or (kp[:, 0] > 1279).any() or (kp[:, 1] > 719).any():
        raise AssertionError(f"process_frame: {len(kp)} keypoints, or some off the 720x1280 frame")
    for name in ("nms_tile_keys", "greedy_nms_keep", "sample_descriptors"):
        if launches.get(name, 0) != requests:
            raise AssertionError(f"process_frame: launches {launches}, want {requests} of {name}")
    return {"phase": "serve_frame", "model": "YOLOPoint-s", "frame": [720, 1280],
            "img_size": INFERENCE_IMG_SIZE, "dtype": "bf16", "config": INFERENCE_CONFIG,
            "ms_p50": statistics.median(times), "ms_all": times, "keypoints": int(len(kp)),
            "launches": launches}, launches


# ---------------------------------------------------------------- HPatches

HPATCHES_SIZE = (256, 320)
HPATCHES_SCENES = 2


def write_ppm(path: Path, bgr) -> None:
    """A binary PPM of a uint8 `(H, W, 3)` BGR numpy image (RGB in the file)."""
    h, w, _ = bgr.shape
    path.write_bytes(b"P6\n%d %d\n255\n" % (w, h) + bgr[..., ::-1].tobytes())


def write_hpatches_scenes(root: Path, seed: int, device: str = "cuda") -> int:
    """`HPATCHES_SCENES` scenes in the HPatches layout under `root`: a seeded
    grey base image `1.ppm` at `HPATCHES_SIZE`, and `2.ppm`..`6.ppm` its
    warps on the card by homographies of the port's sampler with the s640
    `warped_pair` parameters, each with its pixel homography `H_1_n`
    (`x_n = H_1_n x_1`). Returns the number of pairs."""
    from yolopoint_tpu_torch.ops.geometry import warp_image
    from yolopoint_tpu_torch.ops.homography import sample_homography_batch

    H, W = HPATCHES_SIZE
    params = s640_train_config()["data"]["augmentation"]["warped_pair"]["params"]
    gen = torch.Generator(device=device).manual_seed(seed)
    # pixel -> normalized coordinates of the warp (align corners)
    norm = torch.tensor([[2.0 / (W - 1), 0.0, -1.0], [0.0, 2.0 / (H - 1), -1.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    for s, base in enumerate(grey_images(seed, HPATCHES_SCENES, H, W)):
        scene = root / f"v_smoke{s:03d}"
        scene.mkdir(parents=True)
        write_ppm(scene / "1.ppm", base)
        homs = sample_homography_batch(gen, 5, **params)
        img = torch.from_numpy(base).to(device).float().div(255.0)
        views = warp_image(img.expand(5, H, W, 3).contiguous(), homs)
        views = views.mul(255.0).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        for n in range(2, 7):
            write_ppm(scene / f"{n}.ppm", views[n - 2])
            # view n at pixel q shows image 1 at A q: x_n = A^-1 x_1
            A = torch.linalg.inv(norm) @ homs[n - 2].cpu().double() @ norm
            h1n = torch.linalg.inv(A)
            h1n = (h1n / h1n[2, 2]).tolist()
            (scene / f"H_1_{n}").write_text("\n".join(" ".join(f"{v:.10g}" for v in row)
                                                      for row in h1n))
    return HPATCHES_SCENES * 5


def save_reference_weights(path: Path, seed: int, version: str = "n", names=None) -> None:
    """Seeded random YOLOPoint weights (default: the nc=5 s640 class names)
    saved in the reference schema (`model_state_dict`, `names`, `version`,
    `model_name`)."""
    from yolopoint_tpu_torch.models import build_model, state_dict_to_reference

    names = names or s640_train_config()["names"]
    model = build_model("YOLOPoint", version, nc=len(names), device="cpu")
    torch.save({"model_state_dict": state_dict_to_reference(random_weights(model, seed)),
                "names": names, "version": version, "model_name": "YOLOPoint"}, path)


def hpatches(seed: int, root: Path, weights: Path, pairs: int):
    """`hpatches_runner.main` on the scenes of `write_hpatches_scenes` with
    the seeded weights of `weights` (read by the reference-schema loader),
    the CLI's default fused bf16 path on the card, at 256x320: one warm-up
    pair, then every pair. A pair's time is the host clock from the
    dataset's read of that pair to the next read (to the return after the
    last): the reads, two pipeline calls (each ending in a copy to the
    host) and the numpy metrics. Checks the metrics, and 2 launches a pair
    of K2, K3 and the keypoint NMS: K1, since 256 and 320 are multiples of
    the NMS tile (4); no K6. Returns the phase line and the launches."""
    from yolopoint_tpu_torch.data import datasets
    from yolopoint_tpu_torch.evaluation import hpatches_runner
    from yolopoint_tpu_torch.ops import _build

    argv = ["--data", str(root), "--weights", str(weights),
            "--size", str(HPATCHES_SIZE[0]), str(HPATCHES_SIZE[1])]
    with contextlib.redirect_stdout(sys.stderr):  # the runner prints its own line
        hpatches_runner.main(argv + ["--max-pairs", "1"])
    torch.cuda.synchronize()
    reads, getitem = [], datasets.HPatches.__getitem__

    def timed_getitem(self, idx):
        reads.append(time.perf_counter())
        return getitem(self, idx)

    _build.launch_counts.clear()
    datasets.HPatches.__getitem__ = timed_getitem
    try:
        with contextlib.redirect_stdout(sys.stderr):
            metrics = hpatches_runner.main(argv)
    finally:
        datasets.HPatches.__getitem__ = getitem
    reads.append(time.perf_counter())
    launches = dict(_build.launch_counts)
    pair_ms = [(b - a) * 1e3 for a, b in zip(reads, reads[1:])]
    if metrics["num_pairs"] != pairs or len(pair_ms) != pairs:
        raise AssertionError(f"hpatches: {metrics['num_pairs']} pairs, {len(pair_ms)} timed")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or not 0.0 <= metrics["repeatability"] <= 1.0:
        raise AssertionError(f"hpatches: metrics {metrics}")
    want = {"nms_tile_keys": 2 * pairs, "greedy_nms_keep": 2 * pairs,
            "sample_descriptors": 2 * pairs}
    if {k: launches.get(k, 0) for k in want} != want or launches.get("K6", 0):
        raise AssertionError(f"hpatches: launches {launches}, want {want} and no K6")
    return {"phase": "hpatches", "model": "YOLOPoint-n", "nc": 5, "input": list(HPATCHES_SIZE),
            "dtype": "bf16 (fused)", "pairs": pairs, "metrics": metrics,
            "ms_per_pair_p50": statistics.median(pair_ms), "ms_per_pair_all": pair_ms,
            "launches": launches}, launches


@torch.inference_mode()
def hpatches_reference(seed: int, root: Path, device: str = "cuda"):
    """One pair of the written scenes through the f32 YOLOPoint-n (TF32
    off): the forward and the heatmap (softmax) of both images on the card;
    then, from those same tensors, the keypoints (K1) and the descriptors at
    them (K3) on the card against the plain versions on the CPU, and the
    pair's metrics from each side. Keypoints equal, descriptors within 1e-5,
    the mutual matches equal, and then every metric equal (the RANSAC sees
    the same matches). (The heatmap is shared because random weights put it
    near the 0.015 threshold, where an ulp of softmax moves keypoints.)"""
    from yolopoint_tpu_torch.data.datasets import HPatches
    from yolopoint_tpu_torch.evaluation.hpatches_runner import pair_metrics
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.ops import cells_to_heatmap, extract_keypoints, sample_descriptors

    model = build_model("YOLOPoint", "n", nc=5, device="cpu")
    random_weights(model, seed)
    pipe = InferencePipeline(model, {"detection_threshold": 0.015}, device=device)
    args = (pipe.conf_thresh, pipe.nms_radius, pipe.top_k, pipe.border)
    sample = HPatches(root, HPATCHES_SIZE)[2]
    outs = {device: [], "cpu": []}
    for k in ("image", "warped_image"):
        raw = pipe.forward(torch.from_numpy(sample[k][None]).to(device))
        heat = cells_to_heatmap(raw["semi"].float().permute(0, 2, 3, 1))
        desc = raw["desc"].permute(0, 2, 3, 1).contiguous()
        for dev in (device, "cpu"):
            pts, scores, valid = extract_keypoints(heat.to(dev), *args)
            outs[dev].append({"keypoints": pts.cpu().numpy(), "kp_scores": scores.cpu().numpy(),
                              "kp_valid": valid.cpu().numpy(), "descriptors": sample_descriptors(
                                  desc.to(dev), pts).cpu().numpy()})
    card, cpu = outs[device], outs["cpu"]
    for a, b in zip(card, cpu):
        for k in ("keypoints", "kp_scores", "kp_valid"):
            if not (a[k] == b[k]).all():
                raise AssertionError(f"hpatches_reference: {k} differ between the card and the CPU")
    desc_err = max(float(abs(a["descriptors"] - b["descriptors"]).max()) for a, b in zip(card, cpu))
    if not desc_err <= 1e-5:
        raise AssertionError(f"hpatches_reference: descriptors differ by {desc_err} > 1e-5")
    m = {name: pair_metrics(o[0], o[1], sample["homography_pix"], HPATCHES_SIZE)
         for name, o in (("card", card), ("cpu", cpu))}
    hc_g, hc_c = m["card"]["correctness"], m["cpu"]["correctness"]
    if not (hc_g["matches"].shape == hc_c["matches"].shape
            and (hc_g["matches"] == hc_c["matches"]).all()):
        raise AssertionError("hpatches_reference: the mutual matches differ")

    def scalars(x):
        hc = x["correctness"]
        return {"repeatability": x["repeatability"], "localization_error": x["localization_error"],
                "matching_score": hc["matching_score"], "mean_dist": hc["mean_dist"],
                "match_ap": x["match_ap"]}

    got, want = scalars(m["card"]), scalars(m["cpu"])
    if got != want:
        raise AssertionError(f"hpatches_reference: metrics card {got} vs CPU {want}")
    n_kp = [int(o["kp_valid"].sum()) for o in cpu]
    if min(n_kp) == 0 or len(hc_c["matches"]) == 0:
        raise AssertionError(f"hpatches_reference: keypoints {n_kp}, {len(hc_c['matches'])} matches")
    return {"phase": "hpatches_reference", "model": "YOLOPoint-n", "input": list(HPATCHES_SIZE),
            "dtype": "f32", "pair": sample["name"], "keypoints": n_kp,
            "matches": int(len(hc_c["matches"])), "descriptor_max_abs": desc_err, "metrics": want}


# ---------------------------------------------------------------- export

def s640_export_config() -> dict:
    """`configs/synthetic_s640_export.yaml`, read by the port's config reader."""
    from yolopoint_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "synthetic_s640_export.yaml")


EXPORT_PHASES = ("views", "forward", "heatmap", "warps_back", "aggregate_nms")


def export_kwargs(num_homographies: int | None = None) -> dict:
    """`homography_adaptation_batch` arguments of `s640_export_config()`, as
    the JAX export CLI reads them."""
    cfg = s640_export_config()
    ex, sp = cfg["export"], cfg["model"]["superpoint"]
    return dict(num_homographies=num_homographies or ex["num_homographies"],
                conf_thresh=sp["detection_threshold"], nms_radius=sp["nms"], top_k=sp["top_k"],
                hom_params=ex["homography"], erosion_radius=ex["erosion_radius"])


def export_model(seed: int, device):
    """The export's model as the JAX export CLI builds it: f32, BN unfolded
    (YOLOPoint-S, nc=5, seeded random weights)."""
    from yolopoint_tpu_torch.models import build_model

    model = build_model("YOLOPoint", "s", nc=len(s640_export_config()["names"]), device="cpu")
    random_weights(model, seed)
    return model.to(device).eval()


def export(seed: int, warmup: int = 1, images: int = 4, device: str = "cuda"):
    """`export_pseudo_labels` at the settings of `s640_export_config()`
    (YOLOPoint-S, 640x640, N = 50 views, f32) on `warmup` + `images` seeded
    grey images into a temporary directory. An image's time is the host
    clock from its start to the next image's (to the return after the
    last), the `.npz` write included; its CUDA-event split follows
    `EXPORT_PHASES`. Checks 3 K4 and 1 K1 launches an image, no other
    kernel; the tiles that took the warp's global branch (the kernel's
    counter, over the run) equal to those whose window exceeds the budget,
    summed over each image's three warps (`cuda_warp.window_bytes` of its
    homographies, redrawn from the same generators); and every file's `pts`
    of shape (K <= top_k, 3), 0 < K, inside the frame. Returns the phase
    line and the launches of the timed images."""
    import numpy as np

    from yolopoint_tpu_torch.export import draw_homographies, export_pseudo_labels, image_generator
    from yolopoint_tpu_torch.ops import _build, cuda_warp

    H, W = s640_export_config()["data"]["preprocessing"]["resize"]
    kw = export_kwargs()
    N, top_k = kw["num_homographies"], kw["top_k"]
    model = export_model(seed, device)
    grey = grey_images(seed + 8, warmup + images, H, W)
    items = [(f"smoke_{i:06d}", g.astype(np.float32) / 255.0) for i, g in enumerate(grey)]
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    with tempfile.TemporaryDirectory() as tmp:
        export_pseudo_labels(model, items[:warmup], Path(tmp) / "warmup", seed=seed + 1, **kw)
        torch.cuda.synchronize()
        tiles_before = cuda_warp.global_tile_count(device)
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        paths = export_pseudo_labels(model, items[warmup:], tmp, seed=seed, on_phase=on_phase,
                                     **kw)
        end = time.perf_counter()
        launches = dict(_build.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        global_tiles = cuda_warp.global_tile_count(device) - tiles_before
        files = [np.load(p)["pts"] for p in paths]

    starts = [t for name, _, t in marks if name == "start"] + [end]
    image_s = [b - a for a, b in zip(starts, starts[1:])]
    split = {name: [] for name in EXPORT_PHASES}
    for (_, a, _), (name, b, _) in zip(marks, marks[1:]):
        if name != "start":
            split[name].append(a.elapsed_time(b))
    if launches != {"K4": 3 * images, "nms_tile_keys": images}:
        raise AssertionError(f"export: launches {launches}, want {3 * images} K4 and "
                             f"{images} nms_tile_keys")
    expected = {"views": 0, "heat_back": 0, "mask_back": 0}
    with torch.inference_mode():
        for i in range(images):
            homs = draw_homographies(image_generator(seed, i, device), N, kw["hom_params"])
            inv = torch.linalg.inv(homs)
            over = {"views": (homs, 3), "heat_back": (inv, 1), "mask_back": (inv, 1)}
            for k, (h, c) in over.items():
                expected[k] += int((cuda_warp.window_bytes(h, (N, H, W, c))
                                    > cuda_warp.WINDOW_BYTES).sum())
    if global_tiles != sum(expected.values()):
        raise AssertionError(f"export: {global_tiles} tiles took the warp's global branch, "
                             f"the windows say {expected}")
    n_pts = [len(f) for f in files]
    for f in files:
        if f.ndim != 2 or f.shape[1] != 3 or not 0 < len(f) <= top_k or not np.isfinite(f).all():
            raise AssertionError(f"export: a file holds pts of shape {f.shape}")
        if f[:, 0].min() < 0 or f[:, 0].max() > W - 1 or f[:, 1].min() < 0 \
                or f[:, 1].max() > H - 1:
            raise AssertionError("export: points off the frame")
    tx, ty = cuda_warp.tile_grid(H, W)
    return {"phase": "export", "model": "YOLOPoint-s", "nc": len(s640_export_config()["names"]),
            "input": [H, W], "dtype": "f32", "num_homographies": N, "warmup_images": warmup,
            "timed_images": images, "s_per_image_p50": statistics.median(image_s),
            "s_per_image_all": image_s,
            "split_ms_p50": {k: statistics.median(v) for k, v in split.items()},
            "peak_memory_gb": peak / 1e9, "launches": launches,
            "global_tiles": {"per_warp": expected, "counter": global_tiles,
                             "tiles_per_warp": images * N * tx * ty},
            "points_per_image": n_pts}, launches


@torch.inference_mode()
def export_reference(seed: int, device: str = "cuda"):
    """One seeded 128x128 image, N = 4 views of the export's parameters
    (drawn once on the CPU), the export's f32 model (TF32 off): the
    aggregate heatmap on the card (K4 warps) against the CPU (plain warps)
    within 1e-5 (the forwards differ in f32 rounding, the matrix inverses in
    the last bits, and the warps back are bilinear); then the keypoints
    decoded from the card's aggregate, on the card (K1) and on the CPU,
    equal. (Random weights put the aggregate near 1/65, by the 0.015
    threshold, so keypoints of two separately computed aggregates are not
    compared.)"""
    from yolopoint_tpu_torch.export import aggregate_heatmap, draw_homographies
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

    H = W = 128
    kw = export_kwargs(num_homographies=4)
    homs = draw_homographies(torch.Generator().manual_seed(seed + 9), kw["num_homographies"],
                             kw["hom_params"])
    img = torch.from_numpy(grey_images(seed + 10, 1, H, W)[0]).float() / 255.0
    _build.launch_counts.clear()
    agg_g = aggregate_heatmap(export_model(seed, device), img.to(device), homs.to(device),
                              kw["erosion_radius"])
    agg_c = aggregate_heatmap(export_model(seed, "cpu"), img, homs, kw["erosion_radius"])
    err = float((agg_g.cpu() - agg_c).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"export_reference: aggregates differ by {err} > 1e-5")
    args = (kw["conf_thresh"], kw["nms_radius"], kw["top_k"])
    kp_g = extract_keypoints(agg_g[None], *args)
    kp_c = extract_keypoints(agg_g.cpu()[None], *args)
    launches = dict(_build.launch_counts)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(kp_g, kp_c)) or not kp_c[2].any():
        raise AssertionError("export_reference: keypoints of the same aggregate differ or are none")
    if launches.get("nms_tile_keys", 0) != 1 or launches.get("K4", 0) + launches.get("K5", 0) != 3:
        raise AssertionError(f"export_reference: launches {launches}")
    return {"phase": "export_reference", "model": "YOLOPoint-s", "input": [H, W],
            "num_homographies": kw["num_homographies"], "dtype": "f32",
            "aggregate_max_abs": err, "aggregate_max": float(agg_c.max()),
            "keypoints": int(kp_c[2].sum()), "launches_card": launches}


# ---------------------------------------------------------------- main


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


KERNELS = {  # launch-count key -> (kernel name, CUDA source, TPU kernel it replaces, path)
    "nms_tile_keys": ("nms_tile_keys", "yolopoint_tpu_torch/ops/csrc/nms_keys.cu",
                      "yolopoint_tpu/ops/pallas_nms.py:172", "serve"),
    "greedy_nms_keep": ("greedy_nms_keep", "yolopoint_tpu_torch/ops/csrc/box_nms.cu",
                        "yolopoint_tpu/ops/pallas_box_nms.py:30", "serve"),
    "sample_descriptors": ("sample_descriptors", "yolopoint_tpu_torch/ops/csrc/gather.cu",
                           "yolopoint_tpu/ops/pallas_gather.py:31", "serve"),
    "K4": ("warp_image (K4 shapes)", "yolopoint_tpu_torch/ops/csrc/warp.cu",
           "yolopoint_tpu/ops/pallas_warp.py:185", "train"),
    "K5": ("warp_image (K5 shapes)", "yolopoint_tpu_torch/ops/csrc/warp.cu",
           "yolopoint_tpu/ops/pallas_warp.py:47", "train"),
    "K6": ("nms_suppressed_map", "yolopoint_tpu_torch/ops/csrc/nms_keys.cu",
           "yolopoint_tpu/ops/pallas_nms.py:97", "serve_untiled"),
}


GLOBAL_BRANCH = {"nms_tile_keys": "nms_tile_keys_global", "K6": "K6_global"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "yolopoint_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from yolopoint_tpu_torch import set_determinism
    from yolopoint_tpu_torch.ops import _build

    set_determinism()
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    path, compiled = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "compiled": compiled,
          "library": path.name, "sources": [p.name for p in _build.sources()]})

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_shape = {}  # launch-count key -> the kernel's line at the shapes of its path
    path_shapes = {}  # launch-count key -> its lines at the shapes of the other paths

    def record(key, line, path):
        if path == KERNELS[key][3]:
            main_shape[key] = line
        elif path:
            path_shapes.setdefault(key, []).append(line)

    for check, args, kwargs, path in (
        (check_k1, (16, torch.bfloat16, 40), {}, "serve"),
        (check_k1, (1, torch.bfloat16, 40), {}, None),  # the batch-1 requests of serve
        (check_k1, (8, torch.float32, 40), {}, None),
        (check_k1, (1, torch.float32, 40), {}, "export"),  # the aggregate's NMS
        (check_k1, (1, torch.float32, 40), dict(H=256, W=320), "hpatches"),
        (check_k2, (16, 512, 40), {}, "serve"),
        (check_k2, (4, 2048, 20), {}, None),
        (check_k2, (8, 1024, 20), {}, None),  # one tile of the val path's tiled scan
        (check_k3, (16, torch.float32, 40), {}, "serve"),
        (check_k3, (8, torch.bfloat16, 40), {}, None),
    ):
        before = sum(_build.launch_counts.values())
        line = check(gen, *args, **kwargs)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": path, **line})
        record(line["kernel"], line, path)

    for line in check_warps(gen):
        emit({"phase": "kernel", **line})
        record(line["kernel"], line, line.pop("path"))

    before = sum(_build.launch_counts.values())
    val_tiles = check_k2_tiles(record_val_tiles(seed=0))
    val_tiles["launches"] = sum(_build.launch_counts.values()) - before  # recording included
    emit({"phase": "kernel", **val_tiles})

    for B, H, W, dtype, radius, path in ((16, 640, 640, torch.bfloat16, 4, "serve_untiled"),
                                         (16, 640, 640, torch.bfloat16, 3, None),
                                         (1, 256, 320, torch.float32, 4, None),
                                         (2, 101, 94, torch.float32, 7, None)):
        before = sum(_build.launch_counts.values())
        line = check_k6(gen, B, H, W, dtype, radius, 40 if path else 10)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", "path": path, **line})
        record(line["kernel"], line, path)

    large = {}  # the global branch's launch key -> its lines
    for args in LARGE_RADIUS_INPUTS:
        before = sum(_build.launch_counts.values())
        line = check_large_radius(gen, *args)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", **line})
        large.setdefault(line["branch"], []).append(line)

    smi = nvidia_smi()
    path_launches = {}  # each path's launches, counted from 0 around its run
    emit(check_reference(seed=0))
    for name, run in (("serve", serve), ("serve_untiled", serve_untiled),
                      ("serve_frame", serve_frame)):
        line, path_launches[name] = run(seed=0)
        emit(dict(line, card=smi))
    emit(train_reference(seed=0))
    train_line, path_launches["train"] = train(seed=0)
    emit(dict(train_line, card=smi))
    emit(val_reference(seed=0))
    line, path_launches["val"] = val(seed=0)
    emit(dict(line, card=smi))
    line, path_launches["fit"] = fit(seed=0, train_ms=train_line["ms_per_step_p50"])
    emit(dict(line, card=smi))
    with tempfile.TemporaryDirectory() as tmp:
        root, weights = Path(tmp) / "hpatches", Path(tmp) / "yolopoint_n.pt"
        pairs = write_hpatches_scenes(root, seed=0)
        save_reference_weights(weights, seed=0)
        line, path_launches["hpatches"] = hpatches(0, root, weights, pairs)
        emit(dict(line, card=smi))
        emit(hpatches_reference(0, root))
    line, path_launches["export"] = export(seed=0)
    emit(dict(line, card=smi))
    emit(export_reference(seed=0))

    kernels = []
    for key, (name, source, replaces, path) in KERNELS.items():
        k = main_shape[key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[path][key], "path": path,
            "launches_on_paths": {p: n.get(key, 0) for p, n in path_launches.items()},
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "kernel_ms": k["kernel_ms"],  # the launches alone (CUDA graph)
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            # F.grid_sample for the warp (its nearest mode rounds ties to even),
            # F.grid_sample + F.normalize for K3; no single PyTorch call computes
            # the others
            "library_ms": k.get("library_ms"),
        }
        if key in path_shapes:  # the kernel at the shapes of the other paths
            entry["path_shapes"] = [
                {f: ln.get(f) for f in ("shape", "dtype", "homographies", "max_abs_err", "ms",
                                        "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "global_tiles") if f in ln}
                for ln in path_shapes[key]]
        if key == "greedy_nms_keep":
            entry["val_tiles"] = {k2: val_tiles[k2] for k2 in (
                "tiles", "valid", "ms", "kernel_ms", "kernel_ms_all_tiles", "bound_ms")}
        branch = GLOBAL_BRANCH.get(key)
        if branch:  # the large-radius branch: on no path, launched by its checks
            entry["global_branch"] = {
                "key": branch, "launches_on_paths": sum(n.get(branch, 0)
                                                        for n in path_launches.values()),
                "checked": [{f: ln[f] for f in ("shape", "dtype", "radius", "kernel_ms",
                                                 "launches")} for ln in large[branch]]}
        kernels.append(entry)
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
