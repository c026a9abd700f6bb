#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolopoint_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  build      compile the CUDA kernels from `yolopoint_tpu_torch/ops/csrc/`
             (one nvcc call, loaded with ctypes) and time it;
  kernel     per kernel and input, the kernel against its plain PyTorch
             version on the card (K1 keys bit-equal, K2 keep masks equal,
             K3 within 1e-5), with median times from CUDA events and the
             launches the check made;
  reference  YOLOPoint-S in f32 on a small input: the forward on the card
             against the CPU, and the decode on the card (kernels) against
             the CPU decode (plain versions) of the same forward outputs;
  serve      YOLOPoint-S (nc=80, 640x640, bf16, BN folded, seeded random
             weights) through `InferencePipeline` at the benchmark operating
             point, on uint8 batches of 1 and 16; checks shapes, finiteness
             and that K1, K2 and K3 each launched on this path.
Then a `{"kernels": [...]}` summary line, the card's name and power limit as
`nvidia-smi` reports them, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure raises, so the exit code is non-zero; without a GPU, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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


def check_k1(gen, B, dtype, reps):
    from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_keys, nms_tile_keys_torch

    H = W = 640
    conf, r, it, border = 0.015, 4, 3, 4
    hm = heatmap_batch(gen, B, H, W, dtype)
    got = nms_tile_keys(hm, conf, r, it, border)
    ref = nms_tile_keys_torch(hm, conf, r, it, border)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        n_bad = int((got != ref).sum())
        raise AssertionError(f"K1 {dtype} keys differ from the plain version in {n_bad} tiles")
    ms = cuda_ms(lambda: nms_tile_keys(hm, conf, r, it, border), reps)
    plain_ms = cuda_ms(lambda: nms_tile_keys_torch(hm, conf, r, it, border), max(reps // 4, 3))
    n_bytes = hm.numel() * hm.element_size() + got.numel() * 4
    n_ops = B * H * W * ((1 + 2 * (it - 1)) * 2 * 2 * r + 15)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "kernel": "nms_tile_keys", "shape": [B, H, W], "dtype": str(dtype).split(".")[-1],
        "survivors": int((ref > 0).sum()), "max_abs_err": int((got - ref).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
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


def check_k2(gen, B, K, reps):
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
    plain_ms = cuda_ms(lambda: greedy_nms_keep_torch(boxes, valid, iou), 3, warmup=1)
    n_bytes = boxes.numel() * 4 + valid.numel() + got.numel()
    n_ops = B * K * (K - 1) / 2 * 14  # one IoU + compare per ordered pair
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "kernel": "greedy_nms_keep", "shape": [B, K], "kept": int(ref.sum()),
        "max_abs_err": int((got.int() - ref.int()).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_k3(gen, B, dtype, reps):
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
    plain_ms = cuda_ms(lambda: sample_descriptors_torch(desc, pts, cell), max(reps // 4, 3))
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
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


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


def folded_yolopoint_s(seed: int, dtype, device):
    from yolopoint_tpu_torch.models import build_model, fold_batch_norm

    state = random_weights(build_model("YOLOPoint", "s", nc=80, device="cpu"), seed)
    model = build_model("YOLOPoint", "s", nc=80, fused=True, device="cpu")
    model.load_state_dict(fold_batch_norm(state))
    return model.to(device=device, dtype=dtype).eval()


def same_points(a_pts, a_valid, b_pts, b_valid) -> bool:
    a = sorted(map(tuple, a_pts[a_valid].tolist()))
    b = sorted(map(tuple, b_pts[b_valid].tolist()))
    return a == b


@torch.inference_mode()
def check_reference(seed: int, device: str = "cuda"):
    """f32 YOLOPoint-S on one 256x256 frame: the forward on the card against
    the CPU (TF32 off), then each decode stage on the card (kernels) against
    the CPU (plain versions) on the same inputs, copied from the card."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.ops import (cells_to_heatmap, extract_keypoints,
                                         fused_detect_nms, sample_descriptors)

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
    return {"phase": "reference", "frame": [256, 256], "forward_max_abs": fwd_err,
            "keypoints": n_kp, "descriptor_max_abs": desc_err, "boxes": nb_c,
            "box_candidates": int(det_c["n_candidates"][0]), "box_max_abs": box_err}


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


# ---------------------------------------------------------------- main


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


KERNELS = {  # wrapper -> (kernel name, CUDA source, TPU kernel it replaces)
    "nms_tile_keys": ("nms_tile_keys", "yolopoint_tpu_torch/ops/csrc/nms_keys.cu",
                      "yolopoint_tpu/ops/pallas_nms.py:172"),
    "greedy_nms_keep": ("greedy_nms_keep", "yolopoint_tpu_torch/ops/csrc/box_nms.cu",
                        "yolopoint_tpu/ops/pallas_box_nms.py:30"),
    "sample_descriptors": ("sample_descriptors", "yolopoint_tpu_torch/ops/csrc/gather.cu",
                           "yolopoint_tpu/ops/pallas_gather.py:31"),
}


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
    main_shape = {}  # wrapper -> its line at the shapes of the serving path
    for check, args, on_path in (
        (check_k1, (16, torch.bfloat16, 40), True),
        (check_k1, (8, torch.float32, 40), False),
        (check_k2, (16, 512, 40), True),
        (check_k2, (4, 2048, 20), False),
        (check_k3, (16, torch.float32, 40), True),
        (check_k3, (8, torch.bfloat16, 40), False),
    ):
        before = sum(_build.launch_counts.values())
        line = check(gen, *args)
        line["launches"] = sum(_build.launch_counts.values()) - before  # by this check
        emit({"phase": "kernel", **line})
        if on_path:
            main_shape[line["kernel"]] = line

    emit(check_reference(seed=0))
    serve_line, launches = serve(seed=0)
    smi = nvidia_smi()
    serve_line["card"] = smi
    emit(serve_line)

    kernels = []
    for wrapper, (name, source, replaces) in KERNELS.items():
        k = main_shape[wrapper]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[wrapper], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the same function
        })
    emit({"kernels": kernels, "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
