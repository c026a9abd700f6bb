"""Render the synthetic HPatches-layout benchmark set, file for file as the
JAX package's `tools/make_synthetic_hpatches.py` writes it, without `cv2`.

Layout: `<out>/{v,i}_synth<NNN>/{1..6}.ppm` and the ground-truth `H_1_n`
text files, the layout `data.datasets.HPatches` reads. A viewpoint (`v_`)
scene views one synthetic-shapes mosaic (a 2x canvas of four native-scale
renders, each overlaid with two primitives) through sampled homographies;
an illumination (`i_`) scene keeps H = identity and changes gain, bias,
shading and noise. The renders are `data.synthetic`'s, the blur
`data.raster.gaussian_blur`, the homographies
`ops.homography.sample_homography_np`, the warp
`data.cv_warp.warp_perspective_u8` (OpenCV 5's `warpPerspective`) and the
files `data.netpbm.write_ppm`.

  python -m yolopoint_tpu_torch.tools.synthetic_hpatches --out datasets/hpatches_synth \
      [--scenes 16 --i-scenes 8 --hw 240 320 --seed 3] [--device cuda]

`--device cpu` warps with the numpy version; any other device with the
compiled host code (built with the CUDA kernels). Evaluate weights on the
set with `python -m yolopoint_tpu_torch.evaluation.hpatches_runner --data
<out> --weights <run dir or file>`.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _translate(tx: float, ty: float) -> np.ndarray:
    T = np.eye(3)
    T[0, 2], T[1, 2] = tx, ty
    return T


def photometric(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """An illumination change: gain and bias, a directional shade, noise.
    The JAX tool's arithmetic under numpy 2's promotion rules, with each
    promotion written out, so numpy 1 gives the same bytes."""
    out = img.astype(np.float32)
    out = out * np.float32(rng.uniform(0.6, 1.4)) + np.float32(rng.uniform(-40, 40))
    H, W = img.shape[:2]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32).astype(np.float64)
    ang = rng.uniform(0, 2 * np.pi)
    ramp = (np.cos(ang) * xx / W + np.sin(ang) * yy / H)
    shaded = out.astype(np.float64) * (1.0 + rng.uniform(-0.25, 0.25) * ramp)[..., None]
    shaded = shaded + rng.normal(0, rng.uniform(0, 6), shaded.shape)
    return np.clip(shaded, 0, 255).astype(np.uint8)


def make_scene(rng: np.random.Generator, H: int, W: int, viewpoint: bool,
               n_views: int = 6, warp=None):
    """`(n_views u8 (H, W, 3) images, n_views 3x3 H_1_n)`; `warp` is a
    `warp_perspective_u8` form (default: numpy)."""
    from yolopoint_tpu_torch.data import raster
    from yolopoint_tpu_torch.data.cv_warp import warp_perspective_u8
    from yolopoint_tpu_torch.data.synthetic import PRIMITIVES, render_sample
    from yolopoint_tpu_torch.ops.homography import sample_homography_np

    warp = warp or warp_perspective_u8
    draw_fns = dict(PRIMITIVES)
    big = np.empty((2 * H, 2 * W), np.uint8)
    for ty in (0, 1):
        for tx in (0, 1):
            tile, _, _ = render_sample(rng, H, W, None, blur_prob=0.0)
            names = rng.choice([n for n, _ in PRIMITIVES], size=2, replace=False)
            for name in names:
                draw_fns[str(name)](rng, tile)
            if rng.random() < 0.3:
                tile = raster.gaussian_blur(tile, 3)
            big[ty * H:(ty + 1) * H, tx * W:(tx + 1) * W] = tile
    big3 = np.repeat(big[..., None], 3, axis=2)
    cy, cx = H // 2, W // 2
    img1 = big3[cy:cy + H, cx:cx + W].copy()
    views, homs = [img1], [np.eye(3)]
    for _ in range(n_views - 1):
        if viewpoint:
            # A maps warped-frame pixels to img1-frame pixels; H_1_n = A^-1
            A = sample_homography_np(
                (H, W), perspective=True, scaling=True, rotation=True,
                translation=True, patch_ratio=0.85,
                perspective_amplitude_x=0.15, perspective_amplitude_y=0.15,
                scaling_amplitude=0.15, max_angle=0.6,
                seed=int(rng.integers(2**31)),
            )
            A = np.asarray(A, np.float64)
            # img_n(q) = img1(A q) = big(A q + c): the warp's M = (T_c A)^-1
            M = np.linalg.inv(_translate(cx, cy) @ A)
            img_n = warp(big3, M, (W, H))
            H_1_n = np.linalg.inv(A)
            H_1_n /= H_1_n[2, 2]
        else:
            img_n = photometric(rng, img1)
            H_1_n = np.eye(3)
        views.append(img_n)
        homs.append(H_1_n)
    return views, homs


def homography_text(Hm: np.ndarray) -> str:
    """An `H_1_n` file's text."""
    return "\n".join(" ".join(f"{v:.10g}" for v in row) for row in Hm)


def main(argv=None):
    from yolopoint_tpu_torch.data.cv_warp import cv_warp_for
    from yolopoint_tpu_torch.data.netpbm import write_ppm

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="datasets/hpatches_synth")
    ap.add_argument("--scenes", type=int, default=16, help="viewpoint scenes")
    ap.add_argument("--i-scenes", type=int, default=8, help="illumination scenes")
    ap.add_argument("--hw", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cpu: numpy warps; else the compiled host code")
    args = ap.parse_args(argv)

    warp = cv_warp_for(args.device).perspective
    H, W = args.hw
    root = Path(args.out)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    jobs = [("v", i) for i in range(args.scenes)] + \
           [("i", i) for i in range(args.i_scenes)]
    for kind, i in jobs:
        scene = root / f"{kind}_synth{i:03d}"
        scene.mkdir(exist_ok=True)
        views, homs = make_scene(rng, H, W, viewpoint=(kind == "v"), warp=warp)
        for n, (img, Hm) in enumerate(zip(views, homs), start=1):
            write_ppm(scene / f"{n}.ppm", img)
            if n > 1:
                (scene / f"H_1_{n}").write_text(homography_text(Hm))
    print(f"wrote {len(jobs)} scenes x 6 views -> {root}")


if __name__ == "__main__":
    main()
