"""Render a synthetic camera sequence, frame for frame as the JAX package's
`tools/make_synthetic_sequence.py` writes it, without `cv2`: one
synthetic-shapes scene at twice the frame size, viewed through a window that
pans, rotates and zooms along smooth sinusoids, written as numbered grey PNG
frames, the input of the demo and its tracker.

  python -m yolopoint_tpu_torch.tools.synthetic_sequence --out /tmp/seq --frames 48 \
      [--hw 256 320] [--seed 5] [--device cuda]
  python -m yolopoint_tpu_torch.frontend.demo --weights <run dir or file> \
      --input /tmp/seq --save-dir /tmp/seq_out --img-size 320

Each frame is `data.cv_warp.warp_affine_u8` of the scene (OpenCV 5's
`warpAffine` with `WARP_INVERSE_MAP`: nearest, the border reflected), in
numpy for `--device cpu`, else in the compiled host code; the files are
`data.png.write_png`'s (the same pixels as `cv2.imwrite`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def camera(i: int, frames: int, H: int, W: int, ph: np.ndarray) -> np.ndarray:
    """The 2x3 map of frame `i` from output pixels to scene pixels: rotate
    and scale about the output centre, then translate into the scene."""
    t = i / max(frames - 1, 1)
    tx = W / 2 + 0.3 * W * np.sin(2 * np.pi * t + ph[0])
    ty = H / 2 + 0.3 * H * np.sin(2 * np.pi * t + ph[1])
    ang = 0.15 * np.sin(2 * np.pi * t + ph[2])
    zoom = 1.0 + 0.15 * np.sin(2 * np.pi * t + ph[3])
    c, s = np.cos(ang) * zoom, np.sin(ang) * zoom
    cx, cy = W / 2, H / 2
    return np.array([[c, -s, tx + cx - (c * cx - s * cy)],
                     [s, c, ty + cy - (s * cx + c * cy)]], np.float32)


def main(argv=None):
    from yolopoint_tpu_torch.data.cv_warp import cv_warp_for
    from yolopoint_tpu_torch.data.png import write_png
    from yolopoint_tpu_torch.data.synthetic import render_sample

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/synth_seq")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 320])
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cpu: numpy warps; else the compiled host code")
    args = ap.parse_args(argv)

    warp = cv_warp_for(args.device).affine
    H, W = args.hw
    rng = np.random.default_rng(args.seed)
    big, _, _ = render_sample(rng, 2 * H, 2 * W, None, blur_prob=0.0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ph = rng.uniform(0, 2 * np.pi, 4)
    for i in range(args.frames):
        write_png(out / f"{i:06d}.png", warp(big, camera(i, args.frames, H, W, ph), (W, H)))
    print(f"{args.frames} frames -> {out}")


if __name__ == "__main__":
    main()
