"""Materialize the on-the-fly synthetic-shapes dataset to disk, as the JAX
package's `tools/make_synthetic_dataset.py` does, without `cv2`: the layout
`data.datasets.ImagePointBoxDataset` reads,
`<out>/images/<split>/*.png`, `labels/<split>/*.txt` (YOLO boxes: class,
centre x and y, width, height, normalized) and `points/<split>/*.npz`
(`pts`, the exact corners).

  python -m yolopoint_tpu_torch.tools.synthetic_dataset --out datasets/synth --n 256 \
      [--val 64] [--hw 256 320] [--seed 17]

The images are `data.synthetic.SyntheticShapes`'s renders (equal to the JAX
renderer's), written by `data.png.write_png` (the same pixels as
`cv2.imwrite`; the zlib stream is the port's own).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def materialize(out: Path, split: str, n: int, hw, seed: int) -> None:
    from yolopoint_tpu_torch.data.png import write_png
    from yolopoint_tpu_torch.data.synthetic import SyntheticShapes

    ds = SyntheticShapes(
        {"preprocessing": {"resize": list(hw)},
         "length": {split: n},
         "generation": {"seed": seed, "cache": False}},
        split,
    )
    img_dir = out / "images" / split
    lbl_dir = out / "labels" / split
    pts_dir = out / "points" / split
    for d in (img_dir, lbl_dir, pts_dir):
        d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        s = ds.get(i)
        name = s["name"]
        write_png(img_dir / f"{name}.png", s["image"][..., ::-1])
        with open(lbl_dir / f"{name}.txt", "w") as f:
            for cls, cx, cy, w, h in s["boxes"]:
                f.write(f"{int(cls)} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}\n")
        np.savez_compressed(pts_dir / f"{name}.npz", pts=s["points"])
    print(f"{split}: {n} samples -> {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="datasets/synth")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--val", type=int, default=64)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 320])
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    out = Path(args.out)
    materialize(out, "train", args.n, args.hw, args.seed)
    if args.val:
        materialize(out, "val", args.val, args.hw, args.seed)


if __name__ == "__main__":
    main()
