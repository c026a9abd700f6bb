"""Host-side image reading, the dataset factory and the HPatches sequences,
without OpenCV.

Counterpart of `_imread`, `build_dataset` and `HPatches` in
`yolopoint_tpu/data/datasets.py`. `build_dataset` builds the synthetic-shapes
dataset (`data/synthetic.py`); the image-file datasets (COCO, KITTI, Campus
and the generic image/label folders) read JPEG and PNG files, which the
machine that runs the port cannot decode, so they raise.
`_imread` reads binary PPM and PGM files (`P6` / `P5`, maxval 255), the
format of HPatches-layout sequences, and returns what `cv2.imread(path,
cv2.IMREAD_COLOR)` returns: uint8 `(H, W, 3)` in BGR order, a grey image
repeated to three channels. Any other format raises. `HPatches` resizes
with `ops.resize` (OpenCV's `INTER_LINEAR` / `INTER_AREA` in torch).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from yolopoint_tpu_torch.ops.resize import resize_like_cv2


def _header_tokens(data: bytes, count: int) -> tuple[list[bytes], int]:
    """The first `count` whitespace-separated header tokens of a netpbm file
    (`#` comments skipped) and the offset just past the one whitespace byte
    that ends the last of them."""
    tokens, i, n = [], 0, len(data)
    while len(tokens) < count:
        while i < n and data[i:i + 1].isspace():
            i += 1
        if i < n and data[i:i + 1] == b"#":
            while i < n and data[i:i + 1] not in (b"\n", b"\r"):
                i += 1
            continue
        start = i
        while i < n and not data[i:i + 1].isspace():
            i += 1
        if start == i:
            raise ValueError("truncated netpbm header")
        tokens.append(data[start:i])
    return tokens, i + 1


def _imread(path: str) -> np.ndarray:
    """uint8 `(H, W, 3)` BGR image of a binary PPM (`P6`) or PGM (`P5`) file
    with maxval 255, as `cv2.imread(path, cv2.IMREAD_COLOR)` returns it."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(path)
    data = p.read_bytes()
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PPM/PGM file (magic {magic!r})")
    (_, w, h, maxval), offset = _header_tokens(data, 4)
    w, h, maxval = int(w), int(h), int(maxval)
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval} (only 255 is read)")
    channels = 3 if magic == b"P6" else 1
    size = w * h * channels
    if len(data) - offset < size:
        raise ValueError(f"{path}: {len(data) - offset} bytes of pixels, want {size}")
    img = np.frombuffer(data, np.uint8, size, offset).reshape(h, w, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., ::-1])  # RGB in the file, BGR out


SYNTHETIC_NAMES = ("synthetic_shapes", "synthetic")


def build_dataset(config, action="train", names=(), root="datasets", debug=False):
    """The dataset `config["dataset"]` names: `synthetic_shapes` (or
    `synthetic`) gives `SyntheticShapes`; any other name raises
    `NotImplementedError`."""
    name = str(config["dataset"]).lower()
    if name in SYNTHETIC_NAMES:
        from yolopoint_tpu_torch.data.synthetic import SyntheticShapes

        return SyntheticShapes(config, action=action, names=names, root=root, debug=debug)
    raise NotImplementedError(
        f"dataset {name!r}: the image-file datasets (COCO, KITTI, Campus, image folders) read "
        "JPEG/PNG files and need an image decoder, which the machine that runs the port does "
        "not have; they are not ported (ROADMAP.md, Queue 1 item 6). Use dataset: "
        "synthetic_shapes")


class HPatches:
    """HPatches sequences: per pair `(img1, imgN, H_1_N)`, each image resized
    to cover `size_hw` at its aspect ratio and center-cropped, the
    homography adapted to both preprocessings."""

    def __init__(self, root: str | Path, size_hw: tuple[int, int] = (480, 640),
                 alteration: str = "all"):
        self.root = Path(root)
        self.size_hw = size_hw
        self.pairs: list[tuple[Path, Path, Path]] = []
        for scene in sorted(self.root.iterdir()):
            if not scene.is_dir():
                continue
            if alteration != "all" and not scene.name.startswith(alteration):
                continue
            base = scene / "1.ppm"
            for n in range(2, 7):
                img2 = scene / f"{n}.ppm"
                hfile = scene / f"H_1_{n}"
                if base.exists() and img2.exists() and hfile.exists():
                    self.pairs.append((base, img2, hfile))

    def __len__(self) -> int:
        return len(self.pairs)

    def _preprocess(self, img: np.ndarray):
        """Scale so the image covers `size_hw`, then center-crop to it."""
        H, W = self.size_hw
        h0, w0 = img.shape[:2]
        scale = max(H / h0, W / w0)
        size = (int(round(w0 * scale)), int(round(h0 * scale)))
        img = resize_like_cv2(torch.from_numpy(img), size, scale).numpy()
        h, w = img.shape[:2]
        top, left = (h - H) // 2, (w - W) // 2
        return img[top:top + H, left:left + W], scale, (top, left)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        p1, p2, hf = self.pairs[idx]
        i1, s1, (t1, l1) = self._preprocess(_imread(str(p1)))
        i2, s2, (t2, l2) = self._preprocess(_imread(str(p2)))
        H12 = np.array([[float(v) for v in line.split()] for line in
                        Path(hf).read_text().split("\n") if line.strip()])
        # x2 = H @ x1 on the originals; x2' = S2 @ H @ S1^-1 @ x1' with S the
        # scale and the crop's translation
        S1 = np.array([[s1, 0, -l1], [0, s1, -t1], [0, 0, 1.0]])
        S2 = np.array([[s2, 0, -l2], [0, s2, -t2], [0, 0, 1.0]])
        return {
            "image": i1.astype(np.float32) / 255.0,
            "warped_image": i2.astype(np.float32) / 255.0,
            "homography_pix": S2 @ H12 @ np.linalg.inv(S1),
            "name": f"{p1.parent.name}_{p2.stem}",
        }
