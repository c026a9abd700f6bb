"""The binary PPM writer, as `cv2.imwrite("x.ppm", img)` writes the file.

OpenCV's PxM encoder writes `P6`, the width and height, maxval 255, each
followed by one newline, then the pixels in RGB order. It takes only
3-channel BGR images (a grey image raises there, and here). The reader is
`data.datasets._read_netpbm`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def encode_ppm(bgr: np.ndarray) -> bytes:
    """The PPM file of a uint8 `(H, W, 3)` BGR image."""
    img = np.asarray(bgr)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_ppm takes a uint8 (H, W, 3) BGR image, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(img[..., ::-1]).tobytes()


def write_ppm(path: str | Path, bgr: np.ndarray) -> None:
    """`cv2.imwrite(path, bgr)` for a `.ppm` path: `encode_ppm`'s bytes."""
    Path(path).write_bytes(encode_ppm(bgr))
