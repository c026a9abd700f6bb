#!/usr/bin/env python3
"""Writes the video fixtures of the port's video reader under
`tests/data/video/` and `tests/data/video/video_fixtures.json`: for each
file its codec, byte count, frame count and shape, and the SHA-256 of each
frame `cv2.VideoCapture` reads (C-ordered uint8 BGR). `chip_smoke.py`'s
`video` phase holds the compiled decoders and the numpy ones to these
hashes on the card, whose machine has no OpenCV; `tests/test_torch_video.py`
holds the numpy decoders to them on the CPU.

The files (a pan over a gradient canvas with flat shapes moving on it, so
that they stay small): `mp4v_480x640.mp4`, 12 frames that
`cv2.VideoWriter` writes with `mp4v` (lavc's MPEG-4 Part 2: an I-VOP and
P-VOPs); `mjpeg_480x640.avi`, 12 `cv2.imencode` frames at quality 50
(4:2:0) in an AVI; `mjpeg422_240x320.avi`, 6 frames at 4:2:2 (quality 50).

    python3 tools/make_video_fixtures.py [--check]

`--check` compares the committed hashes with `cv2.VideoCapture`'s read of
the committed files and exits 1 where they differ (the files are not
written again: `cv2.VideoWriter`'s bytes may change with its FFmpeg).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "tests" / "data" / "video"
INDEX = OUT / "video_fixtures.json"

from tests.torch_video_files import avi_bytes, read_cv2, write_cv2  # noqa: E402


def scene(height: int, width: int, frames: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height + 8 * frames, 0:width + 8 * frames]
    canvas = np.stack([(xx * 0.25) % 256, (yy * 0.3 + 40) % 256,
                       ((xx + yy) * 0.15 + 90) % 256], -1).astype(np.uint8)
    shapes = [(int(rng.integers(0, width)), int(rng.integers(0, height)),
               int(rng.integers(16, 60)), tuple(int(c) for c in rng.integers(0, 256, 3)))
              for _ in range(10)]
    out = []
    for i in range(frames):
        f = canvas[4 * i:4 * i + height, 6 * i:6 * i + width].copy()
        for k, (x, y, r, c) in enumerate(shapes):
            if k % 2:
                cv2.circle(f, (x - 3 * i, y + 2 * i), r // 2, c, -1)
            else:
                cv2.rectangle(f, (x + 2 * i, y), (x + 2 * i + r, y + r), c, -1)
        out.append(f)
    return out


def mjpeg_avi(path: Path, frames, params) -> None:
    h, w = frames[0].shape[:2]
    path.write_bytes(avi_bytes([cv2.imencode(".jpg", f, params)[1].tobytes() for f in frames],
                               w, h))


FILES = {
    "mp4v_480x640.mp4": ("mpeg4", lambda p: write_cv2(p, "mp4v", scene(480, 640, 12, 0))),
    "mjpeg_480x640.avi": ("mjpeg", lambda p: mjpeg_avi(p, scene(480, 640, 12, 1),
                                                        [cv2.IMWRITE_JPEG_QUALITY, 50])),
    "mjpeg422_240x320.avi": ("mjpeg", lambda p: mjpeg_avi(
        p, scene(240, 320, 6, 2), [cv2.IMWRITE_JPEG_QUALITY, 50,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])),
}


def entry(path: Path, codec: str) -> dict:
    frames = read_cv2(path)
    return {"codec": codec, "bytes": path.stat().st_size, "frames": len(frames),
            "shape": list(frames[0].shape),
            "sha256": [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
                       for f in frames]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args()
    if args.check:
        index = json.loads(INDEX.read_text())
        fresh = {name: entry(OUT / name, FILES[name][0]) for name in FILES}
        bad = [n for n in FILES if fresh[n] != index["files"].get(n)]
        print("video fixtures:", "differ: " + ", ".join(bad) if bad else "match cv2")
        return 1 if bad else 0
    OUT.mkdir(parents=True, exist_ok=True)
    for name, (_, make) in FILES.items():
        make(OUT / name)
    index = {"opencv": cv2.__version__,
             "files": {name: entry(OUT / name, codec) for name, (codec, _) in FILES.items()}}
    INDEX.write_text(json.dumps(index, indent=1) + "\n")
    print(json.dumps({n: (e["bytes"], e["frames"]) for n, e in index["files"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
