#!/usr/bin/env python3
"""Writes the JPEG fixtures of the port's multi-scan decoder under
`tests/data/` and `tests/data/jpeg_fixtures.json`: for each file the
SHA-256 of the pixels `cv2.imread` gives in colour (`IMREAD_COLOR`) and in
grey (`IMREAD_GRAYSCALE`), C-ordered uint8, with their shapes.
`chip_smoke.py` holds the compiled decoder to these hashes on the card,
whose machine has no OpenCV; `tests/test_torch_jpeg.py` holds the numpy
decoder to them here.

The files: progressive (`cv2.IMWRITE_JPEG_PROGRESSIVE`) at 4:2:0, at 4:4:4
with a restart interval, in grey, and optimized at 4:2:2; a progressive
file cut inside its last scan (no block smoothing), inside its third scan
and after its DC scan (libjpeg-turbo smooths the blocks); a sequential
file cut inside a Huffman code (the garbage block's samples saturate as in
libjpeg-turbo's SIMD IDCT); and sequential files of several scans written by
`chip_smoke.encode_jpeg(scans=...)` (one scan a component; Y then Cb and
Cr with restarts).

    python3 tools/make_image_fixtures.py [--check]

`--check` compares the committed files and hashes with fresh ones (the
cv2 files and `cv2.imread`) and exits 1 where they differ.
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
OUT = REPO / "tests" / "data"
INDEX = OUT / "jpeg_fixtures.json"


def frame(seed: int, H: int, W: int) -> np.ndarray:
    """A smooth seeded colour frame (blurred noise over a few rectangles)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
        img[y:y + int(rng.integers(8, H // 2)), x:x + int(rng.integers(8, W // 2))] = \
            rng.integers(0, 256, 3)
    return cv2.GaussianBlur(img, (5, 5), 1.2)


def fixtures() -> dict[str, bytes]:
    from chip_smoke import encode_jpeg

    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    sampling = cv2.IMWRITE_JPEG_SAMPLING_FACTOR

    def enc(img, *params) -> bytes:
        ok, buf = cv2.imencode(".jpg", img, list(params))
        assert ok
        return buf.tobytes()

    last = enc(frame(5, 96, 128), *prog)
    scans = [i for i in range(len(last) - 1) if last[i:i + 2] == b"\xff\xda"]
    small = cv2.GaussianBlur(np.random.default_rng(0).integers(0, 256, (15, 17, 3))
                             .astype(np.uint8), (5, 5), 1.5)
    return {
        "progressive_420.jpg": enc(frame(1, 120, 160), *prog),
        "progressive_444_restart3.jpg": enc(frame(2, 96, 128), *prog, sampling,
                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                                            cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
        "progressive_grey.jpg": enc(frame(3, 100, 140)[..., 1], *prog),
        "progressive_422_optimized_q60.jpg": enc(frame(4, 90, 136), *prog, sampling,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                                                 cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                 cv2.IMWRITE_JPEG_QUALITY, 60),
        # cut halfway through the last scan's data: no block smoothing
        "progressive_cut_last_scan.jpg": last[:(scans[-1] + len(last)) // 2],
        # cut halfway through the third scan: libjpeg-turbo's block smoothing,
        # the rows past the cut on the bits before that scan
        "progressive_cut_third_scan.jpg": last[:(scans[2] + scans[3]) // 2],
        # the DC scan alone, then EOI: the DC smoothed too
        "progressive_dc_only.jpg": last[:scans[1]] + b"\xff\xd9",
        # cut inside a Huffman code of a restart segment: the block it splits
        # decodes to garbage whose samples pass +-512 and saturate (the SIMD IDCT)
        "sequential_cut_in_code.jpg": encode_jpeg(small, 90, "422", 1)[:755],
        "multiscan_y_cb_cr.jpg": encode_jpeg(frame(6, 120, 160), 90, "420",
                                             scans=((0,), (1,), (2,))),
        "multiscan_y_cbcr_restart2.jpg": encode_jpeg(frame(7, 72, 104), 90, "422", 2,
                                                     scans=((0,), (1, 2))),
    }


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def index_of(names) -> dict:
    """The hashes of `cv2.imread` of the files under `OUT` (`imread`, not
    `imdecode`: OpenCV's memory source refuses a file cut short, its file
    source reads on fake EOI markers)."""
    out = {}
    for name in names:
        path = OUT / name
        colour = cv2.imread(str(path), cv2.IMREAD_COLOR)
        grey = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        out[name] = {"bytes": path.stat().st_size, "shape": list(colour.shape),
                     "colour_sha256": digest(colour), "grey_sha256": digest(grey)}
    return {"opencv": cv2.__version__, "files": out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    files = fixtures()
    if args.check:
        want = json.loads(INDEX.read_text())
        bad = [n for n, d in files.items() if (OUT / n).read_bytes() != d]
        got = index_of(want["files"])
        bad += [n for n in want["files"] if got["files"][n] != want["files"][n]]
        for n in bad:
            print(f"differs: {n}")
        return 1 if bad else 0
    OUT.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        assert len(data) <= 20_000, (name, len(data))
    INDEX.write_text(json.dumps(index_of(files), indent=1) + "\n")
    print(f"wrote {len(files)} files and {INDEX.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
