#!/usr/bin/env python3
"""Writes `yolopoint_tpu_torch/data/raster_tables.py`: the tables the port's
drawing (`data/raster.py`) and plots (`evaluation/plots.py`) take from the
libraries the JAX package draws with, which the port does not import.

* The text of `cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5,
  color, 1)`. OpenCV 5 draws it with an anti-aliased outline font, glyph by
  glyph at whole-pixel pen positions, each glyph's coverage `a` blended as
  `(dst * (255 - a) + color * a + 127) // 255`. So the table holds, for
  each printable ASCII character, its coverage bitmap (rendered in white on
  black, placed relative to the origin), its advance (the widths of
  `cv2.getTextSize` for one and two copies) and its descent (the
  baseline of `cv2.getTextSize`); the text height of that scale is one
  number. The script checks the table against `cv2.putText` and
  `cv2.getTextSize` on random strings before it writes.
* Matplotlib's `Blues` colour map as 256 RGB bytes (`cmap(i, bytes=True)`)
  and its `tab10` cycle, for the plots.

    python3 tools/make_raster_tables.py [--check]

`--check` compares the committed table with a fresh one and exits 1 where
they differ (a different OpenCV or matplotlib).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import cv2
import matplotlib
import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "yolopoint_tpu_torch" / "data" / "raster_tables.py"
FONT, SCALE = cv2.FONT_HERSHEY_SIMPLEX, 0.5
X0, Y0 = 40, 48


def glyph(c: str) -> tuple:
    img = np.zeros((96, 128), np.uint8)
    cv2.putText(img, c, (X0, Y0), FONT, SCALE, 255, 1)
    (w1, _), descent = cv2.getTextSize(c, FONT, SCALE, 1)
    advance = cv2.getTextSize(c * 2, FONT, SCALE, 1)[0][0] - w1
    ys, xs = np.nonzero(img)
    if not len(ys):
        return advance, descent, 0, 0, 0, 0, ""
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    assert y0 > 0 and x0 > 0 and y1 < 96 and x1 < 128, c
    return (advance, descent, int(y0 - Y0), int(x0 - X0), int(y1 - y0), int(x1 - x0),
            img[y0:y1, x0:x1].tobytes().hex())


def render() -> str:
    height = cv2.getTextSize("A", FONT, SCALE, 1)[0][1]
    glyphs = {code: glyph(chr(code)) for code in range(32, 127)}
    blues = matplotlib.colormaps["Blues"](np.arange(256), bytes=True)[:, :3]
    tab10 = matplotlib.colormaps["tab10"](np.arange(10), bytes=True)[:, :3]
    lines = [
        '"""Tables of the libraries the JAX package draws with, which the port does',
        "not import. Written by `tools/make_raster_tables.py` (read it for how",
        f"each was taken) from OpenCV {cv2.__version__} and matplotlib {matplotlib.__version__}.",
        "",
        "`GLYPHS[code]`: `(advance, descent, dy, dx, h, w, coverage hex)` of each",
        "printable ASCII character of `cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5,",
        "color, 1)`: the h x w coverage bitmap's top-left lies at (dx, dy) from the",
        "pen position. `TEXT_HEIGHT`: the height of `cv2.getTextSize` at that scale.",
        "`BLUES`: matplotlib's `Blues` as 256 RGB bytes; `TAB10`: its `tab10` cycle.",
        '"""',
        "",
        f"TEXT_HEIGHT = {height}",
        "GLYPHS = {",
    ]
    for code, g in glyphs.items():
        head = f"    {code}: ({g[0]}, {g[1]}, {g[2]}, {g[3]}, {g[4]}, {g[5]}, "
        hexs = g[6]
        if len(head) + len(hexs) + 4 <= 99:
            lines.append(f'{head}"{hexs}"),')
        else:
            lines.append(head.rstrip())
            for i in range(0, len(hexs), 88):
                lines.append(f'        "{hexs[i:i + 88]}"')
            lines[-1] += "),"
    lines.append("}")
    for name, table in (("BLUES", blues), ("TAB10", tab10)):
        lines.append(f"{name} = (")
        rows = [f"({r}, {g}, {b})" for r, g, b in table.tolist()]
        for i in range(0, len(rows), 6):
            lines.append("    " + ", ".join(rows[i:i + 6]) + ",")
        lines.append(")")
    return "\n".join(lines) + "\n"


def check_text(table_src: str) -> None:
    """`raster.put_text` / `get_text_size` with this table equal cv2 on
    random strings, positions, backgrounds and colours."""
    sys.path.insert(0, str(REPO))
    from yolopoint_tpu_torch.data import raster

    ns: dict = {}
    exec(table_src, ns)
    raster.GLYPHS, raster.TEXT_HEIGHT = ns["GLYPHS"], ns["TEXT_HEIGHT"]
    rng = np.random.default_rng(0)
    chars = [chr(c) for c in range(32, 127)]
    for _ in range(500):
        text = "".join(rng.choice(chars, int(rng.integers(1, 14))))
        shape = (int(rng.integers(8, 60)), int(rng.integers(8, 160)))
        if rng.random() < 0.5:
            shape += (3,)
        bg = rng.integers(0, 256, shape, dtype=np.uint8)
        org = (int(rng.integers(-20, shape[1])), int(rng.integers(-5, shape[0] + 10)))
        color = tuple(rng.uniform(0, 255, 3).tolist())
        ref = bg.copy()
        cv2.putText(ref, text, org, FONT, SCALE, color, 1)
        out = raster.put_text(bg.copy(), text, org, color)
        assert np.array_equal(ref, out), (text, org, shape)
        assert raster.get_text_size(text) == cv2.getTextSize(text, FONT, SCALE, 1), text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    src = render()
    check_text(src)
    if args.check:
        same = OUT.read_text() == src
        print("raster tables", "match" if same else "DIFFER")
        return 0 if same else 1
    OUT.write_text(src)
    print(f"wrote {OUT.relative_to(REPO)} ({len(src)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
