"""FFmpeg's `simple_idct` for 8-bit samples, as the video decoders use it.

`cv2.VideoCapture` decodes MJPEG and MPEG-4 Part 2 frames with FFmpeg, whose
default IDCT for both (`FF_IDCT_AUTO`) is the simple IDCT
(`libavcodec/simple_idct_template.c`, `BIT_DEPTH` 8; its x86 SSE2 form gives
the same integers): a row pass with `W1..W7` = 22725, 21407, 19266, 16383,
12873, 8867, 4520 (cos(i pi / 16) sqrt(2) 2^14, rounded), `ROW_SHIFT` 11 and
the rounding `1 << 10`, whose results are stored to int16 (wrapping), and
whose rows with no AC coefficient take the shortcut `row[0] << 3`; then a
column pass with `COL_SHIFT` 20 and the rounding folded into the DC term,
`W4 * (col[0] + 32)`. That holds while every row's result fits in 16 bits
(the shortcut's `row[0] << 3` too), as it does for the blocks encoders
write from pixels; past that FFmpeg's x86 SIMD IDCT (what cv2 runs) gives
neither the C code's wrapped nor saturated values (found by sweeps over
crafted MJPEG blocks), so a block whose row pass leaves 16 bits raises
`IdctOverflow`, a `NotImplementedError`. `idct_put` saturates the columns' results to 0-255
(`ff_simple_idct_put_int16_8bit`), `idct_add` adds them to a prediction and
saturates the sum (`ff_simple_idct_add_int16_8bit`).

Blocks are `(..., 8, 8)` int16 in natural (row-major) order. The compiled
twin is `simple_idct` in `ops/csrc/host_video.cpp`.
"""

from __future__ import annotations

import numpy as np

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20


class IdctOverflow(NotImplementedError):
    """A block whose IDCT row pass leaves 16 bits."""


def _butterfly(x: list[np.ndarray], a0: np.ndarray) -> list[np.ndarray]:
    """The eight outputs of one 1-D pass before its shift, `a0` the DC term
    with its rounding (the pass's additions in FFmpeg's order: int32 sums of
    these magnitudes are exact in any order)."""
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x[2] + W4 * x[4] + W6 * x[6]
    a1 = a1 + W6 * x[2] - W4 * x[4] - W2 * x[6]
    a2 = a2 - W6 * x[2] - W4 * x[4] + W2 * x[6]
    a3 = a3 - W2 * x[2] + W4 * x[4] - W6 * x[6]
    b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
    b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
    b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
    b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
    return [a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0]


def idct_rows(blocks: np.ndarray) -> np.ndarray:
    """The row pass (`idctRowCondDC`): int16 in, int16 out; raises
    `IdctOverflow` where a row's result leaves 16 bits."""
    r = blocks.astype(np.int64)
    x = [r[..., k] for k in range(8)]
    out = np.stack(_butterfly(x, W4 * x[0] + (1 << (ROW_SHIFT - 1))), -1) >> ROW_SHIFT
    dc_only = ~np.any(r[..., 1:] != 0, axis=-1, keepdims=True)
    out = np.where(dc_only, r[..., :1] << 3, out)
    if out.size and (out.min() < -32768 or out.max() > 32767):
        raise IdctOverflow("a block whose IDCT row pass leaves 16 bits: FFmpeg's x86 SIMD "
                           "IDCT is not reproduced there")
    return out.astype(np.int16)


def idct_residual(blocks: np.ndarray) -> np.ndarray:
    """Both passes, before the columns' saturation: int32 `(..., 8, 8)`."""
    r = idct_rows(blocks).astype(np.int32)
    x = [r[..., k, :] for k in range(8)]
    return np.stack(_butterfly(x, W4 * (x[0] + ((1 << (COL_SHIFT - 1)) // W4))), -2) >> COL_SHIFT


def idct_put(blocks: np.ndarray) -> np.ndarray:
    """uint8 samples of dequantized blocks."""
    return np.clip(idct_residual(blocks), 0, 255).astype(np.uint8)


def idct_add(blocks: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """uint8 `pred + residual`, saturated."""
    return np.clip(pred.astype(np.int32) + idct_residual(blocks), 0, 255).astype(np.uint8)


def blocks_to_plane(blocks: np.ndarray) -> np.ndarray:
    """`(rows, cols, 8, 8)` blocks as one `(rows * 8, cols * 8)` plane."""
    r, c = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8)

