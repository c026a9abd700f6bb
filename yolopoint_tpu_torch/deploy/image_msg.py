"""`sensor_msgs/Image` decoded by hand: what `cv_bridge.CvBridge().
imgmsg_to_cv2(msg, "bgr8")` returns, without cv_bridge or OpenCV.

A message holds `height` rows of `step` bytes (a row's pixels, then any
padding) in `data` (`bytes`, or a sequence of uint8). The 8-bit encodings
are converted to BGR as cv_bridge converts them with `cv2.cvtColor`:
`bgr8` as it is, `rgb8` reversed (`RGB2BGR`), `bgra8` and `rgba8` without
their alpha (`BGRA2BGR`, `RGBA2BGR`), `mono8` repeated (`GRAY2BGR`). Any
other encoding (16-bit, float, Bayer, YUV) raises `ValueError` naming it.
"""

from __future__ import annotations

import numpy as np

# encoding -> (channels, the slice of a pixel's channels that gives B, G, R)
ENCODINGS = {"bgr8": (3, slice(0, 3)), "rgb8": (3, slice(2, None, -1)),
             "bgra8": (4, slice(0, 3)), "rgba8": (4, slice(2, None, -1)),
             "mono8": (1, slice(0, 1))}


def imgmsg_to_bgr8(msg) -> np.ndarray:
    """uint8 `(height, width, 3)` BGR image of a `sensor_msgs/Image`."""
    encoding = str(msg.encoding)
    if encoding not in ENCODINGS:
        raise ValueError(f"image encoding {encoding!r} is not decoded "
                         f"(read are {', '.join(ENCODINGS)})")
    channels, order = ENCODINGS[encoding]
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    if h <= 0 or w <= 0 or step < w * channels:
        raise ValueError(f"bad {encoding} image: {w}x{h}, step {step}")
    data = msg.data
    buf = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.asarray(data, np.uint8).reshape(-1)
    if buf.size < step * (h - 1) + w * channels:
        raise ValueError(f"{encoding} image of {w}x{h}, step {step}: {buf.size} bytes of data")
    rows = np.lib.stride_tricks.as_strided(buf, (h, w, channels), (step, channels, 1))
    if channels == 1:
        return np.repeat(rows, 3, axis=2)
    return np.array(rows[..., order], order="C")  # a copy: the message keeps its bytes
