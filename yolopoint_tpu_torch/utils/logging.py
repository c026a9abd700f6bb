"""Logging: the package logger, a scalar metrics writer and a step timer.

Counterpart of `LOGGER`, `MetricsWriter` and `StepTimer` of
`yolopoint_tpu/utils/logging.py`. Metrics land in an append-only
`metrics.jsonl` with the JAX package's record schema: one JSON object per
line with `step`, `time` (seconds since the epoch) and the scalars under
their prefixed keys (`training/loss`, `validation/fitness`, ...). There is
no TensorBoard mirror: the machine that runs the port has no `tensorboard`.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Mapping, Optional


def make_logger(name: str = "yolopoint_tpu_torch", verbose: bool = True) -> logging.Logger:
    """A logger that writes `time level message` lines to stderr."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(logging.INFO if verbose else logging.ERROR)
    return logger


LOGGER = make_logger()


class MetricsWriter:
    """Append-only JSONL scalar stream (`<output_dir>/metrics.jsonl`)."""

    def __init__(self, output_dir: str | Path):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a", buffering=1)

    def write(self, step: int, scalars: Mapping[str, Any], prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Rolling step time over the last `window` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
