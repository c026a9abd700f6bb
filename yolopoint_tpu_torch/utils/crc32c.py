"""CRC-32C (Castagnoli), the checksum that ends every OCDBT manifest and
B-tree node of an orbax checkpoint (`training/orbax_read.py`).

`crc32c(data)` is the plain version (a table a byte), for a run on the CPU
and for the tests; `crc32c_compiled(data)` is `yp_crc32c` of the compiled
host code (`ops/csrc/host_zstd.cpp`), for a run on the GPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

POLY = 0x82F63B78  # the reflected Castagnoli polynomial


def _table() -> tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        table.append(c)
    return tuple(table)


TABLE = _table()


def crc32c(data: bytes) -> int:
    """The CRC-32C of `data`."""
    crc = 0xFFFFFFFF
    table = TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c_compiled(data: bytes, lib: Optional[ctypes.CDLL] = None) -> int:
    """`crc32c(data)` by the compiled host code (`lib`, by default the
    kernel library, built if it must be)."""
    if lib is None:
        from yolopoint_tpu_torch.ops import _build

        lib = _build.library()
    buf = np.frombuffer(bytes(data), np.uint8)
    out = ctypes.c_uint32(0)
    lib.yp_crc32c(ctypes.c_void_p(buf.ctypes.data), buf.size, ctypes.byref(out))
    return out.value
