"""Ahead-of-time export of the serving pipeline to a self-contained artifact.

Counterpart of `yolopoint_tpu/export/aot.py`, through `torch.export`
instead of StableHLO: `InferencePipeline.decode(forward(images))` is traced
at one fixed `(B, H, W, C)` float32 shape, under `no_grad`, the parameters
baked into the program. The kernels K1/K6, K2 and K3 enter the graph as the
custom ops of `ops/library.py` (`yolopoint::nms_tile_keys` etc.), so the
loaded program launches the hand-written kernels on the card and runs their
plain versions on the CPU. The file keeps the JAX container: a magic of its
own, a `<I` header length, a JSON header (`input_shape`, `input_dtype`,
`config`, `device`), then the `torch.export.save` bytes.

Traced code bakes its device into constants (the index grids of the box
decode, the keypoint NMS's scratch), so an artifact runs on the device type
it was exported on; loading it for another raises and names both, as a JAX
artifact is bound to its `platforms`.

    save_serving_artifact("yps.pt2", model, None, config, batch=1, height=640, width=640)
    serve = load_serving_artifact("yps.pt2")
    out = serve(images)          # {'keypoints': ..., 'boxes': ...}
"""

from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any, Mapping, Optional

import torch

from yolopoint_tpu_torch.utils.device import resolve_device

MAGIC = b"YPTORCH1\n"


class _Serve(torch.nn.Module):
    """The traced function: forward + decode of one batch."""

    def __init__(self, pipe):
        super().__init__()
        self.model = pipe.model
        self.pipe = pipe

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        return self.pipe.decode(self.pipe.forward(images))


def save_serving_artifact(
    path,
    model: torch.nn.Module,
    variables: Optional[Mapping[str, Any]] = None,
    config: Optional[Mapping[str, Any]] = None,
    batch: int = 1,
    height: int = 640,
    width: int = 640,
    channels: int = 3,
    compute_dtype: Optional[torch.dtype] = None,
    device=None,
) -> None:
    """Trace the `InferencePipeline` at a fixed shape and write it to `path`.

    `model` holds its weights, or `variables` (a state dict) is loaded into
    it first. `compute_dtype` defaults to bf16, as the JAX export's; the
    pipeline runs on `device` (default the GPU), which the artifact is then
    bound to."""
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline

    if variables is not None:
        model.load_state_dict(variables)
    pipe = InferencePipeline(model, config, compute_dtype=compute_dtype or torch.bfloat16,
                             device=device)
    example = torch.zeros((batch, height, width, channels), dtype=torch.float32,
                          device=pipe.device)
    with torch.no_grad():
        program = torch.export.export(_Serve(pipe), (example,))
    program.example_inputs = None  # the trace's zeros: B * H * W * C floats the file need not hold
    blob = io.BytesIO()
    torch.export.save(program, blob)
    header = json.dumps({
        "input_shape": [batch, height, width, channels],
        "input_dtype": "float32",
        "config": dict(config or {}),
        "device": pipe.device.type,
    }).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(blob.getvalue())


class ServingModule:
    """A loaded serving artifact: `module(images) -> dict of tensors` on the
    artifact's device."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self._module = program.module()
        self.meta = meta
        self.device = device
        self.input_shape = tuple(meta["input_shape"])

    def __call__(self, images) -> dict[str, torch.Tensor]:
        x = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.no_grad():
            return self._module(x)


def load_serving_artifact(path, device=None) -> ServingModule:
    """Read an artifact of `save_serving_artifact`. `device` (default the
    GPU) must be of the type the artifact was exported on."""
    import yolopoint_tpu_torch.ops.library  # noqa: F401  (registers the ops the graph calls)

    raw = Path(path).read_bytes()
    if not raw.startswith(MAGIC):
        raise ValueError(f"{path}: not a yolopoint_tpu_torch serving artifact")
    off = len(MAGIC)
    (hlen,) = struct.unpack_from("<I", raw, off)
    off += 4
    meta = json.loads(raw[off:off + hlen].decode())
    dev = resolve_device(device)
    if dev.type != meta["device"]:
        raise ValueError(f"{path}: exported on {meta['device']}, cannot run on {dev.type}: "
                         f"export it again on {dev.type}")
    program = torch.export.load(io.BytesIO(raw[off + hlen:]))
    return ServingModule(program, meta, dev)
