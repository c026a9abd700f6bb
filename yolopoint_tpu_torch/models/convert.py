"""Weight bridge from the JAX package, and conv + BN folding.

`jax_variables_to_state_dict` takes the JAX package's `{'params',
'batch_stats'}` variable tree as nested dicts of numpy arrays (the caller
does the `jax.device_get`; nothing here imports JAX) and returns this
package's `state_dict`. The mapping follows the shared module names:
`m_0` -> `m.0`, conv `kernel` HWIO -> `weight` OIHW, BN `scale` -> `weight`,
`mean`/`var` -> `running_mean`/`running_var`.

`merge_partial_variables` is the class-aware partial load of
`yolopoint_tpu/models/convert.py`, over state dicts.

`fold_batch_norm` is the counterpart of `yolopoint_tpu/models/convert.py:
fold_batch_norm`, on a state dict: every `<p>.conv` + `<p>.bn` pair becomes
a biased `<p>.conv`, for a model built with `fused=True`.

Checkpoints cross in the reference schema, the one the JAX package reads
and writes with `torch_state_dict_to_variables` and
`variables_to_torch_state_dict`: names under `model.`, conv weights OIHW, BN
`weight`/`bias`/`running_mean`/`running_var`, the buffers `anchors`,
`anchor_grid`, `stride` and `num_batches_tracked` absent or ignored; a file
holds `{"model_state_dict", "names", "version", "model_name", ...}` or a
bare state dict (`load_torch_checkpoint`, `load_weights`). The port's names
are the reference's without the `model.` prefix. Orbax run directories are
converted to such a file on a host that has JAX, by
`tools/jax_checkpoint_to_torch.py`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from yolopoint_tpu_torch.models.blocks import BN_EPS


def _torch_name(path: list[str]) -> str:
    parts = []
    for p in path:
        head, _, tail = p.rpartition("_")
        parts.append(f"{head}.{tail}" if head and tail.isdigit() else p)
    return ".".join(parts)


def jax_variables_to_state_dict(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX package's variables (numpy leaves) -> a torch state dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str], stats: bool) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [k], stats)
                continue
            arr = np.asarray(v, dtype=np.float32)
            if stats:
                leaf = {"mean": "running_mean", "var": "running_var"}[k]
                base = _torch_name(path)
                out[f"{base}.{leaf}"] = torch.from_numpy(arr.copy())
                out[f"{base}.num_batches_tracked"] = torch.tensor(0)
            elif k == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"unexpected kernel rank {arr.ndim} at {path}")
                out[_torch_name(path + ["weight"])] = torch.from_numpy(
                    np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
            elif k in ("scale", "bias"):
                leaf = "weight" if k == "scale" else "bias"
                out[_torch_name(path + [leaf])] = torch.from_numpy(arr.copy())
            else:
                raise ValueError(f"unhandled leaf {k!r} at {path}")

    walk(tree["params"], [], False)
    walk(tree.get("batch_stats", {}), [], True)
    return out


def fold_batch_norm(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold each `<p>.bn` into its sibling `<p>.conv` (computed in f64)."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if ".bn." not in key:
            out[key] = value
    for key in state_dict:
        if not key.endswith(".bn.running_var"):
            continue
        p = key[: -len(".bn.running_var")]
        scale = state_dict[f"{p}.bn.weight"].double()
        bias = state_dict[f"{p}.bn.bias"].double()
        mean = state_dict[f"{p}.bn.running_mean"].double()
        var = state_dict[f"{p}.bn.running_var"].double()
        factor = scale / torch.sqrt(var + BN_EPS)
        w = state_dict[f"{p}.conv.weight"].double()
        out[f"{p}.conv.weight"] = (w * factor[:, None, None, None]).float()
        out[f"{p}.conv.bias"] = (bias - mean * factor).float()
    return out


_SKIP_SUFFIXES = ("num_batches_tracked", "anchors", "anchor_grid", "stride")
REFERENCE_PREFIX = "model."


def reference_to_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference-schema state dict (tensors or numpy arrays) -> the port's
    `state_dict`: the `model.` prefix stripped, the buffers dropped, f32
    values, and `num_batches_tracked` (0) beside every BN's statistics so
    that a strict `load_state_dict` takes it."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.endswith(_SKIP_SUFFIXES):
            continue
        name = key[len(REFERENCE_PREFIX):] if key.startswith(REFERENCE_PREFIX) else key
        t = value.detach().cpu() if isinstance(value, torch.Tensor) else torch.from_numpy(
            np.array(value))
        out[name] = t.to(torch.float32).clone()
        if name.endswith(".running_var"):
            out[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def state_dict_to_reference(state_dict: Mapping[str, torch.Tensor],
                            prefix: str = REFERENCE_PREFIX) -> dict[str, torch.Tensor]:
    """The port's `state_dict` -> the reference schema (CPU f32 tensors), as
    `variables_to_torch_state_dict` writes it: `prefix` before every name,
    `num_batches_tracked` dropped."""
    return {prefix + k: v.detach().cpu().to(torch.float32).clone()
            for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}


def is_folded(state_dict: Mapping[str, Any]) -> bool:
    """True for a state dict whose BatchNorms are folded into their convs
    (no `bn` entry): it loads into a model built with `fused=True`."""
    return not any(".bn." in k for k in state_dict)


def load_torch_checkpoint(path: str | Path) -> dict:
    """A reference-schema checkpoint file -> `{"state_dict": the port's
    state dict, "meta": every other entry}`; read with `weights_only=True`
    (tensors, numbers, strings, lists and dicts only)."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
        meta = {k: v for k, v in ckpt.items() if not k.endswith("state_dict")}
    else:
        sd, meta = ckpt, {}
    return {"state_dict": reference_to_state_dict(sd), "meta": meta}


def load_weights(path: str | Path) -> dict:
    """The weights loader of the port's entry points: a reference-schema
    checkpoint file (`load_torch_checkpoint`), with unfolded or folded BN
    (`is_folded`). A directory (an orbax run or checkpoint of the JAX
    package) raises: convert it first with `tools/jax_checkpoint_to_torch.py`
    on a host that has JAX."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory (an orbax checkpoint of the JAX package?); the port reads "
            "reference-schema torch files only: convert it with `python "
            f"tools/jax_checkpoint_to_torch.py --run {p} --out <file>` where JAX is installed")
    return load_torch_checkpoint(p)


def merge_partial_variables(target: Mapping[str, torch.Tensor], source: Mapping[str, Any],
                            verbose: bool = False) -> tuple[dict, dict]:
    """Class-aware partial load over state dicts: every entry of `target`
    whose name is in `source` with the same shape takes the source's value
    (cast to the target's dtype and device); everything else keeps the
    target's. When the class count changes, the Detect convolutions
    mismatch and keep their fresh initialization while the rest loads.

    Returns `(merged, report)`; the report lists names under `loaded`,
    `shape_mismatch`, `missing_in_source` and `unused_in_source`."""
    report = {"loaded": [], "shape_mismatch": [], "missing_in_source": [],
              "unused_in_source": []}
    merged = {}
    for name, tv in target.items():
        sv = source.get(name)
        if sv is None:
            merged[name] = tv
            report["missing_in_source"].append(name)
        elif tuple(np.shape(sv)) == tuple(tv.shape):
            merged[name] = torch.as_tensor(sv).to(device=tv.device, dtype=tv.dtype)
            report["loaded"].append(name)
        else:
            merged[name] = tv
            report["shape_mismatch"].append(name)
    report["unused_in_source"] = [n for n in source if n not in target]
    if verbose:
        for k, v in report.items():
            print(f"merge_partial_variables: {k}: {len(v)}")
    return merged, report
