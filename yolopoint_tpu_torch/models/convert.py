"""Weight bridge from the JAX package, and conv + BN folding.

`jax_variables_to_state_dict` takes the JAX package's `{'params',
'batch_stats'}` variable tree as nested dicts of numpy arrays (the caller
does the `jax.device_get`; nothing here imports JAX) and returns this
package's `state_dict`. The mapping follows the shared module names:
`m_0` -> `m.0`, conv `kernel` HWIO -> `weight` OIHW, BN `scale` -> `weight`,
`mean`/`var` -> `running_mean`/`running_var`.

`fold_batch_norm` is the counterpart of `yolopoint_tpu/models/convert.py:
fold_batch_norm`, on a state dict: every `<p>.conv` + `<p>.bn` pair becomes
a biased `<p>.conv`, for a model built with `fused=True`.
"""

from __future__ import annotations

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
