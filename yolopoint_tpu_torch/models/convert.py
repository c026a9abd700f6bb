"""Weight bridge from the JAX package, and conv + BN folding.

`jax_variables_to_state_dict` takes the JAX package's `{'params',
'batch_stats'}` variable tree as nested dicts of numpy arrays (the caller
does the `jax.device_get`; nothing here imports JAX) and returns this
package's `state_dict`. The mapping follows the shared module names:
`m_0` -> `m.0`, conv `kernel` HWIO -> `weight` OIHW, `Dense` kernel (in,
out) -> `weight` (out, in), attention kernels `(C, heads, head_dim)` /
`(heads, head_dim, C)` -> `weight` with the heads folded, BN `scale` ->
`weight`, `mean`/`var` -> `running_mean`/`running_var`.

`merge_partial_variables` (the class-aware partial load) and
`transplant_yolo_backbone` are the counterparts of the JAX package's, over
state dicts.

`fold_batch_norm` is the counterpart of `yolopoint_tpu/models/convert.py:
fold_batch_norm`, on a state dict: every `<p>.conv` + `<p>.bn` pair becomes
a biased `<p>.conv`, for a model built with `fused=True`; convolutions
without a BN (`SuperPointNet`'s) are left as they are.

Checkpoints cross in the reference schema, the one the JAX package reads
and writes with `torch_state_dict_to_variables` and
`variables_to_torch_state_dict`: names under `model.`, conv weights OIHW, BN
`weight`/`bias`/`running_mean`/`running_var`, the buffers `anchors`,
`anchor_grid`, `stride` and `num_batches_tracked` absent or ignored; a file
holds `{"model_state_dict", "names", "version", "model_name", ...}` or a
bare state dict (`load_torch_checkpoint`, `load_weights`). The port's names
are the reference's without the `model.` prefix. `load_weights` also reads
the port's own training runs (`training/checkpoint.py`) and the JAX
package's orbax runs and checkpoints (`training/orbax_read.py`, no JAX
needed).
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
                if arr.ndim == 4:  # conv HWIO -> OIHW
                    w = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
                    w = arr.T
                elif arr.ndim == 3 and path[-1] == "out":  # attention (heads, hd, C)
                    w = arr.reshape(-1, arr.shape[-1]).T
                elif arr.ndim == 3:  # attention query/key/value (C, heads, hd)
                    w = arr.reshape(arr.shape[0], -1).T
                else:
                    raise ValueError(f"unexpected kernel rank {arr.ndim} at {path}")
                out[_torch_name(path + ["weight"])] = torch.from_numpy(np.ascontiguousarray(w))
            elif k in ("scale", "bias"):
                leaf = "weight" if k == "scale" else "bias"
                # attention biases are (heads, hd)
                out[_torch_name(path + [leaf])] = torch.from_numpy(arr.reshape(-1).copy())
            else:
                raise ValueError(f"unhandled leaf {k!r} at {path}")

    walk(tree["params"], [], False)
    walk(tree.get("batch_stats", {}), [], True)
    return out


def _folded_prefixes(state_dict: Mapping[str, Any]) -> list[str]:
    """Every `<p>` with both a `<p>.bn` and a `<p>.conv`: the pairs to fold."""
    return [k[: -len(".bn.running_var")] for k in state_dict
            if k.endswith(".bn.running_var")
            and k[: -len("bn.running_var")] + "conv.weight" in state_dict]


def fold_batch_norm(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold each `<p>.bn` into its sibling `<p>.conv` (computed in f64). A BN
    without a sibling conv, and every other entry, stays as it is."""
    pairs = _folded_prefixes(state_dict)
    folded = tuple(p + ".bn." for p in pairs)
    out: dict[str, torch.Tensor] = {k: v for k, v in state_dict.items()
                                    if not k.startswith(folded)}
    for p in pairs:
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
    """True for a state dict with no BatchNorm left to fold into its conv: it
    loads into a model built with `fused=True` (also true of a network
    without BatchNorm, `SuperPointNet`)."""
    return not _folded_prefixes(state_dict)


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


def load_weights(path: str | Path, device: str | torch.device | None = None) -> dict:
    """The weights loader of the port's entry points. Reads
      * a reference-schema checkpoint file (`load_torch_checkpoint`), with
        unfolded or folded BN (`is_folded`);
      * the directory of a training run of the port, as the JAX package's
        loader reads its own runs: its `best.pt` (else its newest
        `ckpts/<step>.pt`; or a `ckpts` directory's newest), the EMA
        shadow preferred (`load_run_variables`),
        with its `best_meta.json` (names, version, model name) as the meta;
      * an orbax run or checkpoint directory of the JAX package (a run, its
        `best/`, or a `ckpts/<step>`), as the JAX package's `load_weights`
        reads it: the EMA shadow preferred (`training.orbax_read.
        load_jax_run_variables`), the meta from `best_meta.json` in the
        directory or its parent. Its frames are decoded as a run on `device`
        decodes them (`resolve_device`: the GPU unless the CPU is asked for):
        compiled host code on the GPU, Python on the CPU.
    Any other directory raises, naming what it looked for. Returns
    `{"state_dict": CPU tensors, "meta": {...}}`."""
    import json

    p = Path(path)
    if not p.is_dir():
        return load_torch_checkpoint(p)
    ckpts = p if p.name == "ckpts" else p / "ckpts"
    if (p / "best.pt").exists() or any(ckpts.glob("*.pt")):
        from yolopoint_tpu_torch.training.checkpoint import load_run_variables

        meta = p / "best_meta.json"
        return {"state_dict": load_run_variables(p),
                "meta": json.loads(meta.read_text()) if meta.exists() else {}}
    from yolopoint_tpu_torch.training import orbax_read
    from yolopoint_tpu_torch.utils.device import resolve_device

    try:
        orbax_read.resolve_checkpoint(p)
    except FileNotFoundError as e:
        raise ValueError(
            f"{p} is neither a run of the port (best.pt, ckpts/<step>.pt) nor an orbax "
            f"checkpoint of the JAX package: {e}") from None
    variables = orbax_read.load_jax_run_variables(p, device=resolve_device(device))
    meta = {}
    for mp in (p / "best_meta.json", p.parent / "best_meta.json"):
        if mp.exists():
            meta = json.loads(mp.read_text())
            break
    return {"state_dict": jax_variables_to_state_dict(variables), "meta": meta}


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


_STAT_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def _jax_leaf(name: str) -> str:
    """The last component of the JAX package's torch-style tail for a port
    parameter: torch names under `conv` and `bn`, the Flax leaf name
    (`kernel`, `scale`) for a `weight` anywhere else."""
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] not in ("conv", "bn"):
        return "kernel"
    return parts[-1]


def transplant_yolo_backbone(yolo_state_dict: Mapping[str, Any],
                             target_state_dict: Mapping[str, torch.Tensor],
                             module_order=None, verbose: bool = False
                             ) -> tuple[dict[str, torch.Tensor], int]:
    """Copy a pretrained, numerically indexed (ultralytics-style) YOLO state
    dict into a model's state dict: both tensor sequences are zipped in
    torch declaration order (`training.state.iter_params_reference_order`,
    each BN's running statistics after its bias) and copied while the leaf
    names and shapes line up, stopping at the first divergence. As in the
    JAX package, the comparison is on its leaf names, so a `weight` outside
    a `conv` / `bn` module (a plain convolution: `ConvDet`, the Detect
    convolutions) ends the transplant.

    Returns `(new_state_dict, number_of_copied_tensors)`."""
    from yolopoint_tpu_torch.training.state import iter_params_reference_order

    params = [k for k in target_state_dict if not k.endswith(_STAT_SUFFIXES)]
    ours: list[str] = []
    for name in iter_params_reference_order(params, module_order):
        ours.append(name)
        if name.endswith(".bn.bias"):  # torch: running stats follow the bias
            base = name[: -len("bias")]
            ours += [base + s for s in ("running_mean", "running_var")
                     if base + s in target_state_dict]
    theirs = [(k, v) for k, v in yolo_state_dict.items() if not k.endswith(_SKIP_SUFFIXES)]

    out = dict(target_state_dict)
    copied = 0
    for name, (tk, tv) in zip(ours, theirs):
        if _jax_leaf(name) != tk.split(".")[-1]:
            break
        arr = torch.as_tensor(tv.detach().cpu() if isinstance(tv, torch.Tensor) else np.asarray(tv))
        if tuple(arr.shape) != tuple(out[name].shape):
            break
        out[name] = arr.to(dtype=out[name].dtype, device=out[name].device).clone()
        copied += 1
        if verbose:
            print(f"transplant: {tk} -> {name}")
    return out, copied
