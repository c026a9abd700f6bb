"""Convert a JAX-package checkpoint (an orbax run or checkpoint directory)
into a reference-schema torch file that the PyTorch port and the reference
torch model both load.

    python tools/jax_checkpoint_to_torch.py --run artifacts/<run>/best --out <file.pt>

Runs where JAX is installed: it reads the checkpoint with the JAX package's
`load_weights` (EMA weights where the run saved them), converts the variables
with `variables_to_torch_state_dict`, and saves
`{"model_state_dict": {name: tensor}, "names", "version", "model_name"}`,
the metadata from the run's `best_meta.json`, with `torch.save`. BatchNorm
stays unfolded, as the checkpoint holds it. The output is made at run time
and is not kept in the repository.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

META_KEYS = ("names", "version", "model_name")


def convert(run: str | Path, out: str | Path) -> dict:
    """Write the converted checkpoint of `run` to `out`; returns what was saved."""
    import torch

    from yolopoint_tpu.models.convert import load_weights, variables_to_torch_state_dict

    loaded = load_weights(run)
    state = variables_to_torch_state_dict(loaded["variables"])
    ckpt = {"model_state_dict": {k: torch.from_numpy(np.array(v, np.float32))
                                 for k, v in state.items()}}
    ckpt.update({k: loaded["meta"][k] for k in META_KEYS if k in loaded["meta"]})
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ckpt, out)
    return ckpt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", required=True, help="orbax run, `best` or step directory")
    ap.add_argument("--out", required=True, help="torch file to write")
    args = ap.parse_args(argv)
    ckpt = convert(args.run, args.out)
    meta = {k: v for k, v in ckpt.items() if k != "model_state_dict"}
    print(f"wrote {len(ckpt['model_state_dict'])} tensors to {args.out} ({meta})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
