"""Write the digests of the arrays orbax restores from the committed JAX
checkpoints, which the port's orbax reader is held to on the card and in
the CPU tests (`yolopoint_tpu_torch/training/orbax_read.py`).

    python tools/make_orbax_digests.py [--check]

For each run in `RUNS` it restores `artifacts/<run>/best` with orbax's
`StandardCheckpointer` and writes, for every array of the tree, its shape,
dtype and the SHA-256 of its bytes in C order to
`tests/torch_orbax_digests.json` (keys joined by dots, as the port's
`orbax_read.array_digests` names them). `--check` compares the file with a
fresh restore instead of writing it. Needs orbax (and JAX); the card's
machine has neither and reads only the file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RUNS = ("synth_s640_pseudo2", "synth_r5_pseudo_ext")
OUT = REPO / "tests" / "torch_orbax_digests.json"


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def orbax_digests(directory: Path) -> dict[str, dict]:
    """`{key: {"shape", "dtype", "sha256"}}` of what orbax restores."""
    import orbax.checkpoint as ocp

    payload = ocp.StandardCheckpointer().restore(directory.resolve())
    out = {}
    for keys, leaf in sorted(_flatten(payload)):
        a = np.asarray(leaf)
        out[".".join(keys)] = {"shape": list(a.shape), "dtype": a.dtype.str,
                               "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="compare instead of writing")
    args = ap.parse_args(argv)
    digests = {run: orbax_digests(REPO / "artifacts" / run / "best") for run in RUNS}
    if args.check:
        same = json.loads(OUT.read_text()) == digests
        print(f"{OUT.relative_to(REPO)}: {'up to date' if same else 'DIFFERS'}")
        return 0 if same else 1
    OUT.write_text(json.dumps(digests, separators=(",", ":"), sort_keys=True) + "\n")
    print(f"wrote {sum(map(len, digests.values()))} digests of {len(RUNS)} runs to "
          f"{OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
