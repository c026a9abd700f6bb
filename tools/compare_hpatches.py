"""Run the HPatches protocol with both packages on the same checkpoint and
pairs, on the CPU, and print one metrics line each.

    python tools/compare_hpatches.py --weights <converted checkpoint> \\
        [--data datasets/hpatches_synth] [--size 256 320] [--max-pairs N] [--f32]

`--weights` is a reference-schema torch file (convert a JAX run with
`tools/jax_checkpoint_to_torch.py`); the JAX package reads it with its own
`load_weights`, the port with its. Lines:
  jax_cv2     the JAX runner as its CLI runs (homographies by
              `cv2.findHomography`, where OpenCV is installed);
  jax_numpy   the JAX runner with `cv2` hidden (its numpy RANSAC);
  port        the port's runner on the CPU (always the numpy RANSAC).
`jax_numpy` and `port` compute the same protocol; `jax_cv2` differs in the
homography estimate only. Needs JAX and OpenCV (the JAX loader reads with
`cv2`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def jax_pipeline(weights: str, f32: bool):
    import jax.numpy as jnp

    from yolopoint_tpu.frontend.pipeline import InferencePipeline
    from yolopoint_tpu.models import build_model
    from yolopoint_tpu.models.convert import fold_batch_norm, load_weights

    loaded = load_weights(weights)
    meta, variables = loaded["meta"], loaded["variables"]
    name, version = meta.get("model_name", "YOLOPoint"), meta.get("version", "n")
    nc = max(len(meta.get("names") or []), 1)
    if f32:
        return InferencePipeline(build_model(name, version, nc=nc), variables,
                                 {"detection_threshold": 0.015})
    model = build_model(name, version, nc=nc, dtype=jnp.bfloat16, fused=True)
    return InferencePipeline(model, fold_batch_norm(variables), {"detection_threshold": 0.015},
                             compute_dtype=jnp.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--data", default="datasets/hpatches_synth")
    ap.add_argument("--size", type=int, nargs=2, default=[256, 320])
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--f32", action="store_true", help="the f32 models (default: fused bf16)")
    args = ap.parse_args(argv)

    from yolopoint_tpu.data.datasets import HPatches as JaxHPatches
    from yolopoint_tpu.evaluation.hpatches_runner import evaluate_hpatches as jax_evaluate
    from yolopoint_tpu_torch.data.datasets import HPatches
    from yolopoint_tpu_torch.evaluation.hpatches_runner import build_pipeline, evaluate_hpatches

    size = tuple(args.size)
    jax_pipe = jax_pipeline(args.weights, args.f32)
    jax_data = JaxHPatches(args.data, size_hw=size)
    n = len(jax_data) if args.max_pairs is None else min(args.max_pairs, len(jax_data))
    jax_pairs = [jax_data[i] for i in range(n)]  # read with cv2 before it is hidden
    port_pipe = build_pipeline(args.weights, f32=args.f32, device="cpu")
    port_data = HPatches(args.data, size_hw=size)

    runs = {}
    t0 = time.perf_counter()
    runs["jax_cv2"] = jax_evaluate(jax_pipe, jax_pairs)
    sys.modules["cv2"] = None  # `import cv2` raises: the JAX runner's numpy RANSAC
    runs["jax_numpy"] = jax_evaluate(jax_pipe, jax_pairs)
    runs["port"] = evaluate_hpatches(port_pipe, port_data, max_pairs=n)
    for name, metrics in runs.items():
        print(json.dumps({"run": name, "size": list(size), "f32": args.f32, **metrics}))
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
