"""Run the HPatches protocol with both packages on the same checkpoint and
pairs, on the CPU, and print one metrics line each.

    python tools/compare_hpatches.py --weights <converted checkpoint> \\
        [--data datasets/hpatches_synth] [--size 256 320] [--max-pairs N] [--f32]

`--weights` is a reference-schema torch file (convert a JAX run with
`tools/jax_checkpoint_to_torch.py`); the JAX package reads it with its own
`load_weights`, the port with its. Lines:
  jax_cv2     the JAX runner as its CLI runs (homographies by
              `cv2.findHomography`, where OpenCV is installed);
  jax_numpy   the JAX runner with `cv2` hidden (its numpy RANSAC, the
              fallback of a host without OpenCV);
  port        the port's runner on the CPU, whose homographies are
              `cv2.findHomography`'s without OpenCV
              (`evaluation/homography_ransac.py`);
  port_cv2    the port's runner with `cv2.findHomography` itself as its
              estimate: where it differs from `jax_cv2`, the pipelines
              differ (the bf16 paths round apart), not the estimate.
`port` computes what `jax_cv2` computes; `jax_numpy` differs in the
homography estimate only. Needs JAX and OpenCV (the JAX loader reads with
`cv2`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# `tools/profile.py` (the JAX package's profiler) would shadow the standard
# `profile` module, which `torch._dynamo` imports through `cProfile` (the
# port's `torch.library` ops load it): this directory off the path (Python
# puts a script's own directory first)
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
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

    import cv2

    from yolopoint_tpu.data.datasets import HPatches as JaxHPatches
    from yolopoint_tpu_torch.evaluation import descriptor_eval
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
    sys.modules["cv2"] = cv2

    def cv2_estimate(src, dst, thresh=3.0, device="cpu"):
        H, mask = cv2.findHomography(src.astype("float32"), dst.astype("float32"), cv2.RANSAC)
        return H, mask.ravel()

    descriptor_eval.estimate_homography = cv2_estimate
    runs["port_cv2"] = evaluate_hpatches(port_pipe, port_data, max_pairs=n)
    for name, metrics in runs.items():
        print(json.dumps({"run": name, "size": list(size), "f32": args.f32, **metrics}))
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
