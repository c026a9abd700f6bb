"""HPatches evaluation: repeatability, homography correctness at eps,
matching score and match mAP, in one pass over the pairs.

Counterpart of `yolopoint_tpu/evaluation/hpatches_runner.py`, with the same
metric definitions:
  * repeatability at the top 300 keypoints, 3 px (`compute_repeatability`);
  * homography correctness: the mean error of the 4 warped corners of the
    homography estimated from mutual descriptor matches <= eps, eps in
    {1, 3, 5, 10, 20, 50};
  * matching score 2 * inliers / (N1 + N2);
  * match mAP: the average precision of match confidence (1 - normalized
    descriptor distance) against the RANSAC inlier labels.
Each pair runs through the port's `InferencePipeline` (forward, keypoint NMS
K1 or K6, box NMS K2, descriptor sampling K3, on the GPU by default); the
metrics are the host-side numpy of `evaluation/`, the homographies
`cv2.findHomography(..., cv2.RANSAC)`'s as the JAX runner takes them where
OpenCV is installed (`evaluation/homography_ransac.py`, without OpenCV:
compiled host code on a GPU run, numpy on the CPU).

    python -m yolopoint_tpu_torch.evaluation.hpatches_runner \\
        --data datasets/hpatches_synth --weights artifacts/synth_r5_pseudo_ext \\
        [--size 256 320] [--alteration all|i|v] [--f32] [--device cuda|cpu]

`--weights` takes a reference-schema torch file, a port training run, or
an orbax run or checkpoint directory of the JAX package, as the JAX runner
does (`models.convert.load_weights`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.data.datasets import HPatches
from yolopoint_tpu_torch.evaluation.descriptor_eval import compute_homography_correctness
from yolopoint_tpu_torch.evaluation.detector_eval import compute_repeatability
from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, deploy_model

CORRECTNESS_EPS = (1, 3, 5, 10, 20, 50)


def _normalized_from_pixel_h(H_pix: np.ndarray, shape_hw) -> np.ndarray:
    """Pixel-space H -> the normalized [-1, 1] convention used internally."""
    h, w = shape_hw
    trans = np.array([[2.0 / w, 0, -1], [0, 2.0 / h, -1], [0, 0, 1.0]])
    return trans @ H_pix @ np.linalg.inv(trans)


def match_average_precision(distances: np.ndarray, correct: np.ndarray) -> float:
    """AP of match confidence (1 - normalized distance) against inlier
    labels, as `sklearn.metrics.average_precision_score` computes it."""
    if len(distances) == 0 or correct.sum() == 0:
        return 0.0
    conf = 1.0 - distances / max(distances.max(), 1e-9)
    order = np.argsort(-conf)
    c = correct[order].astype(np.float64)
    tp = np.cumsum(c)
    precision = tp / (np.arange(len(c)) + 1)
    recall = tp / c.sum()
    return float(np.sum(np.diff(np.concatenate([[0.0], recall])) * precision))


def to_numpy(out: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A pipeline output batch on the host (floating tensors as f32)."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy() for k, v in out.items()}


def keypoints_and_descriptors(out: Mapping[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """`(N, 3)` `[x, y, score]` valid keypoints of the first image of a host
    pipeline output, and their `(N, D)` descriptors."""
    ok = out["kp_valid"][0]
    kp = np.concatenate([out["keypoints"][0][ok], out["kp_scores"][0][ok, None]], axis=1)
    return kp, out["descriptors"][0][ok]


def pair_metrics(out1: Mapping[str, np.ndarray], out2: Mapping[str, np.ndarray],
                 H_pix: np.ndarray, shape_hw, keep_k_points: int = 300,
                 device="cpu") -> dict[str, Any]:
    """One pair's metrics from the host pipeline outputs of its two images
    and the pixel homography `x2 = H_pix @ x1`: repeatability and
    localization error (-1 where nothing repeats), the homography-correctness
    dict (`mean_dist` None where no homography was found) and the match AP
    (None where there are no matches or inliers). `device` picks the
    RANSAC's form (numpy for the CPU, else compiled)."""
    # image 2 content at x2 = H_pix @ x1, so the normalized H_pix maps view 1
    # to view 2 (the inverse homography of the internal convention)
    inv_h = _normalized_from_pixel_h(H_pix, shape_hw)
    hom = np.linalg.inv(inv_h)
    kp1, d1 = keypoints_and_descriptors(out1)
    kp2, d2 = keypoints_and_descriptors(out2)
    rep, loc = compute_repeatability(kp1.copy(), kp2.copy(), hom, inv_h, shape_hw, keep_k_points)
    hc = compute_homography_correctness(kp1, kp2, d1, d2, inv_h, shape_hw, keep_k_points,
                                        device=device)
    ap = None
    if len(hc["inliers"]) and len(hc["mscores"]):
        ap = match_average_precision(hc["mscores"], hc["inliers"] > 0)
    return {"repeatability": rep, "localization_error": loc, "correctness": hc,
            "match_ap": ap, "keypoints": (kp1, kp2), "descriptors": (d1, d2)}


def evaluate_hpatches(
    pipeline,
    dataset,
    keep_k_points: int = 300,
    correctness_eps: tuple = CORRECTNESS_EPS,
    max_pairs: Optional[int] = None,
    export_dir: Optional[str | Path] = None,
    seed: int = 0,
) -> dict[str, Any]:
    """Run the HPatches protocol.

    Args:
      pipeline: an `InferencePipeline` (keypoints and descriptors; boxes unused).
      dataset: `data.datasets.HPatches`, or any sequence of its items.
      export_dir: optionally write per-pair `.npz` files in the reference
        schema (`image, prob, desc, warped_image, warped_prob, warped_desc,
        homography`).

    Returns:
      the metrics, averaged over the pairs.
    """
    np.random.seed(seed)  # as the JAX runner and the reference seed the host RNG
    device = getattr(pipeline, "device", "cpu")  # picks the RANSAC's form
    reps, loc_errs, mscores, maps = [], [], [], []
    correct_at = {e: [] for e in correctness_eps}
    n = len(dataset) if max_pairs is None else min(max_pairs, len(dataset))

    for i in range(n):
        sample = dataset[i]
        img1, img2 = sample["image"], sample["warped_image"]
        shape_hw = img1.shape[:2]
        out1 = to_numpy(pipeline(img1[None]))
        out2 = to_numpy(pipeline(img2[None]))
        m = pair_metrics(out1, out2, sample["homography_pix"], shape_hw, keep_k_points, device)
        reps.append(m["repeatability"])
        if m["localization_error"] >= 0:
            loc_errs.append(m["localization_error"])
        hc = m["correctness"]
        mscores.append(hc["matching_score"])
        for e in correctness_eps:
            correct_at[e].append(
                float(hc["mean_dist"] <= e) if hc["mean_dist"] is not None else 0.0)
        if m["match_ap"] is not None:
            maps.append(m["match_ap"])

        if export_dir is not None:
            out_path = Path(export_dir)
            out_path.mkdir(parents=True, exist_ok=True)
            (kp1, kp2), (d1, d2) = m["keypoints"], m["descriptors"]
            np.savez_compressed(
                out_path / f"{sample['name']}.npz",
                image=img1, warped_image=img2, prob=kp1, warped_prob=kp2,
                desc=d1, warped_desc=d2, homography=sample["homography_pix"],
            )

    return {
        "repeatability": float(np.mean(reps)) if reps else 0.0,
        "localization_error": float(np.mean(loc_errs)) if loc_errs else -1.0,
        "matching_score": float(np.mean(mscores)) if mscores else 0.0,
        "match_mAP": float(np.mean(maps)) if maps else 0.0,
        **{f"correctness@{e}": float(np.mean(v)) for e, v in correct_at.items()},
        "num_pairs": n,
    }


def build_pipeline(weights: Optional[str | Path], model_name: str = "YOLOPoint",
                   version: str = "n", kpt_conf: float = 0.015, f32: bool = False,
                   device=None):
    """The runner's pipeline over `frontend.pipeline.deploy_model`: the model
    of `weights` (architecture, version and class count from its metadata),
    or, without `weights`, `model_name`/`version` with
    80 classes under torch's default initialization at seed 0. The default
    is the fused bf16 path (BN folded, bf16 convolutions); `f32` runs the
    f32 model (BN unfolded unless the file holds it folded)."""
    model, dtype, _, _ = deploy_model(weights, model_name, version, None, f32, device)
    return InferencePipeline(model, {"detection_threshold": kpt_conf}, compute_dtype=dtype,
                             device=device)


def main(argv=None):
    """HPatches-protocol CLI: the JAX runner's flags, plus `--device`
    (default the GPU; `cpu` runs the plain versions of the kernels)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="HPatches protocol evaluation")
    ap.add_argument("--data", required=True, help="HPatches-layout root dir")
    ap.add_argument("--weights", default=None,
                    help="reference-schema torch checkpoint file, a port run directory, "
                    "or an orbax run or checkpoint directory of the JAX package")
    ap.add_argument("--model", default="YOLOPoint")
    ap.add_argument("--version", default="n")
    ap.add_argument("--size", type=int, nargs=2, default=[256, 320],
                    help="eval resolution H W, mod-32 (reference uses 480 640)")
    ap.add_argument("--alteration", default="all", choices=["all", "i", "v"])
    ap.add_argument("--keep-k", type=int, default=300)
    ap.add_argument("--kpt-conf", type=float, default=0.015)
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--export", default=None, help="dump per-pair .npz here")
    ap.add_argument("--json", default=None, help="write metrics JSON here")
    ap.add_argument("--f32", action="store_true", help="disable the fused bf16 deploy path")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.size[0] % 32 or args.size[1] % 32:
        ap.error(f"--size {args.size} must be divisible by 32 (stride-32 PANet level)")

    pipeline = build_pipeline(args.weights, args.model, args.version, args.kpt_conf,
                              args.f32, args.device)
    dataset = HPatches(args.data, size_hw=tuple(args.size), alteration=args.alteration)
    metrics = evaluate_hpatches(pipeline, dataset, keep_k_points=args.keep_k,
                                max_pairs=args.max_pairs, export_dir=args.export)
    line = json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in metrics.items()})
    print(line)
    if args.json:
        Path(args.json).write_text(line)
    return metrics


if __name__ == "__main__":
    main()
