"""Demo CLI: keypoints, boxes and point tracks on a directory of images or
a video file.

Counterpart of `yolopoint_tpu/frontend/demo.py`: frames stream through the
`InferencePipeline` (K1/K6, K2 and K3 on the card), the `PointTracker` links
them, and with `--save-dir` each frame is drawn as the JAX demo draws it
(`draw_output`, `PointTracker.draw_tracks`: `data/raster.py`'s bit-equal
OpenCV drawing, its text included) and written as `{name}.jpg` with the
bytes `cv2.imwrite` gives (`data/jpeg.py`'s encoder). Frames are read by
`datasets._imread` (JPEG, PNG, BMP, Netpbm, TIFF, GIF, Sun raster, PAM, PFM
and Radiance HDR, by their first bytes whatever their suffix) and skipped
exactly where `cv2.imread` returns None (`FileNotFoundError`); a file that
`cv2.imread` reads and the port does not (WebP, JPEG 2000, AVIF, a TIFF
layout the port does not read) raises `NotImplementedError`. Any other path
is read as a video, frame for frame as `cv2.VideoCapture` reads it
(`data/video.py`: AVI and MP4/MOV with MJPEG, MPEG-4 Part 2, raw I420 or
PNG), the frames named `000000`, `000001`, ... as the JAX demo names them;
a file cv2 cannot open gives no frames, one it reads and the port does not
raises `NotImplementedError`.

    python -m yolopoint_tpu_torch.frontend.demo --input DIR_OR_VIDEO [--weights FILE_OR_RUN] \
        [--img-size 640] [--track] [--save-dir OUT] [--f32] [--device cuda]

The model is the fused bf16 deploy path by default (BN folded into the
convolutions, `models.convert.fold_batch_norm`); `--f32` keeps the f32
model. Without `--weights` it is the `--model`/`--version` architecture with
80 classes under torch's default initialization at seed 0. The device
defaults to the GPU; `--device cpu` runs the kernels' plain versions.
`--timing` prints, after the frames, one JSON line of each frame's
milliseconds reading, in the pipeline, tracking and drawing, and encoding
(the first frame pays the process's CUDA and cuDNN start-up), and the
kernel launches of the run.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from yolopoint_tpu_torch.data import raster

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".ppm", ".bmp")
POINT_COLOR, BOX_COLOR = (0, 255, 0), (255, 128, 0)


def iter_frames(input_path: str, device: str | torch.device = "cuda") -> Iterator[tuple[str, np.ndarray]]:
    """`(stem, BGR frame)` of each image of a directory, in name order (a
    file that `cv2.imread` returns None for is skipped, as the JAX demo
    skips it; one it reads and the port does not raises), or `(f"{i:06d}",
    BGR frame)` of each frame of a video file. `device` cpu decodes in
    numpy, any other in compiled host code."""
    from yolopoint_tpu_torch.data.datasets import _imread

    p = Path(input_path)
    if not p.is_dir():
        from yolopoint_tpu_torch.data.video import read_video

        for i, frame in enumerate(read_video(p, device)):
            yield f"{i:06d}", frame
        return
    for f in sorted(p.iterdir()):
        if f.suffix.lower() in IMAGE_SUFFIXES:
            try:
                img = _imread(str(f), device)
            except FileNotFoundError:
                continue
            yield f.stem, img


def draw_output(frame: np.ndarray, out: dict, names: Optional[Sequence[str]] = None) -> np.ndarray:
    """A copy of `frame` with the valid keypoints (green discs of radius 2)
    and boxes (orange frames 2 wide, each labelled `"{class} {score:.2f}"`)."""
    vis = frame.copy()
    kp = out["keypoints"][out["kp_valid"]]
    for x, y in kp.astype(int):
        raster.circle(vis, (x, y), 2, POINT_COLOR)
    if "boxes" in out:
        for box, score, cls, ok in zip(
            out["boxes"], out["box_scores"], out["box_classes"], out["box_valid"]
        ):
            if not ok:
                continue
            x1, y1, x2, y2 = box.astype(int)
            raster.rectangle(vis, (x1, y1), (x2, y2), BOX_COLOR, 2)
            label = names[int(cls)] if names else str(int(cls))
            raster.put_text(vis, f"{label} {score:.2f}", (x1, max(y1 - 4, 10)), BOX_COLOR)
    return vis


def main(argv=None):
    parser = argparse.ArgumentParser(description="YOLOPoint demo (PyTorch port)")
    parser.add_argument("--weights", help="reference-schema torch checkpoint file, a port run, "
                        "or an orbax run or checkpoint directory of the JAX package")
    parser.add_argument("--input", required=True, help="image directory or video")
    parser.add_argument("--model", default="YOLOPoint")
    parser.add_argument("--version", default="s")
    parser.add_argument("--img-size", type=int, default=640)
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--kpt-conf", type=float, default=0.015)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--track", action="store_true", help="draw point tracks")
    parser.add_argument("--f32", action="store_true",
                        help="disable the fused bf16 deploy path")
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    parser.add_argument("--timing", action="store_true",
                        help="print a JSON line of per-frame phase times and kernel launches")
    args = parser.parse_args(argv)

    from yolopoint_tpu_torch.data.jpeg import write_jpeg
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, deploy_model
    from yolopoint_tpu_torch.frontend.tracker import PointTracker
    from yolopoint_tpu_torch.ops import _build
    from yolopoint_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model, dtype, names, _ = deploy_model(args.weights, args.model, args.version, None, args.f32,
                                          device)
    pipe = InferencePipeline(
        model, {"detection_threshold": args.kpt_conf, "conf_thresh": args.conf},
        compute_dtype=dtype, device=device,
    )
    tracker = PointTracker(max_length=5, nn_thresh=0.7) if args.track else None

    save_dir = Path(args.save_dir) if args.save_dir else None
    if save_dir:
        save_dir.mkdir(parents=True, exist_ok=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    phases = {k: [] for k in ("read", "infer", "draw", "encode")}
    launches0 = dict(_build.launch_counts)
    frames = iter_frames(args.input, device)
    n = 0
    while True:
        t0 = time.perf_counter()
        item = next(frames, None)
        if item is None:
            break
        name, frame = item
        t1 = time.perf_counter()
        out = pipe.process_frame(frame, args.img_size)
        sync()
        t2 = time.perf_counter()
        if tracker is not None:
            v = out["kp_valid"]
            tracker.update(
                np.vstack([out["keypoints"][v].T, out["kp_scores"][v]]),
                out["descriptors"][v].T,
            )
        n_kp = int(out["kp_valid"].sum())
        n_box = int(out["box_valid"].sum()) if "box_valid" in out else 0
        print(f"{name}: {n_kp} keypoints, {n_box} boxes")
        t3 = t4 = time.perf_counter()
        if save_dir:
            vis = draw_output(frame, out, names)
            if tracker is not None:
                tracker.draw_tracks(vis, tracker.get_tracks(min_length=2))
            t3 = time.perf_counter()
            write_jpeg(save_dir / f"{name}.jpg", vis, device=device)
            t4 = time.perf_counter()
        for key, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            phases[key].append(dt * 1e3)
        n += 1
    if args.timing:
        launches = {k: v - launches0.get(k, 0) for k, v in _build.launch_counts.items()
                    if v != launches0.get(k, 0)}
        print(json.dumps({"frames": n, **{f"{k}_ms": v for k, v in phases.items()},
                          "launches": launches}))


if __name__ == "__main__":
    main()
