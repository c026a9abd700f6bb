"""The port's demo CLI (`yolopoint_tpu_torch/frontend/demo.py`) against the
JAX package's `demo.main`, on the CPU: one directory of PNG, BMP and PPM
frames (a pan over one canvas), the same weights file (BN statistics of the
frames), `--f32 --track --save-dir` at 128 px with a box gate that a few
anchors of each frame clear by a margin (so that boxes and their labels are
drawn, and the NMS is well-conditioned): the same printed line per frame
and the same decoded pixels of every saved frame (labels and track lines
included: the drawing is bit-equal to OpenCV's, so the JPEG files are
byte-equal). `--timing` prints its line; a video the port does not read
raises, naming the file."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.frontend import demo as jax_demo
from yolopoint_tpu_torch.frontend import demo
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import state_dict_to_reference

torch.set_num_threads(1)

NAMES = ["car", "pedestrian", "cyclist"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("demo")
    frames = tmp / "frames"
    frames.mkdir()
    # a camera panning by 32 px (the model's stride) a frame over noise, in
    # lossless files: a point's descriptor repeats from frame to frame, so
    # the tracker's nearest neighbours are well-conditioned with random weights
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (96, 128 + 3 * 32, 3), dtype=np.uint8)
    for i, ext in enumerate((".png", ".bmp", ".ppm", ".png")):
        cv2.imwrite(str(frames / f"f{i}{ext}"), canvas[:, 32 * i:32 * i + 128])
    (frames / "notes.txt").write_text("not a frame")
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=len(NAMES), device="cpu")
    calibrate_bn(model, canvas)
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()), "names": NAMES,
                "version": "n", "model_name": "YOLOPoint"}, tmp / "w.pt")
    return tmp


def box_gate(inputs):
    """A box confidence gate that a handful of each frame's anchors pass,
    none of them within 1% of it: with random weights neighbouring anchors
    tie to ~1e-7, and an ulp of difference between the packages would
    reorder the NMS of the protocol's low gates (`test_torch_detect_cli.py`)."""
    from yolopoint_tpu_torch.data.datasets import _imread
    from yolopoint_tpu_torch.frontend.pipeline import (
        InferencePipeline,
        deploy_model,
        preprocess_frame,
    )

    model, dtype, _, _ = deploy_model(str(inputs / "w.pt"), "YOLOPoint", "n", None, True)
    pipe = InferencePipeline(model, {}, dtype, device="cpu")
    scores = []
    for f in sorted((inputs / "frames").glob("f*")):
        img = preprocess_frame(_imread(str(f), "cpu"), 128)[0]
        with torch.no_grad():
            levels = pipe.forward(torch.from_numpy(img[None]))["objects"]
        s = torch.cat([(torch.sigmoid(r[..., 4]) * torch.sigmoid(r[..., 5:].amax(-1))).flatten()
                       for r in levels])
        scores.append(s.sort(descending=True).values.numpy())
    for t in np.sort(np.concatenate([s[:40] for s in scores]))[::-1]:
        gate = t * 0.995
        counts = [(s > gate).sum() for s in scores]
        if min(counts) >= 1 and max(counts) <= 12 and all(
                np.abs(s[:20] / gate - 1).min() > 0.004 for s in scores):
            return float(gate)
    raise AssertionError("no clean box gate")


def calibrate_bn(model, canvas):
    """BatchNorm statistics of the frames themselves (one train-mode pass
    with momentum 1): random weights with the default statistics give
    features that hardly depend on the image, so scores and descriptors tie,
    and the tracker's matches would follow last-ulp differences."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    crops = np.stack([canvas[:, 32 * i:32 * i + 128] for i in range(4)])
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(crops).permute(0, 3, 1, 2).float() / 255.0)
    model.eval()
    for bn in bns:
        bn.momentum = 0.1


def run(main, inputs, name, capsys, conf):
    out = inputs / name
    main(["--weights", str(inputs / "w.pt"), "--input", str(inputs / "frames"), "--img-size",
          "128", "--conf", str(conf), "--f32", "--track", "--save-dir", str(out)]
         + (["--device", "cpu"] if main is demo.main else []))
    return capsys.readouterr().out.splitlines(), out


def test_demo_equals_jax(inputs, capsys):
    conf = box_gate(inputs)
    got_lines, got_dir = run(demo.main, inputs, "port", capsys, conf)
    want_lines, want_dir = run(jax_demo.main, inputs, "jax", capsys, conf)
    assert got_lines == want_lines
    assert len(got_lines) == 4 and all(" keypoints, " in s for s in got_lines)
    assert sum(int(s.split(", ")[1].split()[0]) for s in got_lines) > 0  # boxes were drawn
    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir()) == [f"f{i}.jpg" for i in range(4)]
    for n in names:
        got, want = cv2.imread(str(got_dir / n)), cv2.imread(str(want_dir / n))
        np.testing.assert_array_equal(got, want, err_msg=n)
        assert (got_dir / n).read_bytes() == (want_dir / n).read_bytes()


def test_timing_line(inputs, capsys):
    demo.main(["--input", str(inputs / "frames"), "--model", "YOLOPoint", "--version", "n",
               "--img-size", "64", "--device", "cpu", "--timing", "--save-dir",
               str(inputs / "timed")])
    lines = capsys.readouterr().out.splitlines()
    import json

    timing = json.loads(lines[-1])
    assert timing["frames"] == 4 and set(timing) >= {"read_ms", "infer_ms", "draw_ms",
                                                     "encode_ms", "launches"}
    assert all(len(timing[k]) == 4 for k in ("read_ms", "infer_ms", "draw_ms", "encode_ms"))
    assert timing["launches"] == {}  # the CPU runs the kernels' plain versions


def test_video_raises(tmp_path):
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\x1a\x45\xdf\xa3" + b"\0" * 60)  # a Matroska file, named .mp4
    with pytest.raises(NotImplementedError, match="clip.mp4.*Matroska"):
        list(demo.iter_frames(str(video), "cpu"))
    assert Path(video).exists()
