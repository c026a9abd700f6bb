"""The port's demo on video input against the JAX demo, on the CPU: the JAX
`iter_frames` of a video (cv2.VideoCapture) and the port's (`data/video.py`)
give the same names (`000000`, ...) and bit-equal frames, and the port's
`demo.main` on a short `mp4v` clip at YOLOPoint-n prints the JAX demo's
lines and saves byte-equal JPEGs (`--f32 --track --save-dir` at 128 px;
weights with BN statistics of the frames and a box gate a few anchors
clear by a margin, as `tests/test_torch_demo.py` does for directories)."""

import numpy as np
import pytest
import torch

from tests.torch_video_files import pan_clip, write_cv2
from yolopoint_tpu.frontend import demo as jax_demo
from yolopoint_tpu_torch.frontend import demo
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import state_dict_to_reference

torch.set_num_threads(1)

NAMES = ["car", "pedestrian", "cyclist"]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("video_demo")
    return {
        "mp4": write_cv2(tmp / "clip.mp4", "mp4v", pan_clip(96, 128, 4, seed=11)),
        "avi": write_cv2(tmp / "clip.avi", "MJPG", pan_clip(72, 104, 5, seed=12)),
        "tmp": tmp,
    }


@pytest.mark.parametrize("kind", ["mp4", "avi"])
def test_iter_frames_equal_jax(clips, kind):
    want = list(jax_demo.iter_frames(str(clips[kind])))
    got = list(demo.iter_frames(str(clips[kind]), "cpu"))
    assert [n for n, _ in got] == [n for n, _ in want] == [f"{i:06d}" for i in range(len(want))]
    assert len(want) >= 4
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def weights(clips, frames) -> str:
    """YOLOPoint-n with BatchNorm statistics of the clip's frames (random
    weights with default statistics tie scores and descriptors)."""
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=len(NAMES), device="cpu")
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).float() / 255.0)
    model.eval()
    path = clips["tmp"] / "w.pt"
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()), "names": NAMES,
                "version": "n", "model_name": "YOLOPoint"}, path)
    return str(path)


def box_gate(path: str, frames) -> float:
    """A box gate a handful of each frame's anchors pass, none within 1% of
    it (`tests/test_torch_demo.py:box_gate`)."""
    from yolopoint_tpu_torch.frontend.pipeline import (
        InferencePipeline,
        deploy_model,
        preprocess_frame,
    )

    model, dtype, _, _ = deploy_model(path, "YOLOPoint", "n", None, True)
    pipe = InferencePipeline(model, {}, dtype, device="cpu")
    scores = []
    for f in frames:
        img = preprocess_frame(f, 128)[0]
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


def test_demo_on_video_equals_jax(clips, capsys):
    frames = [f for _, f in demo.iter_frames(str(clips["mp4"]), "cpu")]
    w = weights(clips, frames)
    conf = box_gate(w, frames)
    outs = {}
    for name, main in (("port", demo.main), ("jax", jax_demo.main)):
        out = clips["tmp"] / name
        main(["--weights", w, "--input", str(clips["mp4"]), "--img-size", "128", "--conf",
              str(conf), "--f32", "--track", "--save-dir", str(out)]
             + (["--device", "cpu"] if main is demo.main else []))
        outs[name] = (capsys.readouterr().out.splitlines(), out)
    (got_lines, got_dir), (want_lines, want_dir) = outs["port"], outs["jax"]
    assert got_lines == want_lines
    assert [s.split(":")[0] for s in got_lines] == [f"{i:06d}" for i in range(4)]
    assert sum(int(s.split(", ")[1].split()[0]) for s in got_lines) > 0  # boxes were drawn
    names = sorted(p.name for p in want_dir.iterdir())
    assert names == sorted(p.name for p in got_dir.iterdir()) == [f"{i:06d}.jpg" for i in range(4)]
    for n in names:
        assert (got_dir / n).read_bytes() == (want_dir / n).read_bytes(), n
