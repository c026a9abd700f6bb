"""The port's detection evaluation CLI (`yolopoint_tpu_torch/evaluation/
detect_cli.py`) against the JAX package's, on the CPU, on the KITTI
fixtures' PNG files (`configs/kitti.yaml` at YOLOPoint-n, 320 px), and
`main` on the COCO fixtures' JPEG files (`configs/coco.yaml`, nc = 80).

Box NMS at conf 0.001 is ill-conditioned with random weights (neighbouring
anchors predict nearly the same box with scores ~1e-10 apart), so both
packages are fed the SAME decoded predictions: the detections of both NMS
within 1e-6, and the metrics of both `evaluate_detection` on the same
detections within 1e-6. `main` of both CLIs on the same weights file: the
same images, classes and keys, finite metrics.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.data.datasets import build_dataset as jax_build_dataset
from yolopoint_tpu.evaluation import detect_cli as jax_detect
from yolopoint_tpu.ops import nms as jnms
from yolopoint_tpu.ops.nms import batched_box_nms as jax_box_nms
from yolopoint_tpu_torch.data.datasets import build_dataset
from yolopoint_tpu_torch.data.loader import DataLoader
from yolopoint_tpu_torch.evaluation import detect_cli
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import state_dict_to_reference
from yolopoint_tpu_torch.models.detect import decode_levels
from yolopoint_tpu_torch.ops.nms import batched_box_nms
from yolopoint_tpu_torch.utils.config import load_config, save_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "datasets" / "fixtures"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("detect")
    cfg = load_config(REPO / "configs" / "kitti.yaml")
    cfg["model"]["version"] = "n"
    cfg["data"]["preprocessing"]["img_size"] = 320
    cfg["data"]["augmentation"]["homographic"]["cropHW"] = [64, 192]
    cfg["data"]["labels"]["points"] = str(FIXTURES / "kitti" / "points")
    save_config(cfg, tmp / "kitti.yaml")
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=len(cfg["names"]), device="cpu").eval()
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "names": cfg["names"], "version": "n", "model_name": "YOLOPoint"},
               tmp / "w.pt")
    return tmp, cfg, model


def val_batches(cfg):
    ds = build_dataset(cfg["data"], "val", cfg["names"], root=str(FIXTURES), device="cpu")
    return list(DataLoader([ds], 4, shuffle=False, steps_per_epoch=1))


def decoded(model, images):
    with torch.no_grad():
        out = model(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    return decode_levels(out["objects"], model.Detect.anchors_per_stride(), model.Detect.strides)


def test_nms_equals_jax_on_the_same_predictions(setup, monkeypatch):
    """Random weights tie many scores: the JAX side takes `jax.lax.top_k`
    (ties lowest index first, the port's order) for its `exact_top_k`, as
    `tests/test_torch_box_nms.py` does."""
    monkeypatch.setattr(jnms, "exact_top_k", lambda x, k: jax.lax.top_k(x, k))
    _, cfg, model = setup
    pred = decoded(model, val_batches(cfg)[0]["image"])
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, multi_label=True, max_nms=30000)
    got = batched_box_nms(pred, **kw)
    want = jax_box_nms(jnp.asarray(pred.numpy()), **kw)
    valid = np.asarray(want["valid"])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_allclose(got[k].numpy()[valid], np.asarray(want[k])[valid], atol=1e-6,
                                   rtol=0, err_msg=k)


def test_metrics_equal_jax_on_the_same_detections(setup):
    _, cfg, model = setup
    batches = val_batches(cfg)
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, multi_label=True, max_nms=30000)
    dets = [{k: v.numpy() for k, v in batched_box_nms(decoded(model, b["image"]), **kw).items()}
            for b in batches]
    # one ground-truth box moved onto a detection, so that a class scores
    dets[0]["boxes"][0, 0] = [10.0, 20.0, 90.0, 60.0]
    dets[0]["classes"][0, 0] = 1
    for b in batches:
        b["boxes"][0, 0] = [1, 50 / 320, 40 / 96, 80 / 320, 40 / 96]

    def program_of(dets, wrap):
        it = iter(dets)
        return lambda images: {k: wrap(v) for k, v in next(it).items()}

    class Loader(list):
        total = 2

    got = detect_cli.evaluate_detection(program_of(dets, torch.from_numpy), Loader(batches),
                                        cfg["names"], device="cpu", verbose=False)
    want = jax_detect.evaluate_detection(program_of(dets, jnp.asarray), Loader(batches),
                                         cfg["names"], verbose=False)
    assert got["images"] == want["images"] == 2
    assert got["mAP50"] > 0
    for k in ("precision", "recall", "mAP50", "mAP", "fitness_yolo"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert set(got["per_class"]) == set(want["per_class"])
    for c, row in want["per_class"].items():
        for k, v in row.items():
            assert abs(got["per_class"][c][k] - v) <= 1e-6, (c, k)


def test_main_runs_both_clis_on_the_fixtures(setup):
    tmp, cfg, _ = setup
    args = ["--config", str(tmp / "kitti.yaml"), "--weights", str(tmp / "w.pt"), "--data-root",
            str(FIXTURES), "--batch", "4"]
    got = detect_cli.main(args + ["--device", "cpu", "--out", str(tmp / "port.json")])
    want = jax_detect.main(args)
    assert json.loads((tmp / "port.json").read_text())["images"] == got["images"]
    assert got["images"] == want["images"] == len(jax_build_dataset(
        cfg["data"], "val", cfg["names"], root=str(FIXTURES)))
    assert set(got) == set(want) and set(got["speed_ms_per_image"]) == {"pre", "inference_nms"}
    assert all(math.isfinite(got[k]) for k in ("precision", "recall", "mAP50", "mAP"))


def test_main_runs_both_clis_on_coco_jpeg(tmp_path):
    """`configs/coco.yaml` (nc = 80) on the COCO fixtures' val JPEG files,
    cut to YOLOPoint-n at 128 px: both CLIs read the same images and give
    the same keys and finite metrics."""
    cfg = load_config(REPO / "configs" / "coco.yaml")
    cfg["model"]["version"] = "n"
    cfg["data"]["preprocessing"]["img_size"] = 128
    cfg["data"]["labels"]["points"] = str(FIXTURES / "coco" / "points")
    save_config(cfg, tmp_path / "coco.yaml")
    torch.manual_seed(1)
    model = build_model("YOLOPoint", "n", nc=len(cfg["names"]), device="cpu").eval()
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "names": cfg["names"], "version": "n", "model_name": "YOLOPoint"},
               tmp_path / "w.pt")
    args = ["--config", str(tmp_path / "coco.yaml"), "--weights", str(tmp_path / "w.pt"),
            "--data-root", str(FIXTURES), "--batch", "2"]
    got = detect_cli.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    want = jax_detect.main(args)
    assert len(cfg["names"]) == 80 and got["images"] == want["images"] == 3
    assert set(got) == set(want)
    assert all(math.isfinite(got[k]) for k in ("precision", "recall", "mAP50", "mAP"))


def test_weights_of_a_port_run(setup, tmp_path):
    """A port run's `best.pt` (the EMA shadow preferred) with `best_meta.json`."""
    _, cfg, model = setup
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    ema = {n: p.detach() + 1.0 for n, p in model.named_parameters()}
    torch.save({"model": sd, "optimizer": {}, "ema": ema, "step": 3}, tmp_path / "best.pt")
    (tmp_path / "best_meta.json").write_text(json.dumps({"model_name": "YOLOPoint",
                                                         "version": "n"}))
    for path in (tmp_path, tmp_path / "best.pt"):
        state, meta = detect_cli.load_eval_weights(path)
        assert meta["version"] == "n" and set(state) == set(sd)
        name = "Conv1.conv.weight"
        torch.testing.assert_close(state[name], ema[name])
