"""The port's validation plots (`yolopoint_tpu_torch/evaluation/plots.py`,
no matplotlib) against the JAX package's, on the CPU: the same file names;
`draw_detections` bit for bit and `plot_val_panel` writing its array; each
curve's pixels where its data says (`Axes.pixel`), in its `tab10` colour,
the class mean in blue; confusion cells in matplotlib's `Blues` over the
matrix's range; and `TrainAgent.validate` with `val_plots` writing the set
of files the JAX agent's `validate` writes from the same val-step outputs
(the JAX code applied to the outputs the port's val step produced, as
`tests/test_torch_val_step.py` does)."""

import types

import cv2
import matplotlib
import numpy as np
import pytest
import torch

from tests.test_torch_val_step import NC, S640, VAL_AUG, make_batch
from yolopoint_tpu.evaluation import plots as jax_plots
from yolopoint_tpu.evaluation.yolo_eval import ConfusionMatrix, ap_per_class
from yolopoint_tpu.training.agent import TrainAgent as JaxTrainAgent
from yolopoint_tpu_torch.data.png import read_png
from yolopoint_tpu_torch.data.raster_tables import TAB10
from yolopoint_tpu_torch.evaluation import plots
from yolopoint_tpu_torch.training import TrainAgent

torch.set_num_threads(1)

NAMES = ["car", "ped", "bike"]


def curves_of(seed=0, n=200):
    rng = np.random.default_rng(seed)
    tp = rng.random((n, 10)) > 0.4
    conf = rng.random(n).astype(np.float32)
    pred_cls = rng.integers(0, 3, n).astype(np.float32)
    target_cls = rng.integers(0, 3, 120).astype(np.float32)
    return ap_per_class(tp, conf, pred_cls, target_cls, return_curves=True)[-1]


def rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]


def test_file_names_equal_jax(tmp_path):
    curves = curves_of()
    cm = ConfusionMatrix(nc=3)
    cm.process_batch(np.array([[10, 10, 40, 40, 0.9, 0], [60, 60, 90, 90, 0.8, 1]]),
                     np.array([[0, 12, 12, 38, 38], [2, 100, 100, 120, 120]]))
    for mod, d in ((jax_plots, tmp_path / "jax"), (plots, tmp_path / "port")):
        mod.plot_pr_curves(curves, NAMES, d, prefix="e3_")
        mod.plot_confusion_matrix(cm.matrix, NAMES, d / "e3_confusion.png")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 5
    for p in (tmp_path / "port").iterdir():
        img = read_png(p, device="cpu")
        assert img.ndim == 3 and img.shape[0] > 200 and img.std() > 5


def test_draw_detections_and_panel_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    dets = {"boxes": np.array([[10, 10, 60, 50], [70, 20, 140, 80], [-5, 3, 20, 99]], np.float32),
            "scores": np.array([0.9, 0.7, 0.4], np.float32), "classes": np.array([0, 1, 2]),
            "valid": np.array([True, True, False])}
    kps = rng.uniform(-2, 100, (30, 2)).astype(np.float32)
    for image in (img, (img * 255).astype(np.uint8), img[..., :1]):
        np.testing.assert_array_equal(
            plots.draw_detections(image, dets["boxes"], dets["scores"], dets["classes"], NAMES,
                                  keypoints=kps),
            jax_plots.draw_detections(image, dets["boxes"], dets["scores"], dets["classes"],
                                      NAMES, keypoints=kps))
    plots.plot_val_panel(img, dets, NAMES, tmp_path / "panel.png", keypoints=kps)
    v = dets["valid"]
    np.testing.assert_array_equal(rgb(tmp_path / "panel.png"), jax_plots.draw_detections(
        img, dets["boxes"][v], dets["scores"][v], dets["classes"][v], NAMES, keypoints=kps))


def test_curves_lie_at_their_data(tmp_path):
    """Two classes at constant precision 0.25 and 0.75 over recall: their
    colours at those rows, the mean (0.5) in blue, thick, where the legend
    is not."""
    x = np.linspace(0, 1, 101)
    curves = {"pr_x": x, "pr": np.stack([np.full(101, 0.25), np.full(101, 0.75)]),
              "ap50": np.array([0.25, 0.75]), "classes": np.array([0, 1]),
              "px": np.linspace(0, 1, 1000), "p": np.zeros((2, 1000)), "r": np.zeros((2, 1000)),
              "f1": np.stack([np.linspace(0, 1, 1000)] * 2)}
    plots.plot_pr_curves(curves, NAMES, tmp_path)
    img = rgb(tmp_path / "PR_curve.png")
    axes = plots.Axes("Recall", "Precision")
    for xv in (0.5, 0.7, 0.95):
        for yv, color in ((0.25, TAB10[0]), (0.75, TAB10[1]), (0.5, (0, 0, 255))):
            px, py = axes.pixel(xv, yv)
            assert tuple(img[py, px]) == color, (xv, yv)
        px, py = axes.pixel(xv, 0.5)
        assert tuple(img[py - 1, px]) == tuple(img[py + 1, px]) == (0, 0, 255)  # 3 wide
    f1 = rgb(tmp_path / "F1_curve.png")
    for xv in (0.4, 0.6, 0.9):  # the diagonal, under the blue mean of two equal curves
        px, py = axes.pixel(xv, xv)
        assert tuple(f1[py, px]) == (0, 0, 255)
    assert tuple(TAB10[0]) == tuple(
        round(255 * c) for c in matplotlib.colors.to_rgb(matplotlib.colormaps["tab10"](0)))


def test_confusion_cells_are_blues(tmp_path):
    m = np.array([[4, 0, 1, 0], [0, 2, 0, 0], [0, 1, 3, 0], [1, 0, 0, 5]], np.float64)
    plots.plot_confusion_matrix(m, NAMES, tmp_path / "cm.png")
    img = rgb(tmp_path / "cm.png")
    norm = m / (m.sum(0, keepdims=True) + 1e-9)
    g = plots.confusion_layout(3, NAMES + ["background"])
    cmap = matplotlib.colormaps["Blues"]
    mpl = matplotlib.colors.Normalize(vmin=0.0, vmax=norm.max())
    for i in range(4):
        for j in range(4):
            y, x = g["top"] + i * g["cell"] + 2, g["left"] + j * g["cell"] + 2  # a cell corner
            want = cmap(mpl(norm[i, j]), bytes=True)[:3]
            assert tuple(img[y, x]) == tuple(want), (i, j)


def test_validate_writes_the_jax_agents_files(tmp_path):
    config = {
        "names": NAMES,
        "model": {"name": "YOLOPoint", "version": "n",
                  "superpoint": {"detection_threshold": 0.015, "nms": 4, "top_k": 300,
                                 "det_loss": "ce",
                                 "sparse_loss": {"params": {"num_samples_per_image": 60,
                                                            "num_masked_non_matches_per_match": 10}}},
                  "yolo": {"conf_thresh": 0.001, "iou_thresh": 0.6}},
        "training_params": {"train_batch_size": 2, "ema": {"enable": True}},
        "extended_val_sample_size": 6,
        "val_plots": str(tmp_path / "port"),
        "data": {"augmentation": S640["data"]["augmentation"], "val_augmentation": VAL_AUG},
    }
    batches = [make_batch(7), make_batch(8), make_batch(9)]
    agent = TrainAgent(config, tmp_path / "run", batches, batches, seed=3, device="cpu")
    recorded = []
    val_step = agent.val_step

    def recording(params, batch, draws, on_phase=None):
        out = val_step(params, batch, draws, on_phase)
        recorded.append({k: v for k, v in _numpy(out).items()})
        return out

    agent.val_step = recording
    agent.validate(2)

    replay = iter(recorded)
    fake = types.SimpleNamespace(
        config={"val_plots": str(tmp_path / "jax")}, val_loader=[dict(b) for b in batches],
        nc=NC, names=NAMES, confusion=None,
        state=types.SimpleNamespace(ema_params={}, params={}, batch_stats={}),
        _val_step=lambda *args: next(replay), val_seed=agent.val_seed,
        extended_val_n=agent.extended_val_n, metrics=types.SimpleNamespace(
            write=lambda *a, **k: None), output_dir=None, global_step=0)
    fake.write_plots = types.MethodType(JaxTrainAgent.write_plots, fake)
    JaxTrainAgent.validate(fake, 2)  # with cv2, as the JAX package's users run it
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert got == want
    assert {"e2_panel0.png", "e2_panel3.png", "e2_PR_curve.png", "e2_confusion.png"} <= set(got)
    first = recorded[0]
    ev = first["base"]
    v = ev["valid"][0]
    dv = ev["det"]["valid"][0]
    panel = rgb(tmp_path / "port" / "e2_panel0.png")
    np.testing.assert_array_equal(panel, jax_plots.draw_detections(
        first["image"][0], ev["det"]["boxes"][0][dv], ev["det"]["scores"][0][dv],
        ev["det"]["classes"][0][dv], NAMES, keypoints=ev["pts"][0][v]))

    # val_plots: true writes under <output_dir>/plots
    agent.config["val_plots"] = True
    agent.validate(3)
    assert (tmp_path / "run" / "plots" / "e3_confusion.png").exists()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
