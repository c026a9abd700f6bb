"""The port's CLIs on the three JPEG configs, on the CPU, over the committed
fixtures' JPEG files (`datasets/fixtures/coco`), against the JAX package's:

* `export.cli` on `configs/coco_export.yaml` (YOLOPointDet), cut to the n
  model, N = 2 and 128 px; JAX-initialized weights carried across with
  `jax_variables_to_state_dict`, the detector head scaled up so that the
  scores leave the 0.015 threshold; both CLIs on their default (host-warp)
  path: the same files, the same points, scores as
  `tests/test_torch_host_export.py` holds them;
* `training.cli` on `configs/coco.yaml` with `val_plots: false` and tiny
  overrides (the n model, 128 px, B = 2, one epoch): the first batch equal
  to the JAX CLI's loader's (the host-warp payload included), then finite
  losses, a validation and a checkpoint;
* `training.cli` on `configs/concat_datasets.yaml` (KITTI PNG + COCO JPEG,
  length-normalized draws) with the same cuts: the epoch's draws equal to
  the JAX loader's, both datasets drawn, every batch equal to the JAX
  datasets' samples at those draws on the shared canvas (the JAX collate
  cannot stack a KITTI crop frame and a COCO letterbox: it raises), then
  finite losses and a checkpoint.
"""

import copy
import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_export import SCORE_RTOL
from yolopoint_tpu.data.datasets import build_dataset as jax_build_dataset
from yolopoint_tpu.data.loader import pad_collate as jax_pad_collate
from yolopoint_tpu.export import cli as jax_export_cli
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training import cli as jax_train_cli
from yolopoint_tpu_torch.data.datasets import ImagePointBoxDataset
from yolopoint_tpu_torch.data.loader import pad_collate
from yolopoint_tpu_torch.export import cli as export_cli
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import (jax_variables_to_state_dict,
                                                state_dict_to_reference)
from yolopoint_tpu_torch.training import cli as train_cli
from yolopoint_tpu_torch.utils.config import dict_update, load_config, save_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "datasets" / "fixtures"
CUTS = {  # the CPU cuts shared by the training runs
    "val_plots": False,
    "model": {"version": "n", "superpoint": {"top_k": 100, "sparse_loss": {"params": {
        "num_samples_per_image": 40}}}},
    "training_params": {"epochs": 1, "train_batch_size": 2, "val_batch_size": 2},
    "extended_val_sample_size": 2,
}


def test_export_cli_on_coco_export_yaml(tmp_path):
    cfg = load_config(REPO / "configs" / "coco_export.yaml")
    cfg.pop("pretrained")  # not in the repo: the weights come by --weights
    cfg["model"]["version"] = "n"
    cfg["export"]["num_homographies"] = 2
    cfg["data"]["preprocessing"]["img_size"] = 128
    save_config(cfg, tmp_path / "coco_export.yaml")
    jmodel = jax_build_model("YOLOPointDet", "n", nc=1)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))
    state = jax_variables_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
    state["ConvDet.weight"] = state["ConvDet.weight"] * 100.0  # scores far from the threshold
    model = build_model("YOLOPointDet", "n", nc=1, device="cpu")
    model.load_state_dict(state)
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "model_name": "YOLOPointDet"}, tmp_path / "w.pt")
    args = ["--config", str(tmp_path / "coco_export.yaml"), "--weights", str(tmp_path / "w.pt"),
            "--data_root", str(FIXTURES), "--seed", "5"]
    paths = export_cli.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_export_cli.main(args + ["--output", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in paths) == names == [f"train_{i:03d}.npz" for i in range(5)]
    for name in names:
        got, want = (np.load(tmp_path / d / name)["pts"] for d in ("port", "jax"))
        assert got.ndim == 2 and got.shape[1] == 3 and len(got) > 0
        got_s = {tuple(p[:2]): p[2] for p in got}
        want_s = {tuple(p[:2]): p[2] for p in want}
        assert got_s.keys() == want_s.keys()
        for p, s in want_s.items():
            assert abs(got_s[p] - s) <= SCORE_RTOL * abs(s) + 5e-6, p


def coco_config(tmp_path: Path) -> Path:
    cfg = dict_update(load_config(REPO / "configs" / "coco.yaml"), copy.deepcopy(CUTS))
    cfg["data"]["preprocessing"]["img_size"] = 128
    cfg["data"]["labels"]["points"] = str(FIXTURES / "coco" / "points")
    save_config(cfg, tmp_path / "coco.yaml")
    return tmp_path / "coco.yaml"


def same_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "names":
            assert got[k] == list(want[k])
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=1e-6 if g.dtype == np.float32 else 0, rtol=0,
                                   err_msg=k)


def run_and_check(agent, run: Path) -> list:
    """Train the built agent; the micro-steps' losses, checked finite, and a
    written checkpoint and validation."""
    losses = []
    real = type(agent).step

    def step(self, batch, on_phase=None):
        aux = real(self, batch, on_phase)
        losses.append({k: float(v) for k, v in aux.items() if k.startswith("loss")})
        return aux

    type(agent).step = step
    try:
        agent.train()
    finally:
        type(agent).step = real
    assert losses and all(math.isfinite(v) for h in losses for v in h.values())
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "validation/fitness" in r]
    assert len(val) == 1 and all(math.isfinite(v) for v in val[0].values()
                                 if isinstance(v, float))
    assert (run / "best.pt").exists() and (run / "ckpts" / "0.pt").exists()
    return losses


def test_train_cli_on_coco_yaml(tmp_path, caplog):
    config = coco_config(tmp_path)
    args = ["--config", str(config), "--data_root", str(FIXTURES), "--seed", "3"]
    jax_agent = jax_train_cli.build_agent(args + ["--output_dir", str(tmp_path / "jax")])
    caplog.set_level("INFO")
    agent = train_cli.build_agent(args + ["--output_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    path = "host" if (os.cpu_count() or 1) >= 4 else "device"  # the JAX CLI's rule
    assert any(r.getMessage().startswith(f"augmentation warp path: {path}")
               for r in caplog.records)
    assert agent.train_loader.datasets[0].img_paths[0].endswith(".jpg")
    same_batch(next(iter(agent.train_loader)), next(iter(jax_agent.train_loader)))
    losses = run_and_check(agent, tmp_path / "port" / "exp")
    assert len(losses) == 2  # 5 images, B = 2


def test_train_cli_on_concat_datasets_yaml(tmp_path):
    """KITTI's PNG fixtures at 320 px with a 64x192 crop, COCO's JPEG ones
    letterboxed to 128 px, sampled with length-normalized weights; the
    parent config's `data` holds only `sub_configs`, so the agent runs the
    device path with no augmentation, as the JAX CLI's would."""
    kitti = load_config(REPO / "configs" / "kitti.yaml")
    kitti.pop("pretrained")
    kitti["data"]["preprocessing"]["img_size"] = 320
    kitti["data"]["augmentation"]["homographic"]["cropHW"] = [64, 192]
    kitti["data"]["labels"]["points"] = str(FIXTURES / "kitti" / "points")
    save_config(kitti, tmp_path / "kitti.yaml")
    coco_config(tmp_path)
    cfg = dict_update(load_config(REPO / "configs" / "concat_datasets.yaml"),
                      copy.deepcopy(CUTS))
    cfg["data"]["augmentation"] = {"host_warp": False}
    save_config(cfg, tmp_path / "concat.yaml")
    args = ["--config", str(tmp_path / "concat.yaml"), "--data_root", str(FIXTURES),
            "--seed", "7"]  # batches: COCO alone, then three mosaics of both datasets
    agent = train_cli.build_agent(args + ["--output_dir", str(tmp_path / "port"),
                                          "--device", "cpu"])
    jax_agent = jax_train_cli.build_agent(args + ["--output_dir", str(tmp_path / "jax")])
    loader, jax_loader = agent.train_loader, jax_agent.train_loader
    assert [type(d).__name__ for d in loader.datasets] == ["Kitti", "Coco"]
    assert loader.sizes == jax_loader.sizes == [4, 5]
    np.testing.assert_array_equal(loader.weights, jax_loader.weights)
    # the epoch's draws, in the JAX loader's order (both consume their own rng)
    draws = jax_loader._epoch_indices()
    rows = draws.reshape(-1, loader.batch_size)
    flags = jax_loader.rng.random(len(rows)) < jax_loader.mosaic_prob
    assert {int(i) < 4 for i in draws} == {True, False}  # both datasets drawn
    batches = list(loader)
    assert len(batches) == len(rows) == 4 and loader.epoch == 1
    jax_sets = [jax_build_dataset(c["data"], "train", cfg["names"], str(FIXTURES))
                for c in (kitti, load_config(tmp_path / "coco.yaml"))]
    mixed = 0
    for b, (row, flag, got) in enumerate(zip(rows, flags, batches)):
        samples = []
        for slot, i in enumerate(row):
            d, local = (0, int(i)) if i < 4 else (1, int(i) - 4)
            np.random.seed([7, 0, b, slot])  # the port's per-sample stream, in the JAX global
            samples.append(jax_sets[d].get(local, mosaic=bool(flag)))
        same_batch(got, pad_collate(samples, loader.max_points, loader.max_boxes))
        if len({s["image"].shape for s in samples}) > 1:
            mixed += 1
            with pytest.raises(ValueError):  # the JAX collate cannot stack them
                jax_pad_collate(samples, loader.max_points, loader.max_boxes)
    assert flags.tolist() == [False, True, True, True] and mixed == 3
    kinds = []
    real_get = ImagePointBoxDataset.get

    def get(self, idx, mosaic=None, rng=None):
        kinds.append(type(self).__name__)
        return real_get(self, idx, mosaic, rng)

    ImagePointBoxDataset.get = get
    try:
        run_and_check(agent, tmp_path / "port" / "exp")
    finally:
        ImagePointBoxDataset.get = real_get
    assert {"Kitti", "Coco"} <= set(kinds)
