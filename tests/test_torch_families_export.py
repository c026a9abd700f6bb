"""Pseudo-label export with the families the export configs name, and the
export CLI: the port against the JAX package on the CPU.

`homography_adaptation_batch` with `SuperPointNet` (`configs/kitti_export.
yaml`) and `YOLOPointDet` (`configs/coco_export.yaml`), version n, BN made
non-trivial, the same weights in both packages and the JAX package's own
homography draws fed to the port (as `tests/test_torch_export.py` does):
the aggregate heatmap within 5e-6 of the JAX steps', the keypoints decoded
from the JAX aggregate the same points with scores within 2^-19 relative
(the port's keys), and the function's keypoints the same points with scores
within 2^-19 relative plus 5e-6.

The CLI (`python -m yolopoint_tpu_torch.export.cli`): its image stream (the
port's `build_dataset(...).iter_export()`) equals the JAX dataset's, and on
`configs/synthetic_export.yaml` cut to 3 images of 64x96 and N = 3 it writes
the JAX CLI's file names with the JAX CLI's key and columns; on the KITTI
fixtures' PNG files (`configs/kitti_export.yaml`, the identity view alone)
the JAX CLI's points, with scores within 1e-5 relative.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_export import KW, _jax_aggregate, _jax_homographies, _same_keypoints
from tests.test_torch_model import randomize_bn
from yolopoint_tpu.data.datasets import build_dataset as jax_build_dataset
from yolopoint_tpu.export import cli as jax_cli
from yolopoint_tpu.export.homography_adaptation import \
    homography_adaptation_batch as jax_homography_adaptation_batch
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu_torch.data.datasets import build_dataset
from yolopoint_tpu_torch.export import aggregate_heatmap, homography_adaptation_batch
from yolopoint_tpu_torch.export import cli
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.models.convert import state_dict_to_reference
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints
from yolopoint_tpu_torch.utils.config import load_config, save_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _image(seed, H, W):
    """Grey rectangles of random levels on a grey background, 3 channels."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), rng.uniform(0.1, 0.9), np.float32)
    for _ in range(10):
        y0, x0 = rng.integers(0, H - H // 4), rng.integers(0, W - W // 4)
        h, w = rng.integers(H // 8, H // 3), rng.integers(W // 8, W // 3)
        img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1)
    return np.repeat(img[..., None], 3, axis=2)


@pytest.fixture(scope="module", params=["SuperPointNet", "YOLOPointDet"])
def models(request):
    name = request.param
    rng = np.random.default_rng(13)
    jmodel = jax_build_model(name, "n")
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)), train=False)
    variables = randomize_bn(dict(variables, batch_stats=variables.get("batch_stats", {})), rng)
    model = build_model(name, "n", device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    return jmodel, variables, model


@pytest.mark.parametrize("size,n", [(64, 4), (96, 6)])
def test_adaptation_matches_jax(models, size, n):
    jmodel, variables, model = models
    image = _image(size + n, size, size)
    key, homs = _jax_homographies(5, 0, n)
    agg_jax = _jax_aggregate(jmodel, variables, image, homs)
    with torch.inference_mode():
        agg = aggregate_heatmap(model, torch.from_numpy(image), torch.from_numpy(homs), 3)
    np.testing.assert_allclose(agg.numpy(), agg_jax, rtol=0, atol=5e-6)

    want = jax_homography_adaptation_batch(jmodel, variables, jnp.asarray(image), key,
                                           num_homographies=n, **KW)
    decoded = extract_keypoints(torch.from_numpy(agg_jax)[None], 0.015, 4, 1000)
    _same_keypoints(*(t[0].numpy() for t in decoded), *map(np.asarray, want), atol=0.0)
    pts, scores, valid = homography_adaptation_batch(
        model, torch.from_numpy(image), homographies=torch.from_numpy(homs), **KW)
    _same_keypoints(pts.numpy(), scores.numpy(), valid.numpy(), *map(np.asarray, want))


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """`configs/synthetic_export.yaml` with 3 images of 64x96 and N = 3."""
    cfg = load_config(REPO / "configs" / "synthetic_export.yaml")
    cfg["data"]["preprocessing"]["resize"] = [64, 96]
    cfg["data"]["length"] = {"train": 3, "val": 2}
    cfg["export"]["num_homographies"] = 3
    path = tmp_path_factory.mktemp("cfg") / "export.yaml"
    save_config(cfg, path)
    return path, cfg


@pytest.mark.parametrize("action", ["train", "val"])
def test_cli_images_equal_jax_dataset(small_config, action):
    _, cfg = small_config
    ours = list(build_dataset(cfg["data"], action=action, names=cfg["names"]).iter_export())
    theirs = list(jax_build_dataset(cfg["data"], action=action, names=cfg["names"]).iter_export())
    assert [n for n, _ in ours] == [n for n, _ in theirs] and len(ours) == cfg["data"]["length"][
        action]
    for (_, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (64, 96, 3)
        np.testing.assert_array_equal(a, b)


def test_cli_writes_the_jax_files(small_config, tmp_path):
    path, cfg = small_config
    model = build_model("YOLOPoint", "n", nc=len(cfg["names"]), device="cpu")
    weights = tmp_path / "w.pt"
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "names": cfg["names"], "version": "n", "model_name": "YOLOPoint"}, weights)
    args = ["--config", str(path), "--weights", str(weights), "--seed", "1"]
    paths = cli.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli.main(args + ["--output", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in paths) == names and len(names) == 3
    for name in names:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert list(got) == list(want) == ["pts"]
        assert got["pts"].ndim == want["pts"].ndim == 2 and got["pts"].shape[1] == 3
        assert got["pts"].dtype == want["pts"].dtype and len(got["pts"]) > 0


def test_cli_without_weights_is_seeded(small_config, tmp_path):
    path, _ = small_config
    runs = [cli.main(["--config", str(path), "--output", str(tmp_path / d), "--device", "cpu",
                      "--action", "val"]) for d in ("a", "b")]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(np.load(a)["pts"], np.load(b)["pts"])


def test_cli_exports_image_file_datasets(tmp_path, monkeypatch):
    """`configs/kitti_export.yaml` (SuperPointNet) on the KITTI fixtures'
    PNG files at `img_size` 320 and N = 1 (the identity view alone, so
    that no random draw enters), every point kept: the JAX CLI's files,
    points and scores. Random weights put every heatmap value near 1/65,
    next to the 0.015 threshold, where f32 rounding decides; the detector
    head's weights are scaled up so that the scores spread. On a CPU host
    both CLIs default to their host-warp adaptation; both are sent down
    their device path, which this test holds (the host path:
    `tests/test_torch_host_export.py`)."""
    import yolopoint_tpu.data.native as jax_native
    from yolopoint_tpu_torch.export import homography_adaptation as port_ha

    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_ha, "default_host_warp", lambda device: False)
    cfg = load_config(REPO / "configs" / "kitti_export.yaml")
    cfg.pop("pretrained")
    cfg["export"]["num_homographies"] = 1
    cfg["model"]["superpoint"]["top_k"] = 30720  # every pixel: no cut among tied scores
    save_config(cfg, tmp_path / "kitti.yaml")
    torch.manual_seed(0)
    model = build_model("SuperPointNet", None, device="cpu")
    with torch.no_grad():  # a peaked detector head: scores far apart, few near 0.015
        model.convPb.weight.mul_(100.0)
        model.convPb.bias.mul_(100.0)
    weights = tmp_path / "w.pt"
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "model_name": "SuperPointNet"}, weights)
    args = ["--config", str(tmp_path / "kitti.yaml"), "--weights", str(weights),
            "--data_root", str(REPO / "datasets" / "fixtures"), "--action", "val"]
    paths = cli.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli.main(args + ["--output", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in paths) == names == ["val_000.npz", "val_001.npz"]
    for name in names:
        got, want = (np.load(tmp_path / d / name)["pts"] for d in ("port", "jax"))
        assert got.shape == want.shape and len(got) > 0
        # the same points; random weights tie scores, so their order is free
        got, want = (a[np.lexsort((a[:, 0], a[:, 1]))] for a in (got, want))
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["YOLOPointv52", "YOLOPointDet", "SuperPointNet", "YOLOv8Point"])
def test_hpatches_runner_builds_every_family(name, tmp_path, monkeypatch):
    """`hpatches_runner`: a weights file's metadata picks the family (over
    `--model`), `--model SuperPointNet` needs no version, and two pairs of
    `datasets/hpatches_synth` give finite metrics on the CPU."""
    from yolopoint_tpu_torch.evaluation import hpatches_runner

    model = build_model(name, "n", nc=2, device="cpu")
    weights = tmp_path / "w.pt"
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()),
                "names": ["a", "b"], "version": "n", "model_name": name}, weights)
    pipe = hpatches_runner.build_pipeline(weights, "YOLOPoint", "s", device="cpu")
    assert type(pipe.model).__name__ == name
    assert pipe.compute_dtype == torch.bfloat16
    built = []
    real = hpatches_runner.build_pipeline
    monkeypatch.setattr(hpatches_runner, "build_pipeline",
                        lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    argv = ["--data", str(REPO / "datasets" / "hpatches_synth"), "--max-pairs", "2",
            "--device", "cpu", "--size", "64", "96"]
    extra = ["--model", name, "--version", "q"] if name == "SuperPointNet" else [
        "--weights", str(weights)]
    metrics = hpatches_runner.main(argv + extra)
    assert type(built[-1].model).__name__ == name
    assert metrics["num_pairs"] == 2 and all(np.isfinite(v) for v in metrics.values())
