"""The port's image-file datasets (`Kitti`, `Campus`, `Coco`) against the JAX
package's on the committed fixtures (`datasets/fixtures`): `get` in host
crop, device crop, letterbox and mosaic mode, `iter_export`, the DontCare
removal, the image and label caches, and the loader's batches. COCO is
read both ways: its committed JPEG files as they are, and transcoded to
PNG by `cv2` inside the test (the PNG path). The JAX datasets draw from
the global `np.random`; the port from a `RandomState` of the same seed, so
crop corners and mosaic tiles agree.

Images bit-equal; boxes and points within 1e-6.
"""

import copy
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.data import datasets as jds
from yolopoint_tpu.data import native as jnative
from yolopoint_tpu_torch.data import datasets as tds
from yolopoint_tpu_torch.data.loader import DataLoader, pad_collate

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parents[1] / "datasets" / "fixtures"
NAMES = ["car", "person", "DontCare"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The fixtures, with COCO's JPEGs as PNG and KITTI copied as Campus."""
    out = tmp_path_factory.mktemp("datasets")
    shutil.copytree(FIXTURES / "kitti", out / "kitti")
    shutil.copytree(FIXTURES / "kitti", out / "campus")
    shutil.copytree(FIXTURES / "coco", out / "coco", ignore=shutil.ignore_patterns("*.jpg"))
    for jpg in (FIXTURES / "coco" / "images").rglob("*.jpg"):
        dst = out / "coco" / jpg.relative_to(FIXTURES / "coco").with_suffix(".png")
        cv2.imwrite(str(dst), cv2.imread(str(jpg)))
    return out


def config(root: Path, name: str, img_size: int, crop=None, device_crop=False, mosaic=0.0,
           cache=False) -> dict:
    cfg = {"dataset": name, "suffix": ".png", "preprocessing": {"img_size": img_size},
           "labels": {"points": str(root / name / "points")}, "cache_images": cache,
           "augmentation": {"mosaic": mosaic}}
    if crop:
        cfg["augmentation"]["homographic"] = {"cropHW": list(crop), "device_crop": device_crop}
    return cfg


def both(cfg, root, action="train"):
    assert jnative.available()
    return (jds.build_dataset(copy.deepcopy(cfg), action, NAMES, root=str(root)),
            tds.build_dataset(copy.deepcopy(cfg), action, NAMES, root=str(root), device="cpu"))


def assert_same_sample(got: dict, want: dict):
    assert set(got) == set(want)
    assert got["image"].dtype == want["image"].dtype == np.float32
    np.testing.assert_array_equal(got["image"], want["image"])
    for k in ("boxes", "points", "crop_yx", "mosaic_crop_yx"):
        if k in want:
            assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    assert got["pad"] == want["pad"] and got["name"] == want["name"]


def samples_with_seeds(jax_ds, port_ds, seed0: int, mosaic=None):
    out = []
    for i in range(len(port_ds)):
        np.random.seed(seed0 + i)
        want = jax_ds.get(i, mosaic=mosaic)
        got = port_ds.get(i, mosaic=mosaic, rng=np.random.RandomState(seed0 + i))
        out.append((got, want))
    return out


# (dataset, img_size, crop, device crop): KITTI shrunk (area) and enlarged
# (bilinear) around the fixtures' 96x320 frames; COCO letterboxed both ways
CASES = {
    "kitti_host_crop": ("kitti", 256, (64, 192), False),
    "kitti_host_crop_up": ("kitti", 480, (128, 384), False),
    "kitti_device_crop": ("kitti", 256, (64, 192), True),
    "kitti_device_crop_up": ("kitti", 480, (128, 384), True),
    "campus_device_crop": ("campus", 256, (64, 192), True),
    "coco_letterbox": ("coco", 64, None, False),
    "coco_letterbox_up": ("coco", 160, None, False),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("action", ["train", "val"])
def test_get_equals_jax(root, case, action):
    name, size, crop, dev = CASES[case]
    jd, td = both(config(root, name, size, crop, dev), root, action)
    assert len(jd) == len(td) > 0 and jd.img_paths == td.img_paths
    pairs = samples_with_seeds(jd, td, 100, mosaic=False)
    for got, want in pairs:
        assert_same_sample(got, want)
    if name == "kitti":  # DontCare (class 2) removed; Campus keeps it
        assert all(2.0 not in got["boxes"][:, 0] for got, _ in pairs)
    if crop and action == "train":  # the corners are drawn, and they differ
        corners = {tuple(g.get("crop_yx", ())) for g, _ in pairs}
        assert not dev or len(corners) > 1


def test_campus_keeps_dontcare(root):
    jd, td = both(config(root, "campus", 256, (64, 192), True), root)
    boxes = [td.get(i, mosaic=False)["boxes"] for i in range(len(td))]
    assert any(2.0 in b[:, 0] for b in boxes)


@pytest.mark.parametrize("case", ["kitti_host_crop", "kitti_device_crop", "coco_letterbox"])
def test_mosaic_equals_jax(root, case):
    name, size, crop, dev = CASES[case]
    jd, td = both(config(root, name, size, crop, dev, mosaic=1.0), root)
    for got, want in samples_with_seeds(jd, td, 7, mosaic=True):
        assert_same_sample(got, want)
        # a (2H, 2W) canvas and its centre crop's corner (H // 2, W // 2)
        assert got["image"].shape[0] // 4 == int(got["mosaic_crop_yx"][0])


def test_per_sample_bernoulli_equals_jax(root):
    """`get` without `mosaic`: the draw that picks a mosaic, then its tiles."""
    jd, td = both(config(root, "kitti", 256, (64, 192), True, mosaic=0.5), root)
    kinds = []
    for got, want in samples_with_seeds(jd, td, 30, mosaic=None):
        assert_same_sample(got, want)
        kinds.append("mosaic_crop_yx" in got)
    assert len(set(kinds)) == 2, kinds


@pytest.mark.parametrize("name,size", [("kitti", 256), ("kitti", 480), ("coco", 96)])
def test_iter_export_equals_jax(root, name, size):
    jd, td = both(config(root, name, size), root)
    got, want = list(td.iter_export()), list(jd.iter_export())
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == len(td)
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32 and a.shape == b.shape and a.shape[0] % 32 == 0
        np.testing.assert_array_equal(a, b)


def test_caches_keep_samples(root):
    jd, td = both(config(root, "kitti", 256, (64, 192), False, cache=True), root, "val")
    first = [td.get(i, mosaic=False) for i in range(len(td))]
    assert len(td._img_cache) == len(td._label_cache) == len(td)
    again = [td.get(i, mosaic=False) for i in range(len(td))]
    for a, b, i in zip(first, again, range(len(td))):
        assert_same_sample(a, b)
        assert_same_sample(a, jd.get(i, mosaic=False))
    td._img_cache[0][:] = 0  # a cached image is copied out, never handed out
    assert first[0]["image"].any()


def test_loader_batches_keep_crop_keys(root):
    _, td = both(config(root, "kitti", 256, (64, 192), True, mosaic=0.5), root)
    loader = DataLoader([td], batch_size=2, shuffle=True, seed=3, num_workers=2)
    kinds = set()
    for _ in range(4):
        for batch in loader:
            key = "mosaic_crop_yx" if "mosaic_crop_yx" in batch else "crop_yx"
            assert batch[key].shape == (2, 2) and batch["image"].shape[0] == 2
            kinds.add(key)
    assert kinds == {"crop_yx", "mosaic_crop_yx"}
    # each sample's stream is its own (seed, epoch, batch, slot): an epoch replays
    a = [td.get(0, mosaic=False, rng=loader.sample_rng(1, 0, 1))["crop_yx"] for _ in range(2)]
    np.testing.assert_array_equal(a[0], a[1])
    batch = pad_collate([td.get(i, mosaic=False, rng=np.random.RandomState(i))
                         for i in range(2)])
    assert batch["crop_yx"].dtype == np.float32


def jpeg_config(size: int, mosaic: float = 0.0) -> dict:
    """COCO on the committed fixtures' JPEG files, as `configs/coco.yaml` reads them."""
    cfg = config(FIXTURES, "coco", size, mosaic=mosaic)
    cfg["suffix"] = ".jpg"
    return cfg


@pytest.mark.parametrize("mosaic", [False, True])
@pytest.mark.parametrize("action", ["train", "val"])
def test_coco_jpeg_get_equals_jax(action, mosaic):
    """`Coco.get` on the JPEG files themselves, every index of both splits,
    letterboxed to 96 px (shrunk) and 160 px (enlarged), mosaic off and on."""
    for size in (96, 160):
        jd, td = both(jpeg_config(size, 1.0 if mosaic else 0.0), FIXTURES, action)
        assert len(jd) == len(td) == {"train": 5, "val": 3}[action]
        assert all(p.endswith(".jpg") for p in td.img_paths) and jd.img_paths == td.img_paths
        for got, want in samples_with_seeds(jd, td, 40 + size, mosaic=mosaic):
            assert_same_sample(got, want)
            assert len(got["points"]) and len(got["boxes"])


def test_jpeg_and_unknown_inputs_raise(root, tmp_path):
    """A `.jpg` suffix reads (it raised before the JPEG decoder); a dataset
    with no images still raises."""
    jd, td = both(jpeg_config(64), FIXTURES)
    assert len(td) == 5
    np.random.seed(0)
    assert_same_sample(td.get(0, mosaic=False, rng=np.random.RandomState(0)),
                       jd.get(0, mosaic=False))
    with pytest.raises(FileNotFoundError):
        tds.build_dataset(config(tmp_path, "kitti", 64), "train", NAMES, root=str(tmp_path),
                          device="cpu")


def test_train_cli_on_the_kitti_fixtures(tmp_path):
    """`training.cli` on `configs/kitti.yaml` over the KITTI fixtures' PNG
    files, cut to YOLOPoint-n at 320 px with a 64x192 crop, B = 2, one
    epoch, no warm start and no plots: crop and mosaic batches through the
    host loader, the frozen layers unchanged, a validation on the crop."""
    from yolopoint_tpu_torch.training import cli
    from yolopoint_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(Path(__file__).resolve().parents[1] / "configs" / "kitti.yaml")
    cfg.pop("pretrained")
    cfg["val_plots"] = False
    cfg["model"]["version"] = "n"
    cfg["training_params"].update(epochs=1, train_batch_size=2, val_batch_size=2)
    cfg["data"]["preprocessing"]["img_size"] = 320
    cfg["data"]["augmentation"]["homographic"]["cropHW"] = [64, 192]
    cfg["data"]["labels"]["points"] = str(FIXTURES / "kitti" / "points")
    save_config(cfg, tmp_path / "kitti.yaml")
    argv = ["--config", str(tmp_path / "kitti.yaml"), "--output_dir", str(tmp_path / "logs"),
            "--data_root", str(FIXTURES), "--device", "cpu", "--seed", "2"]
    agent = cli.build_agent(argv)
    opt = agent.optimizer
    frozen = {n: p.detach().clone() for n, p, t in zip(opt.names, opt.params, opt.trainable)
              if not t}
    kinds = []
    real = type(agent).step

    def step(self, batch, on_phase=None):
        kinds.append("mosaic_crop_yx" in batch)
        assert not (batch["boxes"][batch["box_mask"]][:, 0] == 7).any()  # DontCare
        return real(self, batch, on_phase)

    type(agent).step = step
    try:
        agent.train()
    finally:
        type(agent).step = real
    assert kinds == [False, True] and len(frozen) == 63  # seed 2: a crop, then a mosaic batch
    assert all(torch.equal(p, dict(zip(opt.names, opt.params))[n]) for n, p in frozen.items())
    done = __import__("json").loads((tmp_path / "logs" / "exp" / "done.json").read_text())
    assert done["last_epoch"] == 0 and np.isfinite(done["best_fitness"])
