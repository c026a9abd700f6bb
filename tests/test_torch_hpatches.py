"""The port's HPatches path against the JAX package's, on the CPU.

* `_imread` against `cv2.imread` on `datasets/hpatches_synth` files and on
  written files whose channels differ (P6; P5; a header comment): equal.
* `HPatches` items against the JAX class at 256x320 and 480x640: equal
  (the port's uint8 INTER_LINEAR is OpenCV's fixed-point arithmetic).
* `match_average_precision` and `_normalized_from_pixel_h`: equal.
* The trained checkpoint `artifacts/synth_r5_pseudo_ext/best`, converted
  in-process as `tools/jax_checkpoint_to_torch.py` converts it: both
  packages' `evaluate_hpatches` in f32 on the first 10 pairs at 256x320,
  `cv2` hidden from the JAX runner so that both estimate homographies with
  the same numpy RANSAC (the port does not use OpenCV). Every metric within
  1e-6 (measured: equal), although the port's keypoint scores carry the
  2^-19 key quantization of K1 at tile-aligned shapes and the JAX CPU
  path's do not.
"""

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.data.datasets import HPatches as JaxHPatches
from yolopoint_tpu.evaluation import hpatches_runner as jax_runner
from yolopoint_tpu.frontend.pipeline import InferencePipeline as JaxPipeline
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import load_weights as jax_load_weights
from yolopoint_tpu.models.convert import variables_to_torch_state_dict
from yolopoint_tpu_torch.data.datasets import HPatches, _imread
from yolopoint_tpu_torch.evaluation import hpatches_runner
from yolopoint_tpu_torch.frontend import InferencePipeline
from yolopoint_tpu_torch.models import (build_model, reference_to_state_dict,
                                        state_dict_to_reference)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "datasets" / "hpatches_synth"
RUN = REPO / "artifacts" / "synth_r5_pseudo_ext" / "best"
PAIRS = 10


@pytest.mark.parametrize("name", ["i_synth000/1.ppm", "i_synth003/4.ppm", "v_synth002/1.ppm",
                                  "v_synth015/6.ppm"])
def test_imread_matches_cv2_on_the_dataset(name):
    path = str(DATA / name)
    np.testing.assert_array_equal(_imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("ext", [".ppm", ".pgm"])
def test_imread_matches_cv2_on_distinct_channels(tmp_path, ext):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    img[..., 0], img[..., 2] = 10, 250  # B and R far apart: a swapped order shows
    path = str(tmp_path / f"img{ext}")
    assert cv2.imwrite(path, img if ext == ".ppm" else img[..., 1])
    got = _imread(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR))
    if ext == ".ppm":
        np.testing.assert_array_equal(got, img)


def test_imread_header_comment_and_refusals(tmp_path):
    rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# made by hand\n3 2\n255\n" + rgb.tobytes())
    np.testing.assert_array_equal(_imread(str(path)), rgb[..., ::-1])
    np.testing.assert_array_equal(_imread(str(path)), cv2.imread(str(path), cv2.IMREAD_COLOR))
    (tmp_path / "a.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")  # ASCII PPM
    (tmp_path / "b.ppm").write_bytes(b"P6\n1 1\n65535\n" + bytes(6))  # 16-bit
    (tmp_path / "t.ppm").write_bytes(b"P6\n4 4\n255\n" + bytes(5))  # truncated
    for name in ("a.ppm", "b.ppm", "t.ppm"):
        with pytest.raises(ValueError):
            _imread(str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        _imread(str(tmp_path / "missing.ppm"))


@pytest.mark.parametrize("size", [(256, 320), (480, 640)])
def test_items_match_jax(size):
    got, want = HPatches(DATA, size), JaxHPatches(DATA, size)
    assert len(got) == len(want) == 120
    for i in (0, 37, 64, 119):
        a, b = got[i], want[i]
        assert a["name"] == b["name"]
        for k in ("image", "warped_image", "homography_pix"):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_metric_helpers_match_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 17, 200):
        dist = rng.uniform(0, 2, n)
        correct = rng.uniform(size=n) < 0.6
        assert hpatches_runner.match_average_precision(dist, correct) == \
            jax_runner.match_average_precision(dist, correct)
    H = np.eye(3) + rng.normal(0, 0.05, (3, 3))
    np.testing.assert_array_equal(hpatches_runner._normalized_from_pixel_h(H, (256, 320)),
                                  jax_runner._normalized_from_pixel_h(H, (256, 320)))


@pytest.fixture(scope="module")
def trained():
    loaded = jax_load_weights(RUN)
    meta = loaded["meta"]
    state = reference_to_state_dict(variables_to_torch_state_dict(loaded["variables"]))
    return loaded["variables"], state, meta


def test_trained_checkpoint_metrics_match_jax(trained, monkeypatch):
    variables, state, meta = trained
    nc = len(meta["names"])
    cfg = {"detection_threshold": 0.015}
    jax_pipe = JaxPipeline(jax_build_model("YOLOPoint", meta["version"], nc=nc), variables, cfg)
    model = build_model("YOLOPoint", meta["version"], nc=nc, device="cpu")
    model.load_state_dict(state)
    pipe = InferencePipeline(model, cfg, device="cpu")
    jax_pairs = [JaxHPatches(DATA, (256, 320))[i] for i in range(PAIRS)]  # read with cv2
    got = hpatches_runner.evaluate_hpatches(pipe, HPatches(DATA, (256, 320)), max_pairs=PAIRS)
    monkeypatch.setitem(sys.modules, "cv2", None)  # the JAX runner's numpy RANSAC
    want = jax_runner.evaluate_hpatches(jax_pipe, jax_pairs)
    assert got.keys() == want.keys() and got["num_pairs"] == PAIRS
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=0, abs=1e-6), k
    assert got["repeatability"] > 0.5 and got["match_mAP"] > 0.5  # trained, not random


def test_cli_runs_on_a_converted_file(tmp_path, trained):
    _, state, meta = trained
    path = tmp_path / "r5.pt"
    torch.save({"model_state_dict": state_dict_to_reference(state),
                **{k: meta[k] for k in ("names", "version", "model_name")}}, path)
    out = tmp_path / "metrics.json"
    metrics = hpatches_runner.main(["--data", str(DATA), "--weights", str(path), "--max-pairs",
                                    "2", "--device", "cpu", "--json", str(out)])
    assert metrics["num_pairs"] == 2 and out.exists()
    assert all(np.isfinite(v) for v in metrics.values())
