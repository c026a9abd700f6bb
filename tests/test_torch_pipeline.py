"""The serving slice end to end: the port's `InferencePipeline` against the
JAX package's, on the CPU.

YOLOPoint-n (nc=3) with the same weights in both packages (BN statistics
made non-trivial), the same uint8 128x128 batch, f32 heatmaps, and a box
gate lowered to 0.001 so that the box NMS sees real candidates.
  keypoints: equal point sets, scores within the keys' 2^-19 relative
             quantization (the port always packs keys);
  boxes:     equal valid sets after sorting by score, coordinates <= 1e-3 px;
  descriptors at the same points: <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomize_bn
from yolopoint_tpu.frontend.pipeline import InferencePipeline as JaxPipeline
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu_torch.frontend import InferencePipeline, preprocess_frame
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict

torch.set_num_threads(1)

CONFIG = {"detection_threshold": 0.015, "nms": 4, "top_k": 600, "border_remove": 4,
          "conf_thresh": 0.001, "iou_thresh": 0.45, "max_det": 300, "max_nms": 1024}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    jmodel = jax_build_model("YOLOPoint", "n", nc=3)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)), train=False)
    variables = randomize_bn(variables, rng)
    want = {k: np.asarray(v) for k, v in JaxPipeline(jmodel, variables, CONFIG)(images).items()}

    model = build_model("YOLOPoint", "n", nc=3, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    pipe = InferencePipeline(model, CONFIG, device="cpu")
    got = {k: v.numpy() for k, v in pipe(images).items()}
    return got, want, pipe, images


def test_outputs_have_the_jax_shapes_and_dtypes(runs):
    got, want, _, _ = runs
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert got[k].dtype == w.dtype, k


def test_keypoints_match(runs):
    got, want, _, _ = runs
    for b in range(2):
        ok, jok = got["kp_valid"][b], want["kp_valid"][b]
        assert ok.sum() == jok.sum() > 50
        ours = dict(zip(map(tuple, got["keypoints"][b][ok]), got["kp_scores"][b][ok]))
        theirs = dict(zip(map(tuple, want["keypoints"][b][jok]), want["kp_scores"][b][jok]))
        assert ours.keys() == theirs.keys()
        for p, s in theirs.items():
            assert abs(ours[p] - s) <= s * 2.0**-19


def test_boxes_match(runs):
    got, want, _, _ = runs
    np.testing.assert_array_equal(got["box_n_candidates"], want["box_n_candidates"])
    for b in range(2):
        ok, jok = got["box_valid"][b], want["box_valid"][b]
        assert ok.sum() == jok.sum() > 0
        order = np.argsort(-got["box_scores"][b][ok], kind="stable")
        jorder = np.argsort(-want["box_scores"][b][jok], kind="stable")
        assert np.abs(got["boxes"][b][ok][order] - want["boxes"][b][jok][jorder]).max() <= 1e-3
        np.testing.assert_array_equal(got["box_classes"][b][ok][order],
                                      want["box_classes"][b][jok][jorder])
        np.testing.assert_allclose(got["box_scores"][b][ok][order],
                                   want["box_scores"][b][jok][jorder], rtol=1e-5)


def test_descriptors_match(runs):
    got, want, _, _ = runs
    for b in range(2):
        where = {tuple(p): i for i, (p, v) in
                 enumerate(zip(want["keypoints"][b], want["kp_valid"][b])) if v}
        idx = np.flatnonzero(got["kp_valid"][b])
        jidx = [where[tuple(p)] for p in got["keypoints"][b][idx]]
        err = np.abs(got["descriptors"][b][idx] - want["descriptors"][b][jidx]).max()
        assert err <= 1e-4


def test_filter_pts_in_boxes(runs):
    got, _, pipe, images = runs
    filt = InferencePipeline(pipe.model, dict(CONFIG, filter_pts_in_boxes=True), device="cpu")
    out = {k: v.numpy() for k, v in filt(images).items()}
    np.testing.assert_array_equal(out["keypoints"], got["keypoints"])
    assert (out["kp_valid"] <= got["kp_valid"]).all()
    for b in range(2):
        x, y = out["keypoints"][b][out["kp_valid"][b]].T
        for x1, y1, x2, y2 in out["boxes"][b][out["box_valid"][b]]:
            assert not ((x >= x1) & (x <= x2) & (y >= y1) & (y <= y2)).any()


def test_process_frame_shifts_back_to_the_frame(runs):
    _, _, pipe, images = runs
    frame = np.zeros((140, 150, 3), np.uint8)
    frame[6:134, 11:139] = images[0]  # center crop of 140x150 to 128x128
    img, (top, left), ratio = preprocess_frame(frame)
    assert (top, left, ratio) == (6, 11, 1.0) and img.shape == (128, 128, 3)
    out = pipe.process_frame(frame)
    direct = {k: v[0].numpy() for k, v in pipe(img[None]).items()}
    np.testing.assert_array_equal(out["keypoints"], direct["keypoints"] + [11, 6])
    np.testing.assert_array_equal(out["boxes"], direct["boxes"] + [11, 6, 11, 6])
    np.testing.assert_array_equal(out["descriptors"], direct["descriptors"])


def test_pipeline_defaults_to_the_gpu(runs, monkeypatch):
    _, _, pipe, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferencePipeline(pipe.model, CONFIG)
