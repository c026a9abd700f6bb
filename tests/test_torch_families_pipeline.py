"""The serving pipeline for the other four model families: the port's
`InferencePipeline` against the JAX package's, on the CPU.

Each family at version n (nc=3 where it has a Detect head), the same weights
in both packages (BN statistics made non-trivial), the same uint8 128x128
batch, f32 heatmaps, the exact f32 descriptor sampling on the JAX side and a
box gate lowered to 0.001 so that box NMS sees real candidates.
  keys:        exactly the JAX pipeline's (no box keys for YOLOPointDet and
               SuperPointNet), with its shapes and dtypes;
  keypoints:   equal point sets, scores within the keys' 2^-19 relative
               quantization;
  descriptors: at the same points, within 1e-5;
  boxes:       both packages' box NMS on the same decoded predictions (the
               port's raw Detect levels decoded once): equal valid sets,
               classes and scores, coordinates within 1e-3 px. (With random
               weights neighbouring anchors predict nearly the same box with
               scores ~1e-10 apart, so an ulp of forward difference between
               the packages may reorder them.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomize_bn
from yolopoint_tpu.frontend.pipeline import InferencePipeline as JaxPipeline
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.ops import nms as jnms
from yolopoint_tpu_torch.frontend import InferencePipeline, preprocess_frame
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.models.detect import decode_levels
from yolopoint_tpu_torch.ops.nms import batched_box_nms

torch.set_num_threads(1)

CONFIG = {"detection_threshold": 0.015, "nms": 4, "top_k": 600, "border_remove": 4,
          "conf_thresh": 0.001, "iou_thresh": 0.45, "max_det": 300, "max_nms": 1024,
          "exact_descriptors": True}
FAMILIES = ("YOLOPointv52", "YOLOPointDet", "SuperPointNet", "YOLOv8Point")
KP_KEYS = {"keypoints", "kp_scores", "kp_valid", "descriptors"}
BOX_KEYS = {"boxes", "box_scores", "box_classes", "box_valid", "box_n_candidates"}


@pytest.fixture(scope="module", params=FAMILIES)
def runs(request):
    name = request.param
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    jmodel = jax_build_model(name, "n", nc=3)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 128, 128, 3)), train=False)
    variables = randomize_bn(dict(variables, batch_stats=variables.get("batch_stats", {})), rng)
    want = {k: np.asarray(v) for k, v in JaxPipeline(jmodel, variables, CONFIG)(images).items()}

    model = build_model(name, "n", nc=3, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    pipe = InferencePipeline(model, CONFIG, device="cpu")
    got = {k: v.numpy() for k, v in pipe(images).items()}
    return name, got, want, pipe, images


def test_outputs_have_the_jax_keys_shapes_and_dtypes(runs):
    name, got, want, _, _ = runs
    assert set(got) == set(want)
    has_boxes = name in ("YOLOPointv52", "YOLOv8Point")
    assert set(want) == (KP_KEYS | BOX_KEYS if has_boxes else KP_KEYS)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert got[k].dtype == w.dtype, k


def test_keypoints_match(runs):
    _, got, want, _, _ = runs
    for b in range(2):
        ok, jok = got["kp_valid"][b], want["kp_valid"][b]
        assert ok.sum() == jok.sum() > 50
        ours = dict(zip(map(tuple, got["keypoints"][b][ok]), got["kp_scores"][b][ok]))
        theirs = dict(zip(map(tuple, want["keypoints"][b][jok]), want["kp_scores"][b][jok]))
        assert ours.keys() == theirs.keys()
        for p, s in theirs.items():
            assert abs(ours[p] - s) <= s * 2.0**-19


def test_descriptors_match(runs):
    _, got, want, _, _ = runs
    for b in range(2):
        where = {tuple(p): i for i, (p, v) in
                 enumerate(zip(want["keypoints"][b], want["kp_valid"][b])) if v}
        idx = np.flatnonzero(got["kp_valid"][b])
        jidx = [where[tuple(p)] for p in got["keypoints"][b][idx]]
        err = np.abs(got["descriptors"][b][idx] - want["descriptors"][b][jidx]).max()
        assert err <= 1e-5


def test_boxes_match_on_the_same_predictions(runs, monkeypatch):
    name, _, _, pipe, images = runs
    if pipe._anchors_ps is None:
        assert not hasattr(pipe.model, "Detect")
        return
    # ties ordered lowest index first on the JAX side too (tests/test_torch_box_nms.py)
    monkeypatch.setattr(jnms, "exact_top_k", lambda x, k: jax.lax.top_k(x, k))
    with torch.no_grad():
        raw = pipe.forward(torch.from_numpy(images))["objects"]
    pred = decode_levels(raw, pipe._anchors_ps, pipe._strides)
    kw = dict(conf_thres=CONFIG["conf_thresh"], iou_thres=CONFIG["iou_thresh"],
              max_det=CONFIG["max_det"], max_nms=CONFIG["max_nms"])
    got = {k: v.numpy() for k, v in batched_box_nms(pred, **kw).items()}
    want = {k: np.asarray(v) for k, v in jnms.batched_box_nms(jnp.asarray(pred.numpy()),
                                                               **kw).items()}
    for b in range(2):
        ok, jok = got["valid"][b], want["valid"][b]
        assert ok.sum() == jok.sum() > 0
        np.testing.assert_array_equal(got["classes"][b][ok], want["classes"][b][jok])
        np.testing.assert_allclose(got["scores"][b][ok], want["scores"][b][jok], rtol=1e-6)
        assert np.abs(got["boxes"][b][ok] - want["boxes"][b][jok]).max() <= 1e-3


def test_filter_and_process_frame(runs):
    """`filter_pts_in_boxes` suppresses keypoints in boxes where there are
    boxes and is a no-op otherwise; `process_frame` shifts what it has."""
    name, got, _, pipe, images = runs
    filt = InferencePipeline(pipe.model, dict(CONFIG, filter_pts_in_boxes=True), device="cpu")
    out = {k: v.numpy() for k, v in filt(images).items()}
    assert set(out) == set(got)
    if "boxes" in out:
        assert (out["kp_valid"] <= got["kp_valid"]).all()
    else:
        np.testing.assert_array_equal(out["kp_valid"], got["kp_valid"])
    frame = np.zeros((140, 150, 3), np.uint8)
    frame[6:134, 11:139] = images[0]
    shifted = pipe.process_frame(frame)
    img, _, _ = preprocess_frame(frame)
    direct = {k: v[0].numpy() for k, v in pipe(img[None]).items()}
    assert set(shifted) == set(got)
    np.testing.assert_array_equal(shifted["keypoints"], direct["keypoints"] + [11, 6])
    if "boxes" in shifted:
        np.testing.assert_array_equal(shifted["boxes"], direct["boxes"] + [11, 6, 11, 6])
