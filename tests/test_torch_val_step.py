"""The port's val step and `TrainAgent.validate` against the JAX package on
the CPU in f32: YOLOPoint-n, 128x128, B=2, nc=3 (so box NMS is multi-label
with 3024 candidate slots, beyond the dense 2048: the tiled scan runs), the
val augmentation of `configs/synthetic_s640.yaml`, the JAX package's own
random draws replayed (`tests/torch_replay.py`).

Both start from the same weights (the JAX variables, BatchNorm statistics
made non-trivial). Tolerances:
  losses       1e-4 relative (measured ~1e-6);
  keypoints    equal point sets, scores within the keys' 2^-19 relative
               quantization (the port packs keys at tile-aligned shapes,
               the JAX package's CPU path does not);
  descriptors  at the same points within 1e-5;
  detections   equal, on the same predictions: the port's box NMS on the
               JAX model's decoded predictions for the val step's base view
               against the JAX box NMS on them, val protocol (conf 0.001,
               IoU 0.6, 300 detections, 30000 candidates, multi-label).
End to end the two forwards differ by ~1e-7 relative, and at conf 0.001
with random weights neighbouring anchors predict nearly the same box with
scores ~1e-8 apart, so two detections can trade places in the score order.
The end-to-end detections are therefore held as sets, as the serving test
holds them: equal candidate and detection counts, and each detection of
one side matched by one of the other (same class, box within 1e-3, score
within 1e-5 relative).

`validate` is held against the JAX agent's own `validate` code run on the
port's decoded outputs (the JAX agent's val step replaced by one that
returns them), the JAX side with `cv2` (`cv2.findHomography`, as its users
run it), the port with its OpenCV-free copy of that estimate: every scalar
equal, but the median corner error of the estimated homographies, within
1e-3 px (the refinement's H agrees with cv2's to ~1e-7 of its largest
entry, `tests/test_torch_ransac.py`).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_model import randomize_bn
from tests.torch_replay import val_step_draws
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.ops.nms import batched_box_nms as jax_batched_box_nms
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu.training.agent import TrainAgent as JaxTrainAgent
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.ops.nms import batched_box_nms
from yolopoint_tpu_torch.training import TrainAgent
from yolopoint_tpu_torch.training import step as tstep

torch.set_num_threads(1)

NC, B, HW = 3, 2, 128
S640 = chip_smoke.s640_train_config()
VAL_AUG = S640["data"]["val_augmentation"]
WEIGHTS = dict(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce", det_loss_type="ce",
               num_samples_per_image=60, num_masked_non_matches_per_match=10)
OBJ = dict(box=0.05, obj=1.0, cls=0.5, anchor_t=4.0)
VAL_NMS = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, multi_label=True)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.integers(0, NC, (B, 4, 1)), rng.uniform(0.35, 0.65, (B, 4, 2)),
                            rng.uniform(0.15, 0.4, (B, 4, 2))], -1).astype(np.float32)
    return {"image": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
            "points": rng.uniform(0, HW - 1, (B, 24, 2)).astype(np.float32),
            "point_mask": np.ones((B, 24), bool), "boxes": boxes,
            "box_mask": np.ones((B, 4), bool)}


@pytest.fixture(scope="module")
def runs():
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), np.random.default_rng(0))
    batch, key = make_batch(5), jax.random.PRNGKey(21)
    jfn = jstep.make_val_step(jmodel, VAL_AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                              jstep.LossWeights(**WEIGHTS), NC)
    jout = jax.tree_util.tree_map(np.asarray, jfn(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in batch.items()}, key))
    decoded, _ = jax.jit(lambda v, x: jmodel.apply(v, x, train=False, decode=True)["objects"])(
        variables, jnp.asarray(jout["image"]))

    model = build_model("YOLOPoint", "n", nc=NC, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    weights = tstep.LossWeights(**WEIGHTS)
    tfn = tstep.make_val_step(model, VAL_AUG,
                              tstep.rescale_yolo_gains(ObjectLossConfig(**OBJ), NC, HW),
                              weights, NC)
    draws = val_step_draws(key, batch["image"].shape, VAL_AUG, weights)
    tout = tfn(None, {k: torch.from_numpy(v) for k, v in batch.items()}, draws)
    tout = jax.tree_util.tree_map(lambda t: t.numpy(), tout)
    return {"jout": jout, "tout": tout, "decoded": np.asarray(decoded)}


def test_losses_match(runs):
    j, t = runs["jout"]["losses"], runs["tout"]["losses"]
    assert set(j) == set(t)
    for k in j:
        assert abs(t[k] - j[k]) <= 1e-4 * max(abs(j[k]), 1e-6), (k, t[k], j[k])


def test_views_match(runs):
    j, t = runs["jout"], runs["tout"]
    assert np.abs(t["image"] - j["image"]).max() <= 2e-5
    for k in ("labels_2d", "box_mask"):
        np.testing.assert_array_equal(t[k], j[k])
    for k in ("boxes", "homography", "inv_homography"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view", ["base", "warped"])
def test_keypoints_and_descriptors_match(runs, view):
    j, t = runs["jout"][view], runs["tout"][view]
    for b in range(B):
        ok, jok = t["valid"][b], j["valid"][b]
        assert ok.sum() == jok.sum() > 50
        ours = {tuple(p): i for i, p in enumerate(t["pts"][b]) if ok[i]}
        theirs = {tuple(p): i for i, p in enumerate(j["pts"][b]) if jok[i]}
        assert ours.keys() == theirs.keys()
        ti = np.array([ours[p] for p in theirs])
        ji = np.array(list(theirs.values()))
        assert (np.abs(t["scores"][b][ti] - j["scores"][b][ji]) <= j["scores"][b][ji] * 2.0**-19).all()
        assert np.abs(t["desc"][b][ti] - j["desc"][b][ji]).max() <= 1e-5


def test_detections_equal_on_the_same_predictions(runs):
    x = runs["decoded"]
    got = batched_box_nms(torch.from_numpy(x.copy()), **VAL_NMS)
    want = {k: np.asarray(v) for k, v in jax_batched_box_nms(jnp.asarray(x), **VAL_NMS).items()}
    assert x.shape[1] * NC > 2048  # the tiled scan ran
    np.testing.assert_array_equal(got["n_candidates"].numpy(), want["n_candidates"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    ok = want["valid"]
    assert ok.sum() > 100
    np.testing.assert_array_equal(got["classes"].numpy()[ok], want["classes"][ok])
    np.testing.assert_array_equal(got["scores"].numpy(), want["scores"])
    np.testing.assert_allclose(got["boxes"].numpy()[ok], want["boxes"][ok], rtol=0, atol=1e-5)


@pytest.mark.parametrize("view", ["base", "warped"])
def test_detections_end_to_end(runs, view):
    j, t = runs["jout"][view]["det"], runs["tout"][view]["det"]
    np.testing.assert_array_equal(t["n_candidates"], j["n_candidates"])
    np.testing.assert_array_equal(t["valid"].sum(1), j["valid"].sum(1))
    for b in range(B):
        tb, tc = t["boxes"][b][t["valid"][b]], t["classes"][b][t["valid"][b]]
        jb, jc = j["boxes"][b][j["valid"][b]], j["classes"][b][j["valid"][b]]
        js, ts = j["scores"][b][j["valid"][b]], t["scores"][b][t["valid"][b]]
        close = ((np.abs(jb[:, None] - tb[None]).max(-1) <= 1e-3) & (jc[:, None] == tc[None])
                 & (np.abs(js[:, None] - ts[None]) <= 1e-5 * js[:, None]))
        assert len(jb) > 100 and close.any(1).all() and close.any(0).all()


def test_validate_scalars_equal_jax_agent_code(tmp_path):
    """The port's `validate` against the JAX agent's `validate` applied to
    the very outputs the port's val step produced."""
    config = {
        "names": ["a", "b", "c"],
        "model": {"name": "YOLOPoint", "version": "n",
                  "superpoint": {"detection_threshold": 0.015, "nms": 4, "top_k": 300,
                                 "det_loss": "ce",
                                 "sparse_loss": {"params": {"num_samples_per_image": 60,
                                                            "num_masked_non_matches_per_match": 10}}},
                  "yolo": {"conf_thresh": 0.001, "iou_thresh": 0.6}},
        "training_params": {"train_batch_size": 2, "ema": {"enable": True}},
        "extended_val_sample_size": 3,
        "data": {"augmentation": S640["data"]["augmentation"],
                 "val_augmentation": VAL_AUG},
    }
    batches = [make_batch(7), make_batch(8)]
    agent = TrainAgent(config, tmp_path, batches, batches, seed=3, device="cpu")
    recorded = []
    val_step = agent.val_step

    def recording(params, batch, draws, on_phase=None):
        out = val_step(params, batch, draws, on_phase)
        recorded.append(jax.tree_util.tree_map(lambda t: t.numpy(), out))
        return out

    agent.val_step = recording
    got = agent.validate(0)

    class _Writer:
        def write(self, *args, **kwargs):
            pass

    replay = iter(recorded)
    fake = types.SimpleNamespace(
        config={}, val_loader=[dict(b) for b in batches], nc=NC, confusion=None,
        state=types.SimpleNamespace(ema_params={}, params={}, batch_stats={}),
        _val_step=lambda *args: next(replay), val_seed=agent.val_seed,
        extended_val_n=agent.extended_val_n, metrics=_Writer(), output_dir=None, global_step=0)
    want = JaxTrainAgent.validate(fake, 0)  # with cv2, as the JAX package's users run it
    assert set(got) == set(want)
    for k in want:
        if k == "homography_corner_dist":
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-3), k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    assert sum(int(r["base"]["det"]["valid"].sum()) for r in recorded) > 0
    np.testing.assert_array_equal(agent.confusion.matrix, fake.confusion.matrix)
    assert got["repeatability"] > 0 and np.isfinite(got["fitness"])
