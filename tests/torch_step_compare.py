"""One micro-step and one val step of the port against the JAX package's
steps, on the CPU in f32, for one model family and feed; shared by
`tests/test_torch_train_<family>.py` and `tests/test_torch_host_step.py`,
which set `FAMILY` (a `build_model` name, version n) and `HOST_WARP`
(the batches carry the JAX loader's host-warp payload,
`yolopoint_tpu.data.host_augment.host_warp_views`, and both steps build
their views from it).

Both packages start from the same weights (the JAX variables, BatchNorm
statistics made non-trivial), the same 64x64 batches and the JAX
package's own random draws (`tests/torch_replay.py`). Tolerances, those
of `tests/test_torch_train_step.py` and `tests/test_torch_val_step.py`:
losses 1e-4 relative; gradients 1e-3 relative per tensor (the norm of the
difference over the norm; after the first of two accumulated micro-steps
the optimizers hold exactly the gradient); BatchNorm running statistics
1e-5 absolute plus 1e-5 relative; val keypoints the same points with
scores within 2^-19 relative (the port's packed keys), their descriptors
within 1e-5; the val views within 2e-5, label maps and box masks equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_model import randomize_bn
from tests.torch_replay import train_step_draws, val_step_draws
from yolopoint_tpu.data.host_augment import host_warp_views
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.yolopoint import REFERENCE_MODULE_ORDER as J_ORDER
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.training import TrainAgent
from yolopoint_tpu_torch.training import state as tstate
from yolopoint_tpu_torch.training import step as tstep

NC, B, HW = 3, 2, 64
OPT = dict(learning_rate=1e-3, lrf=0.1, total_epochs=2, steps_per_epoch=1, grad_clip=10.0,
           accumulate_steps=2)
AUG = {
    "photometric": {"enable": True,
                    "params": {"random_brightness": {"max_abs_change": 50},
                               "random_contrast": {"strength_range": [0.5, 1.5]},
                               "additive_gaussian_noise": {"stddev_range": [0, 10]},
                               "motion_blur": {"max_kernel_size": 3},
                               "GaussianBlur": {"sigma": 0.2}},
                    "params_light": {"random_brightness": {"max_abs_change": 20}}},
    "homographic": {"enable": True, "valid_border_margin": 3,
                    "params": {"patch_ratio": 0.85, "perspective_amplitude_x": 0.2,
                               "perspective_amplitude_y": 0.2, "scaling_amplitude": 0.2,
                               "max_angle": 1.57}},
    "warped_pair": {"valid_border_margin": 3, "params": {"patch_ratio": 0.85}},
}
VAL_AUG = {"photometric": {"enable": False},
           "homographic": {"enable": False, "valid_border_margin": 3},
           "warped_pair": {"params": {"patch_ratio": 0.85, "max_angle": 0.5}}}
WEIGHTS = dict(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce", det_loss_type="ce",
               num_samples_per_image=40, num_masked_non_matches_per_match=8)
OBJ = dict(box=0.05, obj=1.0, cls=0.5, anchor_t=4.0)
LOSS_KEYS = ("loss", "loss_det", "loss_desc", "loss_obj", "obj_box", "obj_obj", "obj_cls")
FREEZE = "0-20"


def make_batch(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.integers(0, NC, (B, 4, 1)), rng.uniform(0.35, 0.65, (B, 4, 2)),
                            rng.uniform(0.2, 0.4, (B, 4, 2))], -1).astype(np.float32)
    return {"image": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
            "points": rng.uniform(0, HW - 1, (B, 24, 2)).astype(np.float32),
            "point_mask": np.ones((B, 24), bool), "boxes": boxes,
            "box_mask": np.ones((B, 4), bool)}


def feed(batch, aug, host_warp, seed):
    """The batch as the loader hands it: with the host-warp payload when
    `host_warp` (the JAX loader's function, from `default_rng(seed)`)."""
    return host_warp_views(batch, aug, np.random.default_rng(seed)) if host_warp else batch


def _variables(name):
    jmodel = jax_build_model(name, "n", nc=NC)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    variables = randomize_bn(dict(variables, batch_stats=variables.get("batch_stats", {})),
                             np.random.default_rng(0))
    return jmodel, variables


def _to_sd(tree):
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.device_get(tree))).items()}


def run_both(name, host_warp):
    jmodel, variables = _variables(name)
    weights_t = tstep.LossWeights(**WEIGHTS)
    batch = feed(make_batch(5), AUG, host_warp, 1)
    key = jax.random.PRNGKey(14)

    # JAX: one micro-step (accum 2: the accumulator holds its gradient)
    tx = jstate.make_optimizer(**OPT)
    jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, HW, HW, 3), tx=tx,
                                    variables=copy.deepcopy(variables))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jfn = jstep.make_train_step(jmodel, mesh, AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                                jstep.LossWeights(**WEIGHTS), NC, donate=False, accum=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "names"}
    j_state, j_aux = jfn(jst, jbatch, key)

    # the port
    model = build_model(name, "n", nc=NC, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(variables))
    opt = tstate.make_optimizer(model, **OPT)
    tst = tstate.create_train_state(model, opt)
    tfn = tstep.make_train_step(model, AUG, tstep.rescale_yolo_gains(ObjectLossConfig(**OBJ), NC,
                                                                      HW), weights_t, NC, accum=2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items() if k != "names"}
    mode = tstep.batch_mode(tbatch)
    draws = train_step_draws(key, tstep.draw_shape(tbatch), AUG, weights_t, **mode)
    t_aux = tfn(tst, tbatch, draws)

    # the val step, on another batch under the val augmentation
    vbatch = feed(make_batch(6), VAL_AUG, host_warp, 2)
    vkey = jax.random.PRNGKey(21)
    jval = jstep.make_val_step(jmodel, VAL_AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                               jstep.LossWeights(**WEIGHTS), NC, kpt_topk=200)
    jout = jax.tree_util.tree_map(np.asarray, jval(
        variables["params"], variables["batch_stats"],
        {k: jnp.asarray(v) for k, v in vbatch.items()}, vkey))
    vmodel = build_model(name, "n", nc=NC, device="cpu")
    vmodel.load_state_dict(jax_variables_to_state_dict(variables))
    tval = tstep.make_val_step(vmodel, VAL_AUG,
                               tstep.rescale_yolo_gains(ObjectLossConfig(**OBJ), NC, HW),
                               weights_t, NC, kpt_topk=200)
    tv = {k: torch.from_numpy(v) for k, v in vbatch.items()}
    vdraws = val_step_draws(vkey, tstep.draw_shape(tv), VAL_AUG, weights_t, **tstep.batch_mode(tv))
    tout = jax.tree_util.tree_map(lambda t: t.numpy(), tval(None, tv, vdraws))
    return {"j_aux": {k: float(v) for k, v in j_aux.items()},
            "t_aux": {k: float(v) for k, v in t_aux.items()},
            "j_grads": _to_sd({"params": j_state.opt_state.acc_grads}),
            "t_grads": {n: a.numpy() for n, a in zip(opt.names, opt.acc)},
            "j_stats": _to_sd({"params": j_state.params, "batch_stats": j_state.batch_stats}),
            "t_stats": {n: b.numpy() for n, b in model.named_buffers()},
            "jout": jout, "tout": tout, "variables": variables}


@pytest.fixture(scope="module")
def runs(request):
    return run_both(request.module.FAMILY, request.module.HOST_WARP)


def test_train_losses_match(runs):
    for k in LOSS_KEYS:
        ref, got = runs["j_aux"][k], runs["t_aux"][k]
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-6), (k, got, ref)
    assert runs["t_aux"]["nonfinite_skip"] == 0.0 == runs["j_aux"]["nonfinite_skip"]
    assert np.isfinite(runs["t_aux"]["loss"]) and runs["t_aux"]["loss_desc"] > 0


def test_gradients_match(runs):
    ref, got = runs["j_grads"], runs["t_grads"]
    assert set(ref) == set(got)
    worst = max((float(np.linalg.norm(got[n] - ref[n]) / max(np.linalg.norm(ref[n]), 1e-12)), n)
                for n in ref)
    assert worst[0] <= 1e-3, worst


def test_batchnorm_statistics_match(runs):
    ref, got = runs["j_stats"], runs["t_stats"]
    names = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    for n in names:
        np.testing.assert_allclose(got[n], ref[n], atol=1e-5, rtol=1e-5, err_msg=n)


def test_val_step_matches(runs):
    j, t = runs["jout"], runs["tout"]
    assert set(j["losses"]) == set(t["losses"])
    for k in j["losses"]:
        assert abs(t["losses"][k] - j["losses"][k]) <= 1e-4 * max(abs(j["losses"][k]), 1e-6), k
    assert np.abs(t["image"] - j["image"]).max() <= 2e-5
    for k in ("labels_2d", "box_mask"):
        np.testing.assert_array_equal(t[k], j[k])
    for view in ("base", "warped"):
        assert ("det" in t[view]) == ("det" in j[view])
        for b in range(B):
            ok, jok = t[view]["valid"][b], j[view]["valid"][b]
            ours = {tuple(p): i for i, p in enumerate(t[view]["pts"][b]) if ok[i]}
            theirs = {tuple(p): i for i, p in enumerate(j[view]["pts"][b]) if jok[i]}
            assert ours.keys() == theirs.keys() and len(ours) > 10, view
            ti, ji = np.array([ours[p] for p in theirs]), np.array(list(theirs.values()))
            js = j[view]["scores"][b][ji]
            assert (np.abs(t[view]["scores"][b][ti] - js) <= js * 2.0**-19).all()
            assert np.abs(t[view]["desc"][b][ti] - j[view]["desc"][b][ji]).max() <= 1e-5


@pytest.fixture(scope="module")
def family(request):
    return request.module.FAMILY


def test_freeze_mask_matches_jax(runs, family, tmp_path):
    """`TrainAgent`'s trainable mask under `freeze_layers` counts the JAX
    package's `freeze_mask_from_spec` indices for this family."""
    params = runs["variables"]["params"]
    jmask = jstate.freeze_mask_from_spec(params, FREEZE, J_ORDER[family])
    flags = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda f, p: np.full(p.shape, float(f), np.float32), jmask, params)})
    config = {"names": ["a", "b", "c"], "model": {"name": family, "version": "n"},
              "freeze_layers": FREEZE, "training_params": {"train_batch_size": 2}}
    agent = TrainAgent(config, tmp_path, [make_batch(7)], seed=0, device="cpu")
    got = dict(zip(agent.optimizer.names, agent.optimizer.trainable))
    assert set(got) == set(flags)
    assert all(got[n] == bool(flags[n].reshape(-1)[0]) for n in got)
    assert 0 < sum(not t for t in got.values()) < len(got)
