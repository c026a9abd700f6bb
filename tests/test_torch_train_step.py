"""One micro-step and one accumulated update of the port's train step against
`yolopoint_tpu.training.step.make_train_step` on a one-device mesh, on the
CPU in f32: YOLOPoint-n, 128x128, B=2, the flagship loss selection (CE
detector loss, InfoNCE descriptor loss, objects), `accum` 2, EMA on. (At
64x64 the stride-32 BatchNorms see 8 values per channel, and their
backward amplifies f32 rounding to ~3e-3 of the gradient; at 128x128 the
two packages agree to ~3e-4.) Most of this file's time is XLA compiling
the JAX step once.

Both start from the same weights (the JAX variables, BatchNorm statistics
made non-trivial, converted by `jax_variables_to_state_dict`), the same two
batches and the JAX package's own random draws (`tests/torch_replay.py`).

Tolerances: total and per-term losses 1e-4 relative; gradients 1e-3
relative per tensor (the norm of the difference over the norm; after the
first micro-step both optimizers hold exactly the gradient in their
accumulator); BatchNorm running statistics 1e-5 absolute plus 1e-5
relative. The applied update: Adam's first moment (0.1 x the averaged,
clipped gradient of the two micro-steps) 3e-3 relative per tensor (it sums
two micro-steps' gradients, each with this network's f32 noise at 128x128:
a 1e-5 perturbation of the input alone moves a gradient tensor by up to
5e-3 of its largest entry; the worst of the 215 tensors here is 2.0e-3);
parameter deltas 1e-3 relative, and the EMA 1e-6, where that gradient is
above 1e-5 and above 1% of its tensor's largest entry (Adam's first update
is about lr * sign(g): near its eps 1e-8, or where the gradient's own
tolerance could flip its sign, the delta is not comparable, and the EMA,
with its decay ramped to 5e-4 at the first update, follows the new
parameters). Parameters must not move on the first micro-step.

The losses are piecewise smooth: CIoU has kinks where a predicted box edge
meets its target's edge (the `min`/`max` of the intersection and of the
enclosing box) or where the overlap is zero. The two packages' forwards
differ by ~1e-4 relative (f32 rounding in the augmentation and the
convolutions), ~1e-4 grid units on a box edge at stride 32, so a candidate
closer than that to a kink may get the other side's gradient. The seed-1
tests show this on the batch of seed 1 with key 10, which the main tests
do not use. There the discrete choices of `build_targets` all lie further
from their thresholds than the packages' boxes differ, so both pick the
same candidates, and the losses agree within 1e-4. One stride-32 candidate
(image 1, box 3) has its predicted top edge 1.4e-4 grid units from its
target's, and the gradients then differ by up to 0.21 per tensor (norm of
the difference over the norm). Moving that one box by 0.01 of the image
height, in the input of both packages, takes every candidate more than
2e-4 from a kink, and the worst tensor drops 200-fold, to 1.05e-3, the
level of the main batches (6.8e-4). The JAX step against itself compiled
at another XLA optimization level differs by the same amounts (0.21,
9.3e-4 and 5.7e-4; `python -m tests.step_gradient_report`).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_model import randomize_bn
from tests.torch_replay import train_step_draws
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu_torch.data.augmentation import build_training_views
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig, build_targets, candidate_boxes
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.ops.boxes import xywh2xyxy
from yolopoint_tpu_torch.training import state as tstate
from yolopoint_tpu_torch.training import step as tstep

torch.set_num_threads(1)

NC, B, HW = 3, 2, 128
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
WEIGHTS = dict(lambda_desc=0.1, lambda_obj=10.0, desc_loss_type="infonce", det_loss_type="ce",
               num_samples_per_image=60, num_masked_non_matches_per_match=10)
LOSS_KEYS = ("loss", "loss_det", "loss_desc", "loss_obj", "obj_box", "obj_obj", "obj_cls")
OBJ = dict(box=0.05, obj=1.0, cls=0.5, anchor_t=4.0)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.integers(0, NC, (B, 4, 1)), rng.uniform(0.35, 0.65, (B, 4, 2)),
                            rng.uniform(0.15, 0.4, (B, 4, 2))], -1).astype(np.float32)
    return {"image": rng.integers(0, 256, (B, HW, HW, 3), dtype=np.uint8),
            "points": rng.uniform(0, HW - 1, (B, 24, 2)).astype(np.float32),
            "point_mask": np.ones((B, 24), bool), "boxes": boxes,
            "box_mask": np.ones((B, 4), bool)}


def to_sd(tree):
    """A JAX params tree (and optional stats) -> torch-named numpy arrays."""
    return {k: v.numpy() for k, v in jax_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.device_get(tree))).items()}


def port_step(variables):
    """A fresh port model from the JAX variables, its optimizer, state and step."""
    model = build_model("YOLOPoint", "n", nc=NC, device="cpu")
    model.load_state_dict(jax_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.device_get(variables))))
    opt = tstate.make_optimizer(model, **OPT)
    tst = tstate.create_train_state(model, opt, ema=True)
    tfn = tstep.make_train_step(model, AUG, tstep.rescale_yolo_gains(ObjectLossConfig(**OBJ), NC, HW),
                                tstep.LossWeights(**WEIGHTS), NC, accum=2)
    return model, opt, tst, tfn


def make_jax_side():
    """The JAX variables, initial state and jitted step (compiled once, on
    its first call, and reused by every batch of this file)."""
    rng = np.random.default_rng(0)
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), rng)
    tx = jstate.make_optimizer(**OPT)
    jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, HW, HW, 3), tx=tx,
                                    variables=copy.deepcopy(variables), ema=True)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jfn = jstep.make_train_step(jmodel, mesh, AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                                jstep.LossWeights(**WEIGHTS), NC, donate=False, accum=2)
    return {"variables": variables, "state": jst, "step": jfn}


@pytest.fixture(scope="module")
def jax_side():
    return make_jax_side()


@pytest.fixture(scope="module")
def runs(jax_side):
    weights_t = tstep.LossWeights(**WEIGHTS)
    batches = [make_batch(5), make_batch(6)]
    keys = [jax.random.PRNGKey(14), jax.random.PRNGKey(15)]

    # JAX: the package's own step on a one-device mesh
    jfn = jax_side["step"]
    j_states, j_aux = [jax_side["state"]], []
    for b, k in zip(batches, keys):
        s, aux = jfn(j_states[-1], {k_: jnp.asarray(v) for k_, v in b.items()}, k)
        j_states.append(s)
        j_aux.append({k_: float(v) for k_, v in aux.items()})

    # the port
    model, opt, tst, tfn = port_step(jax_side["variables"])
    snaps = [{n: p.detach().clone() for n, p in model.named_parameters()}]
    t_aux, grads, stats = [], None, []
    for i, (b, k) in enumerate(zip(batches, keys)):
        draws = train_step_draws(k, b["image"].shape, AUG, weights_t)
        aux = tfn(tst, {k_: torch.from_numpy(v) for k_, v in b.items()}, draws)
        t_aux.append({k_: float(v) for k_, v in aux.items()})
        if i == 0:
            grads = {n: a.clone() for n, a in zip(opt.names, opt.acc)}
        snaps.append({n: p.detach().clone() for n, p in model.named_parameters()})
        stats.append({n: b_.clone() for n, b_ in model.named_buffers()})
    return {"j_states": j_states, "j_aux": j_aux, "t_aux": t_aux, "grads": grads,
            "snaps": snaps, "stats": stats, "tstate": tst}


@pytest.mark.parametrize("i", [0, 1])
def test_losses_match(runs, i):
    for k in LOSS_KEYS:
        ref, got = runs["j_aux"][i][k], runs["t_aux"][i][k]
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-6), (k, got, ref)
    assert runs["t_aux"][i]["nonfinite_skip"] == 0.0 == runs["j_aux"][i]["nonfinite_skip"]


def rel_norm(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


def test_gradients_match(runs):
    ref = to_sd({"params": runs["j_states"][1].opt_state.acc_grads})
    got = runs["grads"]
    assert set(ref) == set(got)
    worst = max((rel_norm(got[n].numpy(), ref[n]), n) for n in ref)
    assert worst[0] <= 1e-3, worst


@pytest.mark.parametrize("i", [0, 1])
def test_batchnorm_statistics_match(runs, i):
    js = runs["j_states"][i + 1]
    ref = to_sd({"params": js.params, "batch_stats": js.batch_stats})
    got = runs["stats"][i]
    names = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    assert names
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), ref[n], atol=1e-5, rtol=1e-5, err_msg=n)


def test_first_micro_step_leaves_parameters(runs):
    before, after = runs["snaps"][0], runs["snaps"][1]
    assert all(torch.equal(before[n], after[n]) for n in before)
    assert runs["tstate"].step == 2 and runs["tstate"].optimizer.count == 1


def _adam_mu(state):
    inner = state.opt_state.inner_opt_state
    return next(st.mu for st in inner if type(st).__name__ == "ScaleByAdamState")


def test_update_moments_and_deltas_match(runs):
    mu_ref = to_sd({"params": _adam_mu(runs["j_states"][2])})
    opt = runs["tstate"].optimizer
    mu_got = dict(zip([n for n, t in zip(opt.names, opt.trainable) if t], opt.mu))
    p0 = to_sd({"params": runs["j_states"][0].params})
    p2 = to_sd({"params": runs["j_states"][2].params})
    got0, got2 = runs["snaps"][0], runs["snaps"][2]
    ema_ref = to_sd({"params": runs["j_states"][2].ema_params})
    ema_got = runs["tstate"].ema_params
    checked = 0
    for n in p0:
        assert rel_norm(mu_got[n].numpy(), mu_ref[n]) <= 3e-3, n
        g = np.abs(mu_ref[n]) / 0.1  # the averaged, clipped gradient
        sel = (g > 1e-5) & (np.abs(mu_ref[n]) > 0.01 * np.abs(mu_ref[n]).max())
        ref_d = p2[n] - p0[n]
        got_d = (got2[n] - got0[n]).numpy()
        np.testing.assert_allclose(got_d[sel], ref_d[sel], rtol=1e-3, atol=0, err_msg=n)
        np.testing.assert_allclose(ema_got[n].numpy()[sel], ema_ref[n][sel], atol=1e-6, rtol=0,
                                   err_msg=n)
        checked += int(sel.sum())
    assert checked > 1000


def test_ema_moved_with_the_update(runs):
    got, p2 = runs["tstate"].ema_params, runs["snaps"][2]
    assert max(float((got[n] - runs["snaps"][0][n]).abs().max()) for n in got) > 0
    # one update at step // accum = 1: the decay is 0.9999 (1 - exp(-1 / 2000))
    d = np.float32(0.9999) * (np.float32(1) - np.exp(np.float32(-1 / 2000), dtype=np.float32))
    for n in got:
        want = runs["snaps"][0][n] * float(d) + p2[n] * float(np.float32(1) - d)
        torch.testing.assert_close(got[n], want, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------- the batch of seed 1

SEED1_KEY = 10
NUDGE = (1, 3, 2, 0.01)  # image 1, box 3: cy += 0.01 of the image height
KINK_NEAR = 2e-4  # grid units: twice the two packages' box-edge difference at stride 32


def seed1_batch(nudged: bool):
    b = make_batch(1)
    if nudged:
        i, m, col, d = NUDGE
        b["boxes"][i, m, col] += d
    return b


def first_micro_step(jax_side, batch, key, draws, jax_step=None) -> dict:
    """One micro-step from the initial state in both packages (the JAX one
    by `jax_step`, default the jitted step): their losses and gradients,
    and the port's base view and raw Detect levels (the forward of the
    step: train-mode BatchNorm normalizes with the batch statistics)."""
    s, aux = (jax_step or jax_side["step"])(
        jax_side["state"], {k: jnp.asarray(v) for k, v in batch.items()}, key)
    model, opt, tst, tfn = port_step(jax_side["variables"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t_aux = tfn(tst, tb, draws)
    with torch.no_grad():
        base, _ = build_training_views(tb["image"], tb["points"], tb["point_mask"], tb["boxes"],
                                       tb["box_mask"], AUG, draws["aug"])
        preds = [p.float() for p in model(base.image.permute(0, 3, 1, 2).contiguous())["objects"]]
    return {
        "j_aux": {k: float(v) for k, v in aux.items()},
        "t_aux": {k: float(v) for k, v in t_aux.items()},
        "j_grads": to_sd({"params": s.opt_state.acc_grads}),
        "t_grads": {n: a.clone() for n, a in zip(opt.names, opt.acc)},
        "boxes": base.boxes, "box_mask": base.box_mask, "preds": preds,
        "anchors": model.Detect.anchors_per_stride(),
    }


@pytest.fixture(scope="module")
def seed1(jax_side):
    """The first micro-step on the batch of seed 1, as it is and nudged."""
    key = jax.random.PRNGKey(SEED1_KEY)
    draws = train_step_draws(key, (B, HW, HW, 3), AUG, tstep.LossWeights(**WEIGHTS))
    return {nudged: first_micro_step(jax_side, seed1_batch(nudged), key, draws)
            for nudged in (False, True)}


def choice_margins(run) -> torch.Tensor:
    """For every valid target, level and anchor, the distance of each
    discrete choice of `build_targets` from its threshold: the anchor ratio
    from `anchor_t` (relative), the in-cell fraction from 0.5 and from the
    cell border, the centre from one cell off the image edge (grid units)."""
    out = []
    for pi, anchors in zip(run["preds"], run["anchors"]):
        ny, nx = pi.shape[2:4]
        gain = torch.tensor([nx, ny, nx, ny], dtype=torch.float32)
        txywh = run["boxes"][..., 1:5] * gain
        r = txywh[..., None, 2:4] / torch.as_tensor(anchors)[None, None]
        ratio = torch.maximum(r, 1.0 / r).amax(-1)
        gxy = txywh[..., 0:2]
        frac = torch.remainder(gxy, 1.0)
        cells = torch.cat([(frac - 0.5).abs(), torch.minimum(frac, 1.0 - frac), (gxy - 1.0).abs(),
                           (gain[:2] - gxy - 1.0).abs()], -1).amin(-1)
        out.append(torch.minimum((ratio - OBJ["anchor_t"]).abs().amin(-1) / OBJ["anchor_t"],
                                 cells)[run["box_mask"]])
    return torch.cat(out)


def kink_margins(run) -> torch.Tensor:
    """For every valid candidate of every level, the distance (grid units) of
    its predicted box from the nearest kink of CIoU: an edge on its target's
    same edge, or a zero overlap along an axis."""
    out = []
    for pi, anchors in zip(run["preds"], run["anchors"]):
        ny, nx = pi.shape[2:4]
        c = build_targets(run["boxes"], run["box_mask"], torch.as_tensor(anchors), nx, ny,
                          OBJ["anchor_t"])
        p, t = xywh2xyxy(candidate_boxes(pi, c)[1]), xywh2xyxy(c.tbox)
        overlap = torch.stack([torch.minimum(p[:, 2], t[:, 2]) - torch.maximum(p[:, 0], t[:, 0]),
                               torch.minimum(p[:, 3], t[:, 3]) - torch.maximum(p[:, 1], t[:, 1])], -1)
        out.append(torch.cat([(p - t).abs(), overlap.abs()], -1).amin(-1)[c.valid])
    return torch.cat(out)


@pytest.mark.parametrize("nudged", [False, True])
def test_seed_1_losses_match(seed1, nudged):
    run = seed1[nudged]
    for k in LOSS_KEYS:
        ref, got = run["j_aux"][k], run["t_aux"][k]
        assert abs(got - ref) <= 1e-4 * max(abs(ref), 1e-6), (k, got, ref)


@pytest.mark.parametrize("nudged", [False, True])
def test_seed_1_candidate_choices_have_margin(seed1, nudged):
    # the two packages' view boxes differ by <= 1e-4 px (test_torch_augment.py),
    # <= 1.25e-5 grid units at stride 8: no choice lies that close to its threshold
    margins = choice_margins(seed1[nudged])
    assert margins.numel() > 0 and float(margins.min()) > 1e-4, float(margins.min())


def test_seed_1_one_candidate_sits_at_a_ciou_kink(seed1):
    near = kink_margins(seed1[False])
    assert int((near < KINK_NEAR).sum()) == 1, sorted(near.tolist())[:3]
    assert float(kink_margins(seed1[True]).min()) > KINK_NEAR


def test_seed_1_gradient_jump_goes_with_that_candidate(seed1):
    def worst(run):
        return max(rel_norm(run["t_grads"][n].numpy(), run["j_grads"][n]) for n in run["j_grads"])

    plain, nudged = worst(seed1[False]), worst(seed1[True])
    assert plain > 0.1 and nudged < plain / 100, (plain, nudged)
