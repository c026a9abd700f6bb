"""`make_multi_step` and `make_device_multi_step` against the JAX package's
on a one-device mesh, on the CPU in f32: YOLOPoint-n, 128x128, B = 2, K = 3
micro-steps a dispatch, `accum` 2, EMA on (the train step of
`tests/test_torch_train_step.py`). Each micro-step gets the JAX scan's own
draws (`fold_in(rng, i)`, `tests/torch_replay.py`).

- The port's dispatch equals its K single micro-steps bit for bit (state
  and scalars), and its device-row dispatch equals its stacked one.
- Against JAX, with the tolerances of `tests/test_torch_train_step.py`: the
  stacked `(K,)` scalars 1e-4 relative (1e-3 on a micro-step after the
  update: Adam's first step is about lr * sign(g), so a parameter whose
  gradient is near 0 may move 2 lr apart in the two packages, which
  `tests/test_torch_train_step.py` leaves out of its delta check, and the
  next forward sees it); the BatchNorm statistics 1e-5
  absolute plus 1e-5 relative (1e-3 and 1e-3 after a micro-step on updated
  parameters); Adam's first moment 3e-3 relative per
  tensor; parameter deltas 1e-3 relative and the EMA 1e-6 where the
  gradient is comparable.
- A micro-step with a NaN box inside K is skipped, `nonfinite_skip` 1 at
  its index, in both packages, and the accumulation window closes one
  micro-step later. (Its own scalars differ: the JAX object loss stays
  finite, its gradient does not; the port's loss is NaN.)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_model import randomize_bn
from tests.test_torch_train_step import AUG, HW, LOSS_KEYS, NC, OBJ, OPT, WEIGHTS, _adam_mu, \
    make_batch, port_step, rel_norm, to_sd
from tests.torch_replay import train_step_draws
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu_torch.training import step as tstep

torch.set_num_threads(1)

K, KEY = 3, jax.random.PRNGKey(14)


def smooth_batch(seed):
    """`make_batch(seed)` with smooth uint8 frames (a random 8-pixel grid
    bilinearly upsampled, as `tests/test_torch_crop_step.py`'s): the third
    micro-step runs on parameters that the update moved, and on uniform noise
    the two packages' updates differ enough to move its object loss by 2e-4."""
    b = make_batch(seed)
    rng = np.random.default_rng(seed + 100)
    coarse = torch.from_numpy(rng.uniform(0, 255, (len(b["image"]), 3, HW // 8 + 1, HW // 8 + 1)))
    img = torch.nn.functional.interpolate(coarse, size=(HW, HW), mode="bilinear",
                                          align_corners=True)
    b["image"] = img.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy().copy()
    return b


def batches(nan_step=None):
    out = [smooth_batch(s) for s in (5, 6, 7)]
    if nan_step is not None:
        out[nan_step]["boxes"][0, 0, 1] = np.nan
    return out


def draws_for(shape):
    w = tstep.LossWeights(**WEIGHTS)
    return [train_step_draws(jax.random.fold_in(KEY, i), shape, AUG, w) for i in range(K)]


def snapshot(model, tst):
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "ema": {n: t.clone() for n, t in tst.ema_params.items()},
            "mu": [m.clone() for m in tst.optimizer.mu], "step": tst.step,
            "count": tst.optimizer.count}


def equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), rng)
    jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, HW, HW, 3),
                                    tx=jstate.make_optimizer(**OPT),
                                    variables=copy.deepcopy(variables), ema=True)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jfn = jstep.make_train_step(jmodel, mesh, AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                                jstep.LossWeights(**WEIGHTS), NC, donate=False, accum=2)
    jmulti = jstep.make_multi_step(jfn, K)
    jdev = jstep.make_device_multi_step(jfn, K)
    draws = draws_for((2, HW, HW, 3))
    out = {"j0": jst}
    for name, nan_step in (("plain", None), ("nan", 1)):
        bs = batches(nan_step)
        stacked = jstep.stack_batches(bs)
        s, aux = jmulti(jst, {k: jnp.asarray(v) for k, v in stacked.items()}, KEY)
        out[f"j_{name}"] = (s, {k: np.asarray(v) for k, v in aux.items()})

        model, _, tst, tfn = port_step(variables)
        multi = tstep.make_multi_step(tfn, K)
        taux = multi(tst, {k: torch.from_numpy(v) for k, v in stacked.items()}, draws)
        out[f"t_{name}"] = (snapshot(model, tst), {k: v.numpy() for k, v in taux.items()})

        model, _, tst, tfn = port_step(variables)
        singles = [tfn(tst, {k: torch.from_numpy(v) for k, v in b.items()}, d)
                   for b, d in zip(bs, draws)]
        out[f"single_{name}"] = (snapshot(model, tst), tstep.stack_aux(singles))
    out["t0"] = snapshot(*port_step(variables)[::2])

    # device rows: 6 resident samples, rows (K, B) into them
    bs = batches()
    data = {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
    idx = np.array([[4, 0], [1, 5], [3, 2]], np.int32)
    wait = jdev(copy.deepcopy(jst), {k: jnp.asarray(v) for k, v in data.items()},
                jnp.asarray(idx), KEY)
    out["j_rows"] = (wait[0], {k: np.asarray(v) for k, v in wait[1].items()})
    model, _, tst, tfn = port_step(variables)
    taux = tstep.make_device_multi_step(tfn, K)(
        tst, {k: torch.from_numpy(v) for k, v in data.items()}, idx, draws)
    out["t_rows"] = (snapshot(model, tst), {k: v.numpy() for k, v in taux.items()})
    model, _, tst, tfn = port_step(variables)
    stacked = {k: torch.from_numpy(v[idx]) for k, v in data.items()}
    taux = tstep.make_multi_step(tfn, K)(tst, stacked, draws)
    out["t_rows_stacked"] = (snapshot(model, tst), {k: v.numpy() for k, v in taux.items()})
    return out


@pytest.mark.parametrize("name", ["plain", "nan"])
def test_dispatch_equals_single_micro_steps(runs, name):
    (s_multi, a_multi), (s_single, a_single) = runs[f"t_{name}"], runs[f"single_{name}"]
    assert equal(s_multi, s_single)
    for k, v in a_single.items():
        np.testing.assert_array_equal(a_multi[k], v.numpy(), err_msg=k)


def test_device_rows_equal_stacked_batches(runs):
    (s_rows, a_rows), (s_st, a_st) = runs["t_rows"], runs["t_rows_stacked"]
    assert equal(s_rows, s_st)
    for k in a_st:
        np.testing.assert_array_equal(a_rows[k], a_st[k], err_msg=k)


@pytest.mark.parametrize("name", ["plain", "nan", "rows"])
def test_stacked_scalars_match_jax(runs, name):
    (_, got), (_, ref) = runs[f"t_{name}"], runs[f"j_{name}"]
    assert set(got) == set(ref)
    # after the update (micro-step 2 of plain and rows) the parameters already
    # differ (see the module docstring): 1e-3 relative there
    rtol = np.array([1e-4, 1e-4, 1e-4 if name == "nan" else 1e-3])
    for k in LOSS_KEYS + ("nonfinite_skip",):
        assert got[k].shape == ref[k].shape == (K,), k
        # the skipped micro-step's own scalars are not compared: with a NaN box
        # the JAX object loss comes out finite (its gradient is not), the port's NaN
        fin = np.isfinite(ref[k]) & np.isfinite(got[k])
        fin[np.asarray(ref["nonfinite_skip"]) == 0] = True
        err = np.abs(got[k] - ref[k])[fin]
        assert (err <= rtol[fin] * np.maximum(np.abs(ref[k][fin]), 1e-6)).all(), (k, got[k], ref[k])
    want_skip = [0.0, 1.0, 0.0] if name == "nan" else [0.0] * K
    assert list(got["nonfinite_skip"]) == list(ref["nonfinite_skip"]) == want_skip


@pytest.mark.parametrize("name", ["plain", "nan", "rows"])
def test_state_after_dispatch_matches_jax(runs, name):
    (got, _), (js, _) = runs[f"t_{name}"], runs[f"j_{name}"]
    # plain and rows: an update at micro-step 2 of 3; nan: micro-step 2 skipped,
    # the update at micro-step 3
    assert (got["step"], got["count"]) == ((2, 1) if name == "nan" else (3, 1))
    assert int(js.step) == got["step"]
    ref = to_sd({"params": js.params, "batch_stats": js.batch_stats})
    # plain and rows end with a micro-step on updated parameters (see above)
    tol = 1e-5 if name == "nan" else 1e-3
    for n in [n for n in ref if n.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(got["buffers"][n].numpy(), ref[n], atol=tol, rtol=tol,
                                   err_msg=n)
    mu_ref = to_sd({"params": _adam_mu(js)})
    mu_got = dict(zip(got["params"], got["mu"]))
    p0 = to_sd({"params": runs["j0"].params})
    p_ref = to_sd({"params": js.params})
    ema_ref = to_sd({"params": js.ema_params})
    checked = 0
    for n in p0:
        assert rel_norm(mu_got[n].numpy(), mu_ref[n]) <= 3e-3, n
        mu = np.abs(mu_ref[n])
        sel = (mu / 0.1 > 1e-5) & (mu > 0.01 * mu.max())
        got_d = (got["params"][n] - runs["t0"]["params"][n]).numpy()
        np.testing.assert_allclose(got_d[sel], (p_ref[n] - p0[n])[sel], rtol=1e-3, atol=0,
                                   err_msg=n)
        np.testing.assert_allclose(got["ema"][n].numpy()[sel], ema_ref[n][sel], atol=1e-6, rtol=0,
                                   err_msg=n)
        checked += int(sel.sum())
    assert checked > 1000
