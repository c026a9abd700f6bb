"""The port's data-parallel train step on 2 and on 4 gloo ranks (worker
processes, `tests/torch_dist.py`) against
`yolopoint_tpu.training.step.make_train_step` on a mesh of as many of the
tests' 8 virtual devices with `force_shard_map=True`, on the CPU in f32:
YOLOPoint-n, 128x128, a global batch of 4 (2 rows a rank, or 1), the
flagship loss selection, `accum` 2, EMA on. Each test is a case a world.

Both start from the same weights (`tests/test_torch_train_step.py`'s JAX
variables) and the same global batches of smooth f32 frames (a random
8-pixel grid bilinearly upsampled, as `tests/test_torch_crop_step.py`'s:
on uniform noise the two packages' gradients drift apart by up to 2e-3 at
2 rows a rank, where the f32 noise of a warp coordinate reaches the
BatchNorm backward); each rank gets the JAX replica's own draws
(`fold_in(rng, replica)`, `tests/torch_replay.py`). Three
micro-steps: one that accumulates, one that applies the update, and one
whose batch holds a NaN pixel in the last rank's rows only.

The ranks must agree bit for bit (parameters, BatchNorm statistics, Adam's
moments, accumulators, EMA, scalars): the all-reduce gives every rank the
same mean. Against JAX, the tolerances of `tests/test_torch_train_step.py`:
losses (the mean over the ranks) 1e-4 relative; the averaged gradient 1e-3
relative per tensor; BatchNorm running statistics (the mean over the ranks)
1e-5 absolute plus 1e-5 relative; Adam's first moment 3e-3 relative per
tensor; parameter deltas 1e-3 relative and the EMA 1e-6 where the gradient
is comparable (the same selection). The NaN micro-step is skipped by every
rank and by JAX, and changes nothing.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tests.test_torch_model import randomize_bn
from tests.test_torch_train_step import AUG, HW, LOSS_KEYS, NC, OBJ, OPT, WEIGHTS, _adam_mu, \
    rel_norm, to_sd
from tests.torch_dist import run_workers
from tests.torch_replay import train_step_draws
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training import step as jstep
from yolopoint_tpu_torch.models import jax_variables_to_state_dict
from yolopoint_tpu_torch.training import step as tstep

torch.set_num_threads(1)

B = 4  # the global batch: 2 rows a rank at world 2, 1 at world 4
WORLDS = (2, 4)
KEYS = [jax.random.PRNGKey(k) for k in (21, 22, 23)]


def global_batch(seed, nan_rank=None, ranks=2):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.integers(0, NC, (B, 4, 1)), rng.uniform(0.35, 0.65, (B, 4, 2)),
                            rng.uniform(0.15, 0.4, (B, 4, 2))], -1).astype(np.float32)
    coarse = torch.from_numpy(rng.uniform(0, 1, (B, 3, HW // 8 + 1, HW // 8 + 1)))
    image = torch.nn.functional.interpolate(coarse, size=(HW, HW), mode="bilinear",
                                            align_corners=True)
    image = image.permute(0, 2, 3, 1).float().numpy().copy()
    if nan_rank is not None:
        image[nan_rank * (B // ranks), 40, 50, 1] = np.nan
    return {"image": image, "points": rng.uniform(0, HW - 1, (B, 24, 2)).astype(np.float32),
            "point_mask": np.ones((B, 24), bool), "boxes": boxes,
            "box_mask": np.ones((B, 4), bool)}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"{w}ranks")
def runs(request, tmp_path_factory):
    ranks = request.param
    rng = np.random.default_rng(0)
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = randomize_bn(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))), rng)
    jst = jstate.create_train_state(jmodel, jax.random.PRNGKey(0), (1, HW, HW, 3),
                                    tx=jstate.make_optimizer(**OPT),
                                    variables=copy.deepcopy(variables), ema=True)
    mesh = Mesh(np.array(jax.devices()[:ranks]), ("data",))
    # replicated as the step returns it, so the three calls share one compile
    jst = jax.device_put(jst, NamedSharding(mesh, PartitionSpec()))
    jfn = jstep.make_train_step(jmodel, mesh, AUG, jstep.rescale_yolo_gains(JCfg(**OBJ), NC, HW),
                                jstep.LossWeights(**WEIGHTS), NC, donate=False, accum=2,
                                force_shard_map=True)
    batches = [global_batch(31, ranks=ranks), global_batch(32, ranks=ranks),
               global_batch(33, nan_rank=ranks - 1, ranks=ranks)]
    j_states, j_aux = [jst], []
    for b, k in zip(batches, KEYS):
        s, aux = jfn(j_states[-1], {k_: jnp.asarray(v) for k_, v in b.items()}, k)
        j_states.append(s)
        j_aux.append({k_: float(v) for k_, v in aux.items()})

    weights = tstep.LossWeights(**WEIGHTS)
    draws = [[train_step_draws(k, (B // ranks, HW, HW, 3), AUG, weights, replica=r)
              for r in range(ranks)] for k in KEYS]
    out = run_workers(ranks, "tests.torch_dist:dp_step_worker", {
        "state_dict": jax_variables_to_state_dict(
            jax.tree_util.tree_map(np.asarray, jax.device_get(variables))),
        "nc": NC, "hw": HW, "opt": OPT, "aug": AUG, "obj": OBJ, "weights": WEIGHTS,
        "batches": batches, "draws": draws}, tmp_path_factory.mktemp(f"dp_step{ranks}"))
    return {"j_states": j_states, "j_aux": j_aux, "ranks": out}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_ranks_are_bit_equal(runs):
    r0 = runs["ranks"][0]
    assert r0["steps"] == [1, 2, 2]
    for r in runs["ranks"][1:]:
        np.testing.assert_array_equal([list(a.values()) for a in r0["aux"]],
                                      [list(a.values()) for a in r["aux"]])  # NaN == NaN here
        for i, (s0, s1) in enumerate(zip(r0["states"], r["states"])):
            assert _equal(s0, s1), i
        assert r["steps"] == r0["steps"]


@pytest.mark.parametrize("i", [0, 1])
def test_losses_match_jax(runs, i):
    got, ref = runs["ranks"][0]["aux"][i], runs["j_aux"][i]
    for k in LOSS_KEYS:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1e-6), (k, got[k], ref[k])
    assert got["nonfinite_skip"] == 0.0 == ref["nonfinite_skip"]


def test_averaged_gradients_match_jax(runs):
    ref = to_sd({"params": runs["j_states"][1].opt_state.acc_grads})
    names = list(runs["ranks"][0]["states"][1]["params"])
    got = dict(zip(names, runs["ranks"][0]["states"][1]["acc"]))
    worst = max((rel_norm(got[n].numpy(), ref[n]), n) for n in ref)
    assert worst[0] <= 1e-3, worst


@pytest.mark.parametrize("i", [0, 1])
def test_batchnorm_statistics_are_the_mean_over_ranks(runs, i):
    js = runs["j_states"][i + 1]
    ref = to_sd({"params": js.params, "batch_stats": js.batch_stats})
    got = runs["ranks"][0]["states"][i + 1]["buffers"]
    names = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    assert names
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), ref[n], atol=1e-5, rtol=1e-5, err_msg=n)


def test_update_matches_jax(runs):
    states = runs["ranks"][0]["states"]
    assert all(torch.equal(states[0]["params"][n], states[1]["params"][n])
               for n in states[0]["params"])  # held mid-accumulation
    mu_ref = to_sd({"params": _adam_mu(runs["j_states"][2])})
    names = list(states[2]["params"])
    mu_got = dict(zip(names, states[2]["mu"]))  # no layer is frozen
    p0 = to_sd({"params": runs["j_states"][0].params})
    p2 = to_sd({"params": runs["j_states"][2].params})
    ema_ref = to_sd({"params": runs["j_states"][2].ema_params})
    checked = 0
    for n in p0:
        assert rel_norm(mu_got[n].numpy(), mu_ref[n]) <= 3e-3, n
        g = np.abs(mu_ref[n]) / 0.1
        sel = (g > 1e-5) & (np.abs(mu_ref[n]) > 0.01 * np.abs(mu_ref[n]).max())
        got_d = (states[2]["params"][n] - states[0]["params"][n]).numpy()
        np.testing.assert_allclose(got_d[sel], (p2[n] - p0[n])[sel], rtol=1e-3, atol=0,
                                   err_msg=n)
        np.testing.assert_allclose(states[2]["ema"][n].numpy()[sel], ema_ref[n][sel], atol=1e-6,
                                   rtol=0, err_msg=n)
        checked += int(sel.sum())
    assert checked > 1000


def test_nonfinite_rows_on_one_rank_skip_both(runs):
    """Skipped on every rank (both at world 2, all four at world 4)."""
    assert runs["j_aux"][2]["nonfinite_skip"] == 1.0
    for r in runs["ranks"]:
        assert r["aux"][2]["nonfinite_skip"] == 1.0
        assert _equal(r["states"][3], r["states"][2])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(jnp.array_equal(a, b)), runs["j_states"][3].params,
        runs["j_states"][2].params))
