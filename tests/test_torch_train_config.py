"""The port's training set-up against the JAX package, on the CPU:

* the optimizer chain (clip, Adam, masked weight decay, linear LR, gradient
  accumulation, freezing) against the JAX package's optax chain on the same
  parameters and gradients, several steps, within 1e-6;
* the freeze masks count parameters in the same reference order;
* `TrainAgent` reads the config as the JAX agent does and trains a few
  micro-steps of a small model;
* a micro-step with a non-finite loss changes nothing (parameters,
  optimizer state, BatchNorm statistics, EMA, step count), as the JAX
  step's guard reverts them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.yolopoint import REFERENCE_MODULE_ORDER as J_ORDER
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu.training.ema import EarlyStopping as JEarly
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.training import TrainAgent
from yolopoint_tpu_torch.training import state as tstate
from yolopoint_tpu_torch.training.ema import EarlyStopping

torch.set_num_threads(1)


def _params(rng):
    return {"a": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                  "bias": rng.normal(size=(8,)).astype(np.float32)},
            "b": {"scale": rng.normal(size=(8,)).astype(np.float32),
                  "kernel": rng.normal(size=(8, 5)).astype(np.float32)}}


@pytest.mark.parametrize("weight_decay,freeze,clip", [(0.0, False, 10.0), (0.05, True, 0.5)])
def test_optimizer_matches_optax(weight_decay, freeze, clip):
    rng = np.random.default_rng(0)
    params = _params(rng)
    mask = {"a": {"kernel": True, "bias": not freeze}, "b": {"scale": True, "kernel": True}}
    kw = dict(learning_rate=1e-2, lrf=0.1, total_epochs=3, steps_per_epoch=2, grad_clip=clip,
              accumulate_steps=2, weight_decay=weight_decay)
    tx = jstate.make_optimizer(trainable_mask=mask if freeze else None, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    flat = {"a.kernel": params["a"]["kernel"], "a.bias": params["a"]["bias"],
            "b.scale": params["b"]["scale"], "b.kernel": params["b"]["kernel"]}
    tp = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    tmask = {"a.kernel": True, "a.bias": not freeze, "b.scale": True, "b.kernel": True}
    opt = tstate.Optimizer(tp, trainable_mask=tmask if freeze else None, **kw)
    update = jax.jit(tx.update)
    for step in range(8):
        g = _params(rng)
        g = jax.tree_util.tree_map(lambda x: x * (3.0 if step % 3 == 0 else 0.01), g)
        u, st = update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        applied = opt.update([torch.from_numpy(np.asarray(g[k.split(".")[0]][k.split(".")[1]]))
                              for k in opt.names])
        assert applied == (step % 2 == 1)
        for k, v in tp.items():
            a, b_ = k.split(".")
            np.testing.assert_allclose(v.numpy(), np.asarray(jp[a][b_]), atol=1e-6, rtol=1e-6,
                                       err_msg=f"{k} step {step}")
    assert opt.count == 4


def test_lr_schedule_and_early_stopping_match():
    js = jstate.linear_lr_schedule(1e-3, 0.1, 125, 32)
    ts = tstate.linear_lr_schedule(1e-3, 0.1, 125, 32)
    for count in (0, 1, 31, 32, 33, 1000, 3999, 4000, 10_000):
        assert ts(count) == float(js(jnp.asarray(count))), count
    a, b = JEarly(3), EarlyStopping(3)
    for epoch, fit in enumerate([0.1, 0.3, 0.2, 0.25, 0.29, 0.28, 0.4]):
        assert a(epoch, fit) == b(epoch, fit)


def test_freeze_masks_count_in_reference_order():
    jmodel = jax_build_model("YOLOPoint", "n", nc=3)
    variables = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    spec = "0-62, 100, 150-160"
    jmask = jstate.freeze_mask_from_spec(variables["params"], spec, J_ORDER["YOLOPoint"])
    flags = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda f, p: np.full(p.shape, float(f), np.float32), jmask, variables["params"])})
    names = [n for n, _ in build_model("YOLOPoint", "n", nc=3, device="cpu").named_parameters()]
    tmask = tstate.freeze_mask_from_spec(names, spec, tstate.REFERENCE_MODULE_ORDER["YOLOPoint"])
    assert set(tmask) == set(flags)
    assert all(tmask[n] == bool(flags[n].reshape(-1)[0]) for n in names)
    assert sum(not v for v in tmask.values()) == 63 + 1 + 11


def tiny_config():
    cfg = chip_smoke.s640_train_config()
    cfg["model"]["version"] = "n"
    cfg["model"]["dtype"] = "f32"
    cfg["model"]["superpoint"]["sparse_loss"]["params"]["num_samples_per_image"] = 40
    cfg["training_params"]["train_batch_size"] = 32
    cfg["freeze_layers"] = "0-3"
    return cfg


def test_train_agent_reads_config_and_trains(tmp_path):
    cfg = tiny_config()
    B, H = 32, 32
    loader = chip_smoke.SeededBatches(0, B, H, H, 5, 4 * B, "cpu", distinct=2, max_points=16,
                                      max_boxes=4)
    agent = TrainAgent(cfg, tmp_path, loader, seed=0, device="cpu")
    assert agent.accum == 2 and agent.compute_dtype == torch.float32
    assert agent.weights.desc_loss_type == "infonce" and agent.weights.det_loss_type == "ce"
    assert agent.obj_cfg.obj == 1.0 and agent.obj_cfg.cls == pytest.approx(0.5 * 5 / 80)
    assert agent.optimizer.accum == 2 and agent.optimizer.grad_clip == 10.0
    assert sum(not t for t in agent.optimizer.trainable) == 4
    frozen = [p for p, t in zip(agent.optimizer.params, agent.optimizer.trainable) if not t]
    before = [p.detach().clone() for p in agent.optimizer.params]
    history = agent.train_steps(4)
    assert len(history) == 4 and all(np.isfinite(h["loss"]) for h in history)
    assert agent.optimizer.count == 2 and agent.state.step == 4
    moved = [not torch.equal(b, p) for b, p in zip(before, agent.optimizer.params)]
    assert any(moved)
    assert all(torch.equal(b, p) for b, p, t in zip(before, agent.optimizer.params,
                                                   agent.optimizer.trainable) if not t)
    assert frozen


def test_train_agent_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainAgent(tiny_config(), tmp_path, [], seed=0)


def test_nonfinite_micro_step_changes_nothing(tmp_path):
    cfg = tiny_config()
    loader = chip_smoke.SeededBatches(1, 32, 32, 32, 5, 4 * 32, "cpu", distinct=1, max_points=16,
                                      max_boxes=4)
    agent = TrainAgent(cfg, tmp_path, loader, seed=0, device="cpu")
    agent.train_steps(1)  # one good micro-step: the accumulator and BN stats are non-trivial
    batch = dict(loader.batches[0])
    image = batch["image"].float() / 255.0
    image[0, 5, 5, 0] = float("nan")
    batch["image"] = image

    def snapshot():
        opt = agent.optimizer
        return ([t.clone() for t in opt.params], [t.clone() for t in opt.acc],
                [t.clone() for t in opt.mu], [t.clone() for t in agent.model.buffers()],
                [t.clone() for t in agent.state.ema_params.values()],
                (opt.mini_step, opt.count, agent.state.step))

    before = snapshot()
    aux = agent.step(batch)
    after = snapshot()
    assert float(aux["nonfinite_skip"]) == 1.0 and not np.isfinite(float(aux["loss"]))
    assert before[5] == after[5]
    for a_list, b_list in zip(before[:5], after[:5]):
        assert all(torch.equal(a, b) for a, b in zip(a_list, b_list))
    assert float(agent.step(loader.batches[0])["nonfinite_skip"]) == 0.0
    assert agent.optimizer.count == 1
