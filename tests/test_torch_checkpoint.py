"""The port's checkpoints and warm start against the JAX package, on the CPU:

* save -> restore of a YOLOPoint-n agent's state (parameters, BatchNorm
  buffers, the optimizer's accumulators, moments and counts, the EMA
  shadow, the step) into a fresh agent is exact, and the next micro-step
  of both is equal;
* `CheckpointManager` keeps the newest `max_to_keep` checkpoints, a
  `meta_<step>.json` for every save and the newest best, as the JAX
  (orbax) manager does on the same save sequence;
* `merge_partial_variables` of an nc=80 reference-schema file into an
  nc=5 model gives the JAX function's `loaded` and `shape_mismatch` sets
  (the Detect convolutions), under the port's names;
* `shrink_perturb` leaves tensors of rank < 2 bit-equal and maps the
  others to `lam * w` plus noise of standard deviation `sigma`;
* `load_run_variables` prefers the EMA shadow.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import merge_partial_variables as jax_merge
from yolopoint_tpu.training.checkpoint import CheckpointManager as JaxCheckpointManager
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.models.convert import (
    load_weights,
    merge_partial_variables,
    state_dict_to_reference,
)
from yolopoint_tpu_torch.training import TrainAgent
from yolopoint_tpu_torch.training.checkpoint import CheckpointManager, load_run_variables
from yolopoint_tpu_torch.training.state import shrink_perturb

torch.set_num_threads(1)


def tiny_config():
    cfg = chip_smoke.s640_train_config()
    cfg["model"]["version"] = "n"
    cfg["model"]["dtype"] = "f32"
    cfg["model"]["superpoint"]["sparse_loss"]["params"]["num_samples_per_image"] = 40
    cfg["training_params"]["train_batch_size"] = 32  # accum 2
    return cfg


def tiny_agent(path, seed=0):
    loader = chip_smoke.SeededBatches(0, 32, 32, 32, 5, 4 * 32, "cpu", distinct=2,
                                      max_points=16, max_boxes=4)
    return TrainAgent(tiny_config(), path, loader, seed=seed, device="cpu"), loader


def state_tensors(agent):
    opt = agent.optimizer
    out = {f"model.{k}": v for k, v in agent.model.state_dict().items()}
    out.update({f"acc.{i}": a for i, a in enumerate(opt.acc)})
    for i, (p, st) in enumerate(opt.adamw.state.items()):
        out.update({f"adamw.{i}.{k}": v for k, v in st.items()})
    out.update({f"ema.{k}": v for k, v in agent.state.ema_params.items()})
    return out


def test_save_restore_exact(tmp_path):
    agent, loader = tiny_agent(tmp_path / "a")
    agent.train_steps(3)  # one update (accum 2) and a half-filled accumulator
    assert agent.optimizer.count == 1 and agent.optimizer.mini_step == 1
    agent.ckpt.save(7, agent.state, metadata={"epoch": 7, "global_step": 3})
    fresh, _ = tiny_agent(tmp_path / "b", seed=1)
    restored, meta = CheckpointManager(tmp_path / "a").restore(fresh.state)
    assert restored is fresh.state and meta == {"epoch": 7, "global_step": 3}
    want, got = state_tensors(agent), state_tensors(fresh)
    assert set(want) == set(got) and len(want) > 300
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert (fresh.state.step, fresh.optimizer.count, fresh.optimizer.mini_step) == (3, 1, 1)
    fresh.gen.set_state(agent.gen.get_state())
    batch = loader.batches[1]
    a1, a2 = agent.step(batch), fresh.step(batch)
    assert float(a1["loss"]) == float(a2["loss"])
    want, got = state_tensors(agent), state_tensors(fresh)
    assert all(torch.equal(want[k], got[k]) for k in want)


def test_rolling_and_best_as_jax_manager(tmp_path):
    agent, _ = tiny_agent(tmp_path / "port")
    jstate = types.SimpleNamespace(
        params={"w": np.zeros((2, 2), np.float32)}, batch_stats={}, opt_state={},
        step=np.int32(0), ema_params=None)
    port = CheckpointManager(tmp_path / "port_ckpt", max_to_keep=3)
    jax_mgr = JaxCheckpointManager(tmp_path / "jax_ckpt", max_to_keep=3)
    schedule = [(0, 0.1, True), (1, 0.05, False), (2, 0.3, True), (3, 0.2, False),
                (4, 0.25, False)]
    for step, fit, best in schedule:
        meta = {"epoch": step, "best_fitness": fit}
        port.save(step, agent.state, metadata=meta, fitness=fit, best=best)
        jax_mgr.save(step, jstate, metadata=meta, fitness=fit, best=best)
    assert port.steps() == sorted(jax_mgr._mgr.all_steps()) == [2, 3, 4]
    assert port.latest_step() == jax_mgr.latest_step() == 4
    for name in [f"meta_{s}.json" for s, _, _ in schedule] + ["best_meta.json"]:
        assert json.loads((tmp_path / "port_ckpt" / name).read_text()) == \
            json.loads((tmp_path / "jax_ckpt" / name).read_text()), name
    assert json.loads((tmp_path / "port_ckpt" / "best_meta.json").read_text())["fitness"] == 0.3
    assert (tmp_path / "port_ckpt" / "best.pt").exists()
    assert CheckpointManager(tmp_path / "empty").restore(agent.state) == (None, None)


def _jax_name(path: str) -> str:
    """A JAX variable path (`params.Detect.m_0.kernel`) as the port's state-dict name."""
    col, *parts = path.split(".")
    leaf = parts[-1]
    mods = [f"{p.rpartition('_')[0]}.{p.rpartition('_')[2]}"
            if p.rpartition("_")[0] and p.rpartition("_")[2].isdigit() else p for p in parts[:-1]]
    leaf = {("params", "kernel"): "weight", ("params", "scale"): "weight",
            ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
            ("batch_stats", "var"): "running_var"}[(col, leaf)]
    return ".".join(mods + [leaf])


def test_merge_partial_nc80_into_nc5(tmp_path):
    def init(nc):  # the variables' shapes, traced without compiling; seeded values
        model = jax_build_model("YOLOPoint", "n", nc=nc)
        shapes = jax.eval_shape(lambda k, x: model.init(k, x, train=False),
                                jax.random.PRNGKey(nc), jnp.zeros((1, 32, 32, 3)))
        rng = np.random.default_rng(nc)
        return jax.tree_util.tree_map(
            lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32), dict(shapes))

    src80, tgt5 = init(80), init(5)
    _, jreport = jax_merge(tgt5, src80)
    path = tmp_path / "nc80.pt"
    torch.save({"model_state_dict": state_dict_to_reference(jax_variables_to_state_dict(src80)),
                "names": [str(i) for i in range(80)]}, path)
    target = build_model("YOLOPoint", "n", nc=5, device="cpu").state_dict()
    merged, report = merge_partial_variables(target, load_weights(path)["state_dict"])
    for key in ("loaded", "shape_mismatch", "missing_in_source", "unused_in_source"):
        got = {n for n in report[key] if not n.endswith("num_batches_tracked")}
        assert got == {_jax_name(p) for p in jreport[key]}, key
    assert report["shape_mismatch"] and all(n.startswith("Detect.") for n in
                                            report["shape_mismatch"])
    source = load_weights(path)["state_dict"]
    for n in report["loaded"]:
        assert torch.equal(merged[n], source[n]), n
    for n in report["shape_mismatch"]:
        assert merged[n] is target[n]


def test_shrink_perturb():
    model = build_model("YOLOPoint", "n", nc=5, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = shrink_perturb(params, torch.Generator().manual_seed(0), lam=0.5, sigma=0.01)
    assert list(out) == list(params)
    noise = []
    for n, p in params.items():
        if p.dim() < 2:
            assert torch.equal(out[n], p), n
        else:
            noise.append(((out[n] - 0.5 * p) / 0.01).reshape(-1))
    noise = torch.cat(noise)
    assert noise.numel() > 1e5
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1.0) < 0.01
    again = shrink_perturb(params, torch.Generator().manual_seed(0), lam=0.5, sigma=0.01)
    assert all(torch.equal(out[n], again[n]) for n in out)


def test_load_run_variables_prefers_ema(tmp_path):
    agent, _ = tiny_agent(tmp_path / "run")
    agent.train_steps(2)
    agent.ckpt.save(0, agent.state, best=True)
    ema = load_run_variables(tmp_path / "run")
    raw = load_run_variables(tmp_path / "run", prefer_ema=False)
    name = next(iter(agent.state.ema_params))
    assert torch.equal(ema[name], agent.state.ema_params[name].cpu())
    assert torch.equal(raw[name], agent.model.state_dict()[name])
    assert not torch.equal(ema[name], raw[name])
    assert set(ema) == set(agent.model.state_dict())
    with pytest.raises(FileNotFoundError):
        load_run_variables(tmp_path / "missing_run")
