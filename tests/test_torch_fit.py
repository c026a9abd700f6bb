"""The port's training entry end to end on the CPU (YOLOPoint-n, 64x64, B=2):

* `cli.main` on the s640 config, cut to 2 epochs of 2 micro-steps, writes
  `config.yml` (the merged config), `metrics.jsonl` (`training/` and
  `validation/` records), rolling and best checkpoints with their
  `meta_<epoch>.json`, and `done.json`, and trains from the
  device-resident feed;
* `--resume` with one more epoch starts at epoch 2 with `global_step` and
  `best_fitness` restored from the checkpoint;
* with scripted micro-steps and a scripted fitness sequence, the epochs
  that validate, save, mark best and stop early, and `done.json`, equal
  the JAX agent's epoch loop under the same stubs;
* with scripted micro-steps, the `training/` records at several
  `steps_per_dispatch` (full dispatches, leftovers at an epoch's end, none
  full) equal the JAX loop's;
* `host_warp: true`, a COCO config and `val_plots: true` raise
  `NotImplementedError`; the CLI without `--device cpu` raises on a
  machine without a GPU.
"""

import copy
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from yolopoint_tpu.training.agent import TrainAgent as JaxTrainAgent
from yolopoint_tpu.training.ema import EarlyStopping as JaxEarlyStopping
from yolopoint_tpu.utils.logging import StepTimer as JaxStepTimer
from yolopoint_tpu_torch.data.device_data import DeviceDataLoader
from yolopoint_tpu_torch.training import cli
from yolopoint_tpu_torch.utils.config import dict_update, load_config, save_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def tiny_config(**over):
    cfg = load_config(REPO / "configs" / "synthetic_s640.yaml")
    dict_update(cfg, {
        "model": {"version": "n", "superpoint": {"top_k": 100, "sparse_loss": {"params": {
            "num_samples_per_image": 40}}}},
        "data": {"preprocessing": {"resize": [64, 64]}, "length": {"train": 4, "val": 2}},
        "training_params": {"epochs": 2, "val_interval": 1, "save_interval": 1,
                            "train_batch_size": 2, "val_batch_size": 2,
                            "steps_per_dispatch": 2},
        "extended_val_sample_size": 2})
    return dict_update(cfg, over)


def run_cli(tmp_path, cfg, *extra):
    path = tmp_path / "cfg.yaml"
    save_config(cfg, path)
    return cli.main(["--config", str(path), "--exper_name", "run", "--output_dir",
                     str(tmp_path / "logs"), "--data_root", str(tmp_path / "data"),
                     "--device", "cpu", *extra])


def test_cli_trains_and_resumes(tmp_path):
    agent = run_cli(tmp_path, tiny_config())
    run = tmp_path / "logs" / "run"
    assert isinstance(agent.train_loader, DeviceDataLoader)
    assert load_config(run / "config.yml") == tiny_config()
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["0.pt", "1.pt"]
    assert (run / "best.pt").exists() and (run / "meta_0.json").exists()
    done = json.loads((run / "done.json").read_text())
    assert done["last_epoch"] == 1 and done["global_step"] == 4 and not done["stopped_early"]
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if "training/loss" in r]
    val = [r for r in records if "validation/fitness" in r]
    assert train and all(math.isfinite(r["training/loss"]) for r in train)
    assert [r["step"] for r in val] == [2, 4]
    meta1 = json.loads((run / "meta_1.json").read_text())
    assert meta1["epoch"] == 1 and meta1["global_step"] == 4

    resumed = run_cli(tmp_path, tiny_config(training_params={"epochs": 3}), "--resume")
    assert resumed.start_epoch == 2
    assert resumed.best_fitness == pytest.approx(meta1["best_fitness"])
    done = json.loads((run / "done.json").read_text())
    assert done["last_epoch"] == 2 and done["global_step"] == 6
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["0.pt", "1.pt", "2.pt"]


SCHEDULES = {
    # epochs, val_interval, save_interval, patience, fitness per validation
    "early_stop": (14, 2, 3, 4, [0.1, 0.3, 0.2, 0.3, 0.25, 0.29, 0.4]),
    "no_patience": (7, 3, 2, None, [0.5, 0.4, 0.6]),
    "every_epoch": (5, 1, 1, 2, [0.2, 0.1, 0.2, 0.15, 0.3]),
}


def scripted_port(tmp_path, epochs, val_interval, save_interval, patience, fits):
    tp = {"epochs": epochs, "val_interval": val_interval, "save_interval": save_interval,
          "patience": patience, "steps_per_dispatch": 1}
    cfg = tiny_config(training_params=tp)
    path = tmp_path / "cfg.yaml"
    save_config(cfg, path)
    agent = cli.build_agent(["--config", str(path), "--output_dir", str(tmp_path / "logs"),
                             "--data_root", str(tmp_path / "data"), "--device", "cpu"])
    events = []
    fit_iter = iter(fits)

    def step(batch, on_phase=None):
        return {"loss": torch.tensor(1.0), "nonfinite_skip": torch.tensor(0.0)}

    def validate(epoch, on_phase=None):
        events.append(("val", epoch))
        return {"fitness": next(fit_iter)}

    def save(step_, state, metadata=None, fitness=None, best=False):
        events.append(("save", step_, best, metadata["global_step"], metadata["best_fitness"]))

    agent.step, agent.validate, agent.ckpt.save = step, validate, save
    agent.train()
    return events, json.loads((agent.output_dir / "done.json").read_text())


def scripted_jax(tmp_path, epochs, val_interval, save_interval, patience, fits, steps):
    from yolopoint_tpu.parallel.mesh import make_mesh
    import jax

    events = []
    fit_iter = iter(fits)

    def validate(epoch):
        events.append(("val", epoch))
        return {"fitness": next(fit_iter)}

    def save(step_, state, metadata=None, fitness=None, best=False):
        events.append(("save", step_, best, metadata["global_step"], metadata["best_fitness"]))

    fake = types.SimpleNamespace(
        _profile=None, steps_per_dispatch=1, _device_rows=False,
        # a batch of 8: the tests' JAX CPU mesh has 8 devices
        train_loader=[{"image": np.zeros((8, 4, 4, 3), np.uint8)} for _ in range(steps)],
        train_step=lambda state, batch, key: (state, {"loss": np.float32(1.0),
                                                      "nonfinite_skip": np.float32(0.0)}),
        rng=jax.random.PRNGKey(0), mesh=make_mesh(), state=None, timer=JaxStepTimer(),
        metrics=types.SimpleNamespace(write=lambda *a, **k: None), validate=validate,
        stopper=JaxEarlyStopping(patience) if patience else None,
        ckpt=types.SimpleNamespace(save=save), epochs=epochs, val_interval=val_interval,
        save_interval=save_interval, val_loader=[], output_dir=tmp_path, global_step=0,
        best_fitness=-1.0, start_epoch=0, names=[], version="n", model_name="YOLOPoint",
        config={})
    JaxTrainAgent._train_loop(fake)
    return events, json.loads((tmp_path / "done.json").read_text())


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_epoch_loop_schedule_equals_jax(tmp_path, name):
    sched = SCHEDULES[name]
    port_events, port_done = scripted_port(tmp_path / "port", *sched)
    (tmp_path / "jax").mkdir()
    jax_events, jax_done = scripted_jax(tmp_path / "jax", *sched, steps=2)
    assert port_events == jax_events
    assert port_done == jax_done
    assert any(e[0] == "save" and e[2] for e in port_events)
    if name == "early_stop":
        assert port_done["stopped_early"] and port_done["last_epoch"] < sched[0] - 1


DISPATCHES = {
    # steps_per_dispatch, micro-steps an epoch, epochs
    "k3_leftover": (3, 4, 2),
    "k8_never_full": (8, 4, 2),  # the fit phase's shape on the card: no dispatch is full
    "k3_cadence": (3, 40, 3),
    "k1": (1, 30, 3),
}


def scripted_losses(n):
    """Micro-step scalars whose means over any run of 1-8 steps are exact in
    float32: loss i + 1, one non-finite skip at step 5."""
    return [{"loss": float(i + 1), "nonfinite_skip": float(i == 5)} for i in range(n)]


def dispatch_records_port(tmp_path, k, steps, epochs):
    cfg = tiny_config(training_params={"epochs": epochs, "steps_per_dispatch": k})
    path = tmp_path / "cfg.yaml"
    save_config(cfg, path)
    agent = cli.build_agent(["--config", str(path), "--output_dir", str(tmp_path / "logs"),
                             "--data_root", str(tmp_path / "data"), "--device", "cpu"])
    script = iter(scripted_losses(steps * epochs))
    records = []

    def step(batch, on_phase=None):
        return {k_: torch.tensor(v) for k_, v in next(script).items()}

    agent.step = step
    agent.train_loader, agent.val_loader = [{}] * steps, None
    agent.ckpt.save = lambda *a, **kw: None
    agent.metrics.write = lambda step_, scalars, prefix="": records.append((step_, prefix, scalars))
    agent.train()
    return records, agent.global_step


def dispatch_records_jax(tmp_path, k, steps, epochs):
    from yolopoint_tpu.parallel.mesh import make_mesh
    import jax

    script = iter(scripted_losses(steps * epochs))
    records = []

    def train_step(state, batch, key):
        return state, {k_: np.float32(v) for k_, v in next(script).items()}

    def multi_step(state, stacked, key):
        auxes = [next(script) for _ in range(stacked["image"].shape[0])]
        return state, {k_: np.array([a[k_] for a in auxes], np.float32) for k_ in auxes[0]}

    fake = types.SimpleNamespace(
        _profile=None, steps_per_dispatch=k, _device_rows=False,
        # a batch of 8: the tests' JAX CPU mesh has 8 devices
        train_loader=[{"image": np.zeros((8, 4, 4, 3), np.uint8)} for _ in range(steps)],
        train_step=train_step, multi_step=multi_step, rng=jax.random.PRNGKey(0),
        mesh=make_mesh(), state=None, timer=JaxStepTimer(),
        metrics=types.SimpleNamespace(
            write=lambda step_, scalars, prefix="": records.append((step_, prefix, scalars))),
        stopper=None, ckpt=types.SimpleNamespace(save=lambda *a, **kw: None), epochs=epochs,
        val_interval=1, save_interval=1, val_loader=None, output_dir=tmp_path, global_step=0,
        best_fitness=-1.0, start_epoch=0, names=[], version="n", model_name="YOLOPoint",
        config={})
    JaxTrainAgent._train_loop(fake)
    return records, fake.global_step


@pytest.mark.parametrize("name", list(DISPATCHES))
def test_dispatch_metrics_equal_jax(tmp_path, name):
    """The `training/` records of the epoch loop (steps, averaged scalars)
    at `steps_per_dispatch` K equal the JAX loop's under the same scripted
    micro-steps, leftover micro-steps at an epoch's end included."""
    k, steps, epochs = DISPATCHES[name]
    port, port_steps = dispatch_records_port(tmp_path / "port", k, steps, epochs)
    (tmp_path / "jax").mkdir()
    jax, jax_steps = dispatch_records_jax(tmp_path / "jax", k, steps, epochs)
    assert port_steps == jax_steps == steps * epochs
    assert [(s, p, set(sc)) for s, p, sc in port] == [(s, p, set(sc)) for s, p, sc in jax]
    for (_, _, a), (_, _, b) in zip(port, jax):
        assert {k_: v for k_, v in a.items() if k_ != "step_time"} == \
            {k_: float(v) for k_, v in b.items() if k_ != "step_time"}
    assert bool(port) == (k <= steps)


@pytest.mark.parametrize("case", ["host_warp", "coco", "val_plots"])
def test_unported_features_raise(tmp_path, case):
    if case == "host_warp":
        cfg = tiny_config(data={"augmentation": {"host_warp": True}})
    elif case == "coco":
        cfg = copy.deepcopy(load_config(REPO / "configs" / "coco.yaml"))
    else:
        cfg = tiny_config(val_plots=True)
    with pytest.raises(NotImplementedError):
        run_cli(tmp_path, cfg)


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    path = tmp_path / "cfg.yaml"
    save_config(tiny_config(), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", str(path), "--output_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()


def test_interrupt_saves_last(tmp_path):
    path = tmp_path / "cfg.yaml"
    save_config(tiny_config(), path)
    agent = cli.build_agent(["--config", str(path), "--output_dir", str(tmp_path / "logs"),
                             "--data_root", str(tmp_path / "data"), "--device", "cpu"])
    real_step = agent.step

    def step(batch, on_phase=None):
        if agent.global_step == 3:
            raise KeyboardInterrupt
        return real_step(batch, on_phase)

    agent.step = step
    agent.train()
    assert agent.ckpt.steps() == [0, 3]  # epoch 0's save, then the interrupt's at step 3
    assert json.loads((agent.output_dir / "meta_3.json").read_text())["interrupted"] is True
    assert not (agent.output_dir / "done.json").exists()
