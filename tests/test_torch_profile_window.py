"""`training_params.profile: {start_step, num_steps}`: the agent on the CPU
opens a `torch.profiler` window at the first dispatch that starts at or
after `start_step`, closes it after the dispatch that reaches `start_step +
num_steps`, once a run (the JAX agent's `start_trace` / `stop_trace` rule),
and writes `profile/rank0.json`. The trace holds the window's micro-steps
and no others (each micro-step is a "micro_step" range), with one micro-step
a dispatch (K = 1) and two (K = 2, the device-row dispatch). A run resumed
past the window traces its first dispatch (as the JAX agent, whose trace
goes to a new directory) and keeps the earlier run's trace."""

import json

import pytest
import torch

from tests.test_torch_fit import tiny_config
from yolopoint_tpu_torch.training import cli
from yolopoint_tpu_torch.utils.config import save_config

torch.set_num_threads(1)


def run(tmp_path, k, start, num, epochs=None, resume=False):
    tp = {"steps_per_dispatch": k, "profile": {"start_step": start, "num_steps": num}}
    cfg = tiny_config(training_params=dict(tp, **({"epochs": epochs} if epochs else {})))
    save_config(cfg, tmp_path / "cfg.yaml")
    agent = cli.main(["--config", str(tmp_path / "cfg.yaml"), "--exper_name", "run",
                      "--output_dir", str(tmp_path / "logs"), "--data_root",
                      str(tmp_path / "data"), "--device", "cpu"] + (["--resume"] if resume else []))
    return agent, tmp_path / "logs" / "run" / "profile"


def micro_steps(trace_file) -> int:
    events = json.loads(trace_file.read_text())["traceEvents"]
    return sum(e.get("name") == "micro_step" and e.get("cat") == "user_annotation"
               for e in events)


# 2 epochs of 2 micro-steps (4 train images, B = 2)
# the last case's window runs past the run's end: closed when the run ends
@pytest.mark.parametrize("k,start,num,window", [(1, 2, 2, (2, 3)), (2, 2, 2, (2, 3)),
                                                 (1, 1, 1, (1, 1)), (2, 1, 2, (2, 3)),
                                                 (1, 3, 10, (3, 3))])
def test_trace_covers_the_window_only(tmp_path, k, start, num, window):
    agent, prof = run(tmp_path, k, start, num)
    assert agent.global_step == 4
    assert agent.profile_window == window
    assert sorted(p.name for p in prof.iterdir()) == ["rank0.json"]
    assert micro_steps(prof / "rank0.json") == window[1] - window[0] + 1


def test_no_window_no_trace(tmp_path):
    cfg = tiny_config()
    save_config(cfg, tmp_path / "cfg.yaml")
    agent = cli.main(["--config", str(tmp_path / "cfg.yaml"), "--exper_name", "run",
                      "--output_dir", str(tmp_path / "logs"), "--data_root",
                      str(tmp_path / "data"), "--device", "cpu"])
    assert agent.profile_window is None
    assert not (tmp_path / "logs" / "run" / "profile").exists()


def test_resumed_run_keeps_the_first_trace(tmp_path):
    """Resumed at step 4 (epoch 2 of 3), past the window of micro-steps 1-2:
    the first dispatch is traced again, and the first run's trace stays."""
    _, prof = run(tmp_path, 1, 1, 2)
    first = (prof / "rank0.json").read_bytes()
    agent, _ = run(tmp_path, 1, 1, 2, epochs=3, resume=True)
    assert agent.global_step == 6 and agent.profile_window == (4, 4)
    assert sorted(p.name for p in prof.iterdir()) == ["rank0.json", "rank0_steps4-4.json"]
    assert (prof / "rank0.json").read_bytes() == first
    assert micro_steps(prof / "rank0.json") == 2
    assert micro_steps(prof / "rank0_steps4-4.json") == 1
