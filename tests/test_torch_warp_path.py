"""Both packages' training CLIs take the same augmentation warp path for the
same config on this host, with nothing patched, and log it: `build_agent`
of each on `configs/synthetic_s640.yaml` cut to YOLOPoint-n at 64x64, with
`data.augmentation.host_warp` unset (the default: the host warp where the
host has 4 or more cores), `true` and `false`. The train and val loaders
carry a host-augment config exactly where the JAX CLI's do, the train feed
is device-resident exactly where the JAX CLI's is, and the log line names
the same path. (The exports' default path: `tests/test_torch_host_export.py`.)
"""

import logging
import os

import pytest
import torch

from tests.test_torch_fit import tiny_config
from yolopoint_tpu.training import cli as jax_cli
from yolopoint_tpu_torch.training import cli
from yolopoint_tpu_torch.utils.config import save_config

torch.set_num_threads(1)


def logged_path(caplog):
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("augmentation warp path:")]
    assert len(lines) == 1, lines
    return lines[0].split(":", 1)[1].split()[0]  # "host" or "device"


def describe(agent):
    return {"train_host": getattr(agent.train_loader, "host_augment_config", None) is not None,
            "val_host": agent.val_loader.host_augment_config is not None,
            "device_resident": type(agent.train_loader).__name__ == "DeviceDataLoader"}


@pytest.mark.parametrize("host_warp", ["unset", True, False])
def test_both_clis_take_the_same_warp_path(tmp_path, caplog, host_warp):
    cfg = tiny_config()
    if host_warp == "unset":
        cfg["data"]["augmentation"].pop("host_warp")
    else:
        cfg["data"]["augmentation"]["host_warp"] = host_warp
    path = tmp_path / "cfg.yaml"
    save_config(cfg, path)
    args = ["--config", str(path), "--data_root", str(tmp_path / "data")]
    caplog.set_level(logging.INFO)
    jax_agent = jax_cli.build_agent(args + ["--output_dir", str(tmp_path / "jax")])
    want = logged_path(caplog)
    caplog.clear()
    agent = cli.build_agent(args + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = logged_path(caplog)
    expect_host = (os.cpu_count() or 1) >= 4 if host_warp == "unset" else host_warp
    assert got == want == ("host" if expect_host else "device")
    assert describe(agent) == describe(jax_agent)
    assert describe(agent)["train_host"] == expect_host
