"""The port's twin of `__graft_entry__.dryrun_multichip`:
`python -m yolopoint_tpu_torch.parallel.dryrun --nproc 2` on the CPU (two
gloo ranks): it exits 0, its summary line has the JAX gate's fields and a
finite loss. Its EMA + accumulation check holds on a world of one and fails
when the optimizer does not accumulate."""

import math
import re
import subprocess
import sys

import pytest
import torch

from tests.torch_dist import REPO
from yolopoint_tpu_torch.parallel import Mesh, dryrun
from yolopoint_tpu_torch.training import state

torch.set_num_threads(1)

SUMMARY = re.compile(r"dryrun_multichip\(2\): loss=(\S+) param_delta=(\S+) "
                     r"spatial_semi=\((\d+), (\d+), (\d+), 65\) wall=(\S+)s OK")


def test_dryrun_two_ranks():
    proc = subprocess.run([sys.executable, "-m", "yolopoint_tpu_torch.parallel.dryrun",
                           "--nproc", "2", "--device", "cpu", "--timeout", "240"], cwd=REPO,
                          capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    m = SUMMARY.search(proc.stdout)
    assert m, proc.stdout
    loss, delta = float(m.group(1)), float(m.group(2))
    assert math.isfinite(loss) and delta > 0
    # one image a rank, 32 rows a spatial shard: (2, 64 / 8, 32 / 8, 65)
    assert tuple(int(g) for g in m.group(3, 4, 5)) == (2, 8, 4)
    assert "EMA+accum microcheck done" in proc.stdout


def test_ema_accum_microcheck(monkeypatch):
    world = Mesh(1, 0, torch.device("cpu"))
    dryrun.ema_accum_microcheck(world)
    real = state.make_optimizer

    def no_accumulation(model, **kwargs):
        return real(model, **dict(kwargs, accumulate_steps=1))

    monkeypatch.setattr(state, "make_optimizer", no_accumulation)
    with pytest.raises(AssertionError, match="mid-accumulation"):
        dryrun.ema_accum_microcheck(world)
