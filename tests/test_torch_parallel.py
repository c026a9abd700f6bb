"""`yolopoint_tpu_torch.parallel.mesh` and the data-parallel serving and
training entry on the CPU, over gloo worker processes (`tests/torch_dist.py`,
each with a timeout).

- `initialize_multi_host` by arguments and by torchrun's environment, and
  world size 1 without either; a requested group that cannot be joined
  raises;
- `process_local_batch_slice` disjoint and covering; `shard_batch` with and
  without `leading_stack`; the coalesced all-reduce and the broadcast;
- the accumulation rule against the JAX agent's at world sizes 1, 2 and 4;
- `InferencePipeline.sharded` on 2 and on 4 gloo ranks against the JAX
  `pipe.sharded()` on as many virtual devices (keypoints as
  `tests/test_torch_pipeline.py` holds them: equal point sets, scores within
  K1's 2^-19 key quantization; descriptors within 1e-4) and against the
  unsharded port pipeline (keypoints, valid masks, classes and counts equal;
  scores within 1e-6 relative, box corners 1e-4 px and descriptors 1e-5:
  the CPU's convolutions round a part of a batch an ulp apart from a whole
  one);
- the training CLI under `torchrun --nproc_per_node 2` on the CPU;
- `chip_smoke.py --cards 4` refuses fewer than four visible cards, naming
  the count, before it builds or starts anything;
- `foreign_card_bytes`, a rank's peak bytes on the other cards.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_model import randomize_bn
from tests.torch_dist import REPO, free_port, run_workers
from yolopoint_tpu.frontend.pipeline import InferencePipeline as JaxPipeline
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolopoint_tpu.parallel.mesh import shard_batch as jax_shard_batch
from yolopoint_tpu_torch.frontend import InferencePipeline
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.parallel import mesh as pm
from yolopoint_tpu_torch.training.agent import accumulation_steps

torch.set_num_threads(1)


def test_world_of_one_without_arguments_or_environment(monkeypatch):
    for k in pm.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = pm.initialize_multi_host(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.backend) == (1, 0, torch.device("cpu"), None)
    assert pm.world_size() == 1 and pm.rank() == 0
    assert pm.process_local_batch_slice(8) == slice(0, 8)
    batch = {"x": np.arange(4)}
    assert pm.shard_batch(batch, mesh) == batch
    t = [torch.ones(3)]
    pm.all_reduce_mean(t, mesh)  # no group: nothing is called
    assert torch.equal(t[0], torch.ones(3))


def test_requested_group_that_cannot_be_joined_raises():
    with pytest.raises(ValueError, match="go together"):
        pm.initialize_multi_host("127.0.0.1:1", 2, None, device="cpu")
    # a process group of 2 whose second rank never comes: the store times out
    code = ("import datetime, torch.distributed as dist\n"
            "from yolopoint_tpu_torch.parallel import mesh as pm\n"
            "pm.TIMEOUT = datetime.timedelta(seconds=3)\n"
            f"pm.initialize_multi_host('127.0.0.1:{free_port()}', 2, 1, device='cpu')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.rank_device("cuda", "gloo", 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="NCCL cannot put two ranks on one GPU"):
        pm.rank_device("cuda", "nccl", 1)


def test_unrequested_shared_card_raises(monkeypatch):
    """CUDA ranks default to NCCL; a rank without a GPU of its own raises
    before any group is joined, unless gloo was asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pm.default_backend("cuda") == "nccl" and pm.default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="ask for the gloo backend by name"):
        pm.initialize_multi_host(f"127.0.0.1:{free_port()}", 2, 1, device="cuda")
    with pytest.raises(RuntimeError, match="NCCL cannot put two ranks on one GPU"):
        pm.rank_device("cuda", None, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("visible", [0, 1, 2, 3])
def test_cards_mode_refuses_fewer_than_four_cards(monkeypatch, visible):
    """`chip_smoke.py --cards 4` with fewer cards visible raises, naming the
    count, before it builds a kernel or starts a rank; it never picks gloo,
    fewer ranks or the CPU."""
    from yolopoint_tpu_torch.ops import _build

    def refused(*a, **k):
        raise AssertionError("the four-card mode went on past its card check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(_build, "build", refused)
    monkeypatch.setattr(chip_smoke, "run_ranks", refused)
    monkeypatch.setattr(chip_smoke, "dryrun_phase", refused)
    monkeypatch.setattr(chip_smoke, "fit_dp", refused)
    with pytest.raises(RuntimeError, match=f"--cards 4: {visible} CUDA device\\(s\\) visible, 4 "
                                           "needed"):
        chip_smoke.main_cards(chip_smoke.CARDS_PHASES)
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert chip_smoke.require_cards() == 4


def test_foreign_card_bytes(monkeypatch):
    """A rank's peak bytes on the visible cards other than its own, by card;
    nothing for a CPU rank."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: 10 * d)
    assert pm.foreign_card_bytes(pm.Mesh(4, 2, torch.device("cuda", 2), "nccl")) == \
        {0: 0, 1: 10, 3: 30}
    assert pm.foreign_card_bytes(pm.Mesh(4, 2, torch.device("cpu"), "gloo")) == {}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return run_workers(2, "tests.torch_dist:collectives_worker", {},
                       tmp_path_factory.mktemp("collectives"))


def test_workers_join_by_arguments(collectives):
    assert [o["world"] for o in collectives] == [(2, 0), (2, 1)]


def test_batch_slices_are_disjoint_and_covering(collectives):
    slices = [o["slice"] for o in collectives]
    assert slices == [slice(0, 4), slice(4, 8)]
    rows = np.concatenate([np.arange(8)[s] for s in slices])
    assert np.array_equal(rows, np.arange(8))
    with pytest.raises(ValueError, match="does not split"):
        pm.rank_rows(7, 2, 0)


def test_shard_batch(collectives):
    x = np.arange(8 * 2).reshape(8, 2)
    stacked = np.arange(3 * 8).reshape(3, 8)
    for r, o in enumerate(collectives):
        assert np.array_equal(o["shard"]["x"], x[4 * r:4 * r + 4])
        assert o["shard"]["names"] == [f"n{i}" for i in range(4 * r, 4 * r + 4)]
        assert np.array_equal(o["shard_stacked"], stacked[:, 4 * r:4 * r + 4])


def test_all_reduce_mean_and_broadcast(collectives):
    for o in collectives:
        a, b, c = o["mean"]
        assert torch.equal(a, torch.full((2, 3), 1.5))
        assert torch.equal(b, torch.arange(4, dtype=torch.float32) * 1.5)
        assert c.dtype == torch.float64 and float(c) == 1.5
        assert torch.equal(o["broadcast"], torch.zeros(3))
        assert torch.equal(o["gathered"], torch.tensor([[False, False], [True, True]]))


def test_initialize_from_torchrun_environment(tmp_path):
    code = ("import json\n"
            "from yolopoint_tpu_torch.parallel import mesh as pm\n"
            "m = pm.initialize_multi_host(device='cpu')\n"
            "print(json.dumps([m.size, m.rank, m.backend, pm.world_size()]))\n"
            "pm.shutdown()\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [1, 0, "gloo", 1]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_accumulation_rule_equals_jax_agent(tmp_path, world):
    """The JAX agent's `accum` on a mesh of `world` virtual devices, for
    the loader's (global) batch of 16: 64 / (16 * world), the nominal batch
    64 / world."""
    from yolopoint_tpu.training.agent import TrainAgent as JaxAgent

    cfg = {"names": ["a"], "model": {"name": "YOLOPointDet", "version": "n"},
           "training_params": {"epochs": 1, "train_batch_size": 16}}
    batch = {"image": np.zeros((1, 32, 32, 3), np.float32)}
    agent = JaxAgent(cfg, tmp_path, [batch], mesh=jax_make_mesh(jax.devices()[:world]))
    assert accumulation_steps(16, world) == agent.accum == max(round(64 / (16 * world)), 1)
    for b in (2, 8, 32, 64, 128):
        assert accumulation_steps(b, world) == max(round(64 / (b * world)), 1)


WORLDS = (2, 4)  # the sharded pipeline's ranks
PIPE_CONFIG = {"detection_threshold": 0.015, "nms": 4, "top_k": 100, "border_remove": 4,
               "conf_thresh": 0.001, "iou_thresh": 0.45, "max_det": 100, "max_nms": 1024}


@pytest.fixture(scope="module")
def sharded_pipes(tmp_path_factory):
    """`(family, world)` -> (the JAX sharded outputs, the unsharded port's,
    each port rank's), on one global batch of 4 (2 rows a rank, or 1)."""
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    out = {}
    for family in ("YOLOPointDet", "YOLOPoint"):
        jmodel = jax_build_model(family, "n", nc=3)
        variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                             train=False), rng)
        sd = jax_variables_to_state_dict(variables)
        model = build_model(family, "n", nc=3, device="cpu")
        model.load_state_dict(sd)
        whole = {k: v.numpy() for k, v in
                 InferencePipeline(model, PIPE_CONFIG, device="cpu")(images).items()}
        jpipe = JaxPipeline(jmodel, variables, PIPE_CONFIG, compute_dtype=jnp.float32)
        for world in WORLDS:
            ranks = run_workers(world, "tests.torch_dist:pipeline_worker",
                                {"family": family, "nc": 3, "state_dict": sd,
                                 "config": PIPE_CONFIG, "images": images},
                                tmp_path_factory.mktemp(f"pipe_{family}_{world}"))
            mesh = jax_make_mesh(jax.devices()[:world])
            jout = jpipe.sharded(mesh)(jax_shard_batch(
                {"x": images.astype(np.float32) / 255.0}, mesh)["x"])
            out[family, world] = ({k: np.asarray(v) for k, v in jout.items()}, whole,
                                  [{k: v.numpy() for k, v in r.items()} for r in ranks])
    return out


# a part of the batch through the CPU's convolutions rounds some outputs an
# ulp apart from the whole batch's: scores and box corners within a few ulps
CLOSE = {"descriptors": dict(atol=1e-5, rtol=0), "kp_scores": dict(atol=0, rtol=1e-6),
         "box_scores": dict(atol=0, rtol=1e-6), "boxes": dict(atol=1e-4, rtol=0)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["YOLOPointDet", "YOLOPoint"])
def test_sharded_pipeline_equals_unsharded(sharded_pipes, family, world):
    _, whole, ranks = sharded_pipes[family, world]
    assert len(ranks) == world
    for got in ranks:  # every rank returns the whole batch's outputs
        assert set(got) == set(whole)
        for k, v in whole.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            if k in CLOSE:
                np.testing.assert_allclose(got[k], v, err_msg=k, **CLOSE[k])
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    if family == "YOLOPoint":
        assert whole["box_valid"].any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["YOLOPointDet", "YOLOPoint"])
def test_sharded_pipeline_equals_jax_sharded(sharded_pipes, family, world):
    jout, _, ranks = sharded_pipes[family, world]
    got = ranks[0]
    for b in range(4):
        ok, jok = got["kp_valid"][b], jout["kp_valid"][b]
        assert ok.sum() == jok.sum() > 5
        ours = dict(zip(map(tuple, got["keypoints"][b][ok]), got["kp_scores"][b][ok]))
        theirs = dict(zip(map(tuple, jout["keypoints"][b][jok]), jout["kp_scores"][b][jok]))
        assert set(ours) == set(theirs)
        for p, s in theirs.items():
            assert abs(ours[p] - s) <= 2.0 ** -19 * max(abs(s), 1e-6) + 1e-7
        d_ours = {tuple(p): d for p, d in zip(got["keypoints"][b][ok], got["descriptors"][b][ok])}
        for p, d in zip(jout["keypoints"][b][jok], jout["descriptors"][b][jok]):
            np.testing.assert_allclose(d_ours[tuple(p)], d, atol=1e-4)


def test_training_cli_on_two_ranks(tmp_path):
    """`torchrun --nproc_per_node 2` on the CPU (gloo): each rank logs its
    rank and an `epoch_timing` line an epoch, rank 0 alone writes the run's
    files, the nominal batch counts the world size, and the run resumes."""
    from tests.test_torch_fit import tiny_config
    from yolopoint_tpu_torch.utils.config import save_config

    cfg = tiny_config(training_params={"train_batch_size": 4, "steps_per_dispatch": 2})
    save_config(cfg, tmp_path / "cfg.yaml")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(free_port()), "-m", "yolopoint_tpu_torch.training.cli",
           "--config", str(tmp_path / "cfg.yaml"), "--exper_name", "run", "--output_dir",
           str(tmp_path / "logs"), "--data_root", str(tmp_path / "data"), "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-4000:]
    assert "rank 0 of world size 2 on cpu (gloo)" in log
    assert "rank 1 of world size 2 on cpu (gloo)" in log
    assert log.count("augmentation warp path") == 1  # rank 0 alone
    timings = [json.loads(line.split("epoch_timing ", 1)[1]) for line in log.splitlines()
               if "epoch_timing {" in line]
    assert sorted((t["rank"], t["epoch"]) for t in timings) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # 4 train images, a global batch of 4: one micro-step of 2 rows a rank an epoch
    assert all(t["micro_steps"] == 1 and t["world"] == 2 for t in timings)
    run = tmp_path / "logs" / "run"
    done = json.loads((run / "done.json").read_text())
    assert (done["last_epoch"], done["global_step"]) == (1, 2)
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert sum("validation/fitness" in r for r in records) == 2  # written once an epoch
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["0.pt", "1.pt"]
