"""The port's bootstrap chain (`yolopoint_tpu_torch/tools/bootstrap.py`)
against the JAX package's `tools/bootstrap.py`:

* end to end on the CPU at YOLOPoint-n 64x96 (a few images, one epoch a
  stage, 3 homographies, one HPatches scene), each stage's CLI run in this
  process as `python -m` runs it: both runs' files, the export, the HPatches
  results, the summary in `<runs>/RESULTS_torch.json`, and the repository's
  `RESULTS.json` untouched;
* the skip rules, stage by stage, against the JAX tool's on the same run
  directories (both tools' commands recorded, not run): a fresh start, a
  resumable stage 1, finished stages, finished HPatches files, `--fresh`;
* the stage-3 config snapshot: the port's, read back by the port's
  `load_config`, equals `yaml.safe_load` of the JAX tool's.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import runpy
import shutil
import sys
from pathlib import Path

import pytest
import torch
import yaml

from yolopoint_tpu_torch.tools import bootstrap
from yolopoint_tpu_torch.utils.config import dict_update, load_config, save_config

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
SMALL = {"model": {"superpoint": {"top_k": 50}}, "extended_val_sample_size": 4,
         "training_params": {"epochs": 1, "train_batch_size": 4, "val_batch_size": 4,
                             "steps_per_dispatch": 1},
         "data": {"preprocessing": {"resize": [64, 96]}, "length": {"train": 8, "val": 4}}}


def write_configs(tmp: Path, n_export: int = 8) -> list:
    """synth_r5's three configs at YOLOPoint-n 64x96 (depth and size cut);
    returns the bootstrap flags naming them."""
    export = {"export": {"num_homographies": 3},
              "data": {"preprocessing": {"resize": [64, 96]},
                       "length": {"train": n_export, "val": 4}}}
    cut = {"synthetic_r5.yaml": SMALL, "synthetic_export.yaml": export,
           "synthetic_pseudo.yaml": SMALL}
    for name, c in cut.items():
        save_config(dict_update(load_config(REPO / "configs" / name), c), tmp / name)
    return ["--config", str(tmp / "synthetic_r5.yaml"),
            "--export_config", str(tmp / "synthetic_export.yaml"),
            "--pseudo_config", str(tmp / "synthetic_pseudo.yaml")]


def run_here(cmd):
    """A stage's `python -u -m <module> ...` in this process."""
    i = cmd.index("-m")
    old = sys.argv
    sys.argv = [cmd[i + 1], *cmd[i + 2:]]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module(cmd[i + 1], run_name="__main__")
    finally:
        sys.argv = old


def test_chain_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    from yolopoint_tpu_torch.tools import synthetic_hpatches

    monkeypatch.chdir(tmp_path)
    results = REPO / "RESULTS.json"
    before = hashlib.sha256(results.read_bytes()).hexdigest()
    flags = write_configs(tmp_path)
    synthetic_hpatches.main(["--out", str(tmp_path / "hp"), "--scenes", "1", "--i-scenes", "0",
                             "--hw", "64", "96", "--device", "cpu"])
    runs = tmp_path / "runs"
    seconds = bootstrap.main(["--run", "r", "--runs_dir", str(runs), "--hpatches_data",
                              str(tmp_path / "hp"), "--device", "cpu", *flags], run=run_here)
    assert set(seconds) == {"pretrain", "export", "retrain", "hpatches", "summary"}
    for name in ("r", "r_pseudo"):
        for f in ("done.json", "best.pt", "best_meta.json", "metrics.jsonl", "hpatches.json"):
            assert (runs / name / f).is_file(), (name, f)
        hp = json.loads((runs / name / "hpatches.json").read_text())
        assert hp["num_pairs"] == 5 and 0.0 <= hp["repeatability"] <= 1.0
    assert len(list((runs / "r" / "export").glob("*.npz"))) == 8
    summary = json.loads((runs / "RESULTS_torch.json").read_text())
    assert sorted(summary) == ["r", "r_pseudo"]
    assert all("hpatches" in v and "fitness" in v["best"] for v in summary.values())
    assert hashlib.sha256(results.read_bytes()).hexdigest() == before
    # everything done: a second call runs only the summary
    cmds = []
    bootstrap.main(["--run", "r", "--runs_dir", str(runs), "--hpatches_data",
                    str(tmp_path / "hp"), "--device", "cpu", *flags], run=cmds.append)
    assert [c[c.index("-m") + 1] for c in cmds] == ["yolopoint_tpu_torch.tools.summarize_run"]


def jax_bootstrap():
    spec = importlib.util.spec_from_file_location("jax_tool_bootstrap",
                                                  REPO / "tools" / "bootstrap.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stages(cmds) -> list:
    """The stages a tool's recorded commands run, in a form both tools share."""
    out = []
    for c in cmds:
        text = " ".join(c)
        if "training.cli" in text:
            out.append(("retrain" if "--pretrained" in c else "pretrain")
                       + (" --resume" if "--resume" in c else ""))
        elif "export.cli" in text:
            out.append("export")
        elif "hpatches_runner" in text:
            out.append("hpatches " + c[c.index("--json") + 1].split("/")[-2])
        elif "summarize_run" in text:
            out.append("summary")
    return out


def make_runs(root: Path, state: str, n_export: int) -> None:
    """Run directories as both tools find them finished (the JAX `best/`
    directory and the port's `best.pt` side by side)."""
    run, pseudo = root / "r", root / "r_pseudo"
    run.mkdir(parents=True)  # a recorded stage 1 makes none; stage 3 writes into it
    if state == "resumable":
        (run / "ckpts").mkdir()
        return
    if state == "fresh_start":
        return
    for d in (run, pseudo) if state in ("all_done", "hpatches_done") else (run,):
        (d / "best").mkdir(parents=True)
        (d / "best.pt").write_bytes(b"")
        (d / "best_meta.json").write_text("{}")
        (d / "done.json").write_text("{}")
    (run / "export").mkdir()
    for i in range(n_export):
        (run / "export" / f"synth_train_{i:06d}.npz").write_bytes(b"")
    if state == "hpatches_done":
        for d in (run, pseudo):
            (d / "hpatches.json").write_text("{}")


@pytest.mark.parametrize("state,fresh", [("fresh_start", False), ("resumable", False),
                                         ("stage1_done", False), ("all_done", False),
                                         ("hpatches_done", False), ("hpatches_done", True)])
def test_skip_rules_as_the_jax_tool(tmp_path, monkeypatch, state, fresh):
    flags = write_configs(tmp_path, n_export=3)
    hp = REPO / "datasets" / "hpatches_synth"  # the JAX tool's fixed HPatches set
    got = {}
    for tool in ("jax", "port"):
        runs = tmp_path / tool
        make_runs(runs, state, 3)
        cmds = []
        argv = ["--run", "r", "--runs_dir", str(runs), *flags] + (["--fresh"] if fresh else [])
        if tool == "jax":
            module = jax_bootstrap()
            monkeypatch.setattr(module, "sh", cmds.append)
            module.main(argv)
        else:
            bootstrap.main(argv + ["--hpatches_data", str(hp), "--device", "cpu"],
                           run=cmds.append)
        got[tool] = stages(cmds)
        if "retrain" in got[tool]:
            got[tool + "_snapshot"] = runs / "r" / "pseudo_config.yml"
    assert got["port"] == got["jax"]
    assert got["port"][-1] == "summary"
    if "port_snapshot" in got:  # the stage-3 snapshot reads back as the JAX tool's
        want = yaml.safe_load(got["jax_snapshot"].read_text())
        want["data"]["generation"]["points_dir"] = str(tmp_path / "port" / "r" / "export")
        assert load_config(got["port_snapshot"]) == want


def test_no_hpatches_set_skips_the_stage(tmp_path, capsys):
    flags = write_configs(tmp_path, n_export=3)
    make_runs(tmp_path / "runs", "all_done", 3)
    cmds = []
    bootstrap.main(["--run", "r", "--runs_dir", str(tmp_path / "runs"), "--hpatches_data",
                    str(tmp_path / "missing"), *flags], run=cmds.append)
    assert stages(cmds) == ["summary"]
    assert "skipping HPatches" in capsys.readouterr().out


def test_summary_as_the_jax_tool(tmp_path):
    """`summarize_run` reads the port's runs as the JAX tool reads its own, and
    writes `<runs>/RESULTS_torch.json` by default."""
    from yolopoint_tpu_torch.tools import summarize_run

    spec = importlib.util.spec_from_file_location("jax_summarize",
                                                  REPO / "tools" / "summarize_run.py")
    jax_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_mod)
    run = tmp_path / "runs" / "a"
    run.mkdir(parents=True)
    recs = [{"step": 10, "training/loss": 3.0},
            {"step": 20, "validation/fitness": 0.2, "validation/repeatability": 0.41234567,
             "validation/mAP50": 0.5},
            "not json",
            {"step": 40, "validation/fitness": 0.3, "validation/loss": 2.0},
            {"step": 60, "validation/fitness": 0.3, "validation/matching_score": 0.7}]
    run.joinpath("metrics.jsonl").write_text(
        "\n".join(r if isinstance(r, str) else json.dumps(r) for r in recs))
    run.joinpath("hpatches.json").write_text(json.dumps({"repeatability": 0.5}))
    (tmp_path / "runs" / "b").mkdir()
    shutil.copy(run / "hpatches.json", tmp_path / "runs" / "b" / "hpatches.json")
    out = summarize_run.main(["--runs", str(tmp_path / "runs")])
    assert out == {"a": jax_mod.summarize(run)}
    assert json.loads((tmp_path / "runs" / "RESULTS_torch.json").read_text()) == out


def test_kernel_build_is_serialized_across_threads(tmp_path, monkeypatch):
    """A fresh run's first use of the kernel library can come from the host
    loader's threads at once (the chain's first stage in a fresh checkout): one
    build runs, and every thread gets the library (a stand-in `nvcc` that
    writes its `-o` file slowly)."""
    import threading

    from yolopoint_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!" + sys.executable + "\nimport os, sys, time\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "inputs = [a for a in sys.argv[1:] if a.endswith('.o') and a != out]\n"
                    "time.sleep(0.2)\n"
                    "if not all(map(os.path.exists, inputs)):\n"
                    "    sys.exit(1)  # the link of another thread's objects\n"
                    "open(out, 'w').write('x')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    results, errors = [], []

    def use():
        try:
            results.append(_build.build())
        except RuntimeError as e:  # what an unserialized build raised
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(compiled for _, compiled in results) == [False] * 5 + [True]
    assert len({path for path, _ in results}) == 1 and results[0][0].exists()
