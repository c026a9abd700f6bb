"""Checkpoints in the reference schema, between the JAX package and the port.

* JAX variables of YOLOPoint-n and -s (BatchNorm made non-trivial) written
  by the JAX package's `variables_to_torch_state_dict` and `torch.save`,
  read by the port's `load_weights`: the port's model gives the JAX model's
  outputs at 64x64 within 1e-4, unfolded and folded (a folded tree saved
  the same way loads into a `fused=True` model).
* The port's state dict -> `state_dict_to_reference` -> the JAX package's
  `torch_state_dict_to_variables` gives back the JAX variables bit for bit.
* `load_weights` refuses a directory (an orbax checkpoint) and names the
  converter.
* `tools/jax_checkpoint_to_torch.py` on the trained run
  `artifacts/synth_r5_pseudo_ext/best` writes a file the port loads.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import randomize_bn
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import fold_batch_norm as jax_fold_batch_norm
from yolopoint_tpu.models.convert import torch_state_dict_to_variables
from yolopoint_tpu.models.convert import variables_to_torch_state_dict
from yolopoint_tpu_torch.models import (build_model, is_folded, load_weights,
                                        state_dict_to_reference)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NC = 5
TOL = 1e-4
RUN = REPO / "artifacts" / "synth_r5_pseudo_ext" / "best"


def _save(path, variables, version):
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in variables_to_torch_state_dict(variables).items()}
    torch.save({"model_state_dict": sd, "names": [str(i) for i in range(NC)],
                "version": version, "model_name": "YOLOPoint"}, path)


@pytest.fixture(scope="module", params=["n", "s"])
def jax_side(request):
    version = request.param
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_model("YOLOPoint", version, nc=NC)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), rng)
    folded = jax.device_get(jax_fold_batch_norm(variables))
    want = {"unfolded": jmodel.apply(variables, jnp.asarray(x), train=False),
            "folded": jax_build_model("YOLOPoint", version, nc=NC, fused=True).apply(
                folded, jnp.asarray(x), train=False)}
    return version, x, variables, folded, want


def _close(got, want):
    np.testing.assert_allclose(got["semi"].permute(0, 2, 3, 1).numpy(), np.asarray(want["semi"]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got["desc"].permute(0, 2, 3, 1).numpy(), np.asarray(want["desc"]),
                               rtol=0, atol=TOL)
    for g, w in zip(got["objects"], want["objects"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["unfolded", "folded"])
def test_saved_reference_file_loads_into_port(jax_side, kind, tmp_path):
    version, x, variables, folded, want = jax_side
    path = tmp_path / "ckpt.pt"
    _save(path, variables if kind == "unfolded" else folded, version)
    loaded = load_weights(path)
    assert loaded["meta"] == {"names": [str(i) for i in range(NC)], "version": version,
                              "model_name": "YOLOPoint"}
    assert is_folded(loaded["state_dict"]) == (kind == "folded")
    model = build_model("YOLOPoint", version, nc=NC, fused=kind == "folded", device="cpu")
    model.load_state_dict(loaded["state_dict"])  # strict
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got, want[kind])


def test_port_to_reference_round_trips_to_jax(jax_side, tmp_path):
    version, _, variables, _, _ = jax_side
    path = tmp_path / "ckpt.pt"
    _save(path, variables, version)
    model = build_model("YOLOPoint", version, nc=NC, device="cpu")
    model.load_state_dict(load_weights(path)["state_dict"])
    back = torch_state_dict_to_variables(state_dict_to_reference(model.state_dict()))
    want = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_back.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_back[k].dtype == v.dtype and np.array_equal(flat_back[k], v), k


def test_directory_raises_and_names_the_converter(tmp_path):
    with pytest.raises(ValueError, match="jax_checkpoint_to_torch"):
        load_weights(tmp_path)


def test_converter_tool_writes_a_file_the_port_loads(tmp_path):
    out = tmp_path / "r5.pt"
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "jax_checkpoint_to_torch.py"),
                           "--run", str(RUN), "--out", str(out)],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = load_weights(out)
    meta = loaded["meta"]
    assert meta["model_name"] == "YOLOPoint" and meta["version"] == "n"
    assert meta["names"] == ["polygon", "star", "ellipse", "checkerboard", "cube"]
    model = build_model("YOLOPoint", "n", nc=len(meta["names"]), device="cpu")
    model.load_state_dict(loaded["state_dict"])  # strict: every tensor present
    with torch.no_grad():
        out = model(torch.zeros(1, 3, 64, 64))
    assert all(torch.isfinite(t).all() for t in (out["semi"], out["desc"], *out["objects"]))
