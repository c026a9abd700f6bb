"""The other four model families of the PyTorch port against the JAX models,
on the CPU in f32: YOLOPointv52, YOLOPointDet, SuperPointNet, YOLOv8Point.

The JAX package's version-n variables (BatchNorm statistics and affine
parameters made non-trivial) cross to the port as numpy through
`jax_variables_to_state_dict`; both models run the same input. Semi, desc
and the raw Detect levels agree to 1e-4, unfused and with BN folded. Also:
`SuperPointNet` folded is the unfused network, the freeze masks of every
family count the JAX package's indices, `TrainAgent` builds every family,
`transplant_yolo_backbone` copies what the JAX function copies, and
`build_model`'s arguments behave as the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import TOL, randomize_bn
from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import fold_batch_norm as jax_fold_batch_norm
from yolopoint_tpu.models.convert import transplant_yolo_backbone as jax_transplant
from yolopoint_tpu.models.yolopoint import REFERENCE_MODULE_ORDER as J_ORDER
from yolopoint_tpu.training import state as jstate
from yolopoint_tpu_torch.models import (
    build_model,
    fold_batch_norm,
    is_folded,
    jax_variables_to_state_dict,
    transplant_yolo_backbone,
)
from yolopoint_tpu_torch.training import state as tstate

torch.set_num_threads(1)

NC = 3
FAMILIES = ("YOLOPointv52", "YOLOPointDet", "SuperPointNet", "YOLOv8Point")
HAS_OBJECTS = {"YOLOPointv52": True, "YOLOPointDet": False, "SuperPointNet": False,
               "YOLOv8Point": True}


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    name = request.param
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    jmodel = jax_build_model(name, "n", nc=NC)
    variables = jax.jit(lambda k, v: jmodel.init(k, v, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    variables = randomize_bn(dict(variables, batch_stats=variables.get("batch_stats", {})), rng)
    jfused = jax_build_model(name, "n", nc=NC, fused=True)
    folded = jax.device_get(jax_fold_batch_norm(variables))
    want = {
        "unfused": jmodel.apply(variables, jnp.asarray(x), train=False),
        "fused": jfused.apply(folded, jnp.asarray(x), train=False),
    }
    sd = jax_variables_to_state_dict(variables)
    model = build_model(name, "n", nc=NC, device="cpu")
    model.load_state_dict(sd)
    fused = build_model(name, "n", nc=NC, fused=True, device="cpu")
    fused.load_state_dict(fold_batch_norm(sd))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = {"unfused": model(xt), "fused": fused(xt)}
    return name, got, want, sd, variables


@pytest.mark.parametrize("variant", ["unfused", "fused"])
def test_forward_matches_jax(family, variant):
    name, got, want, _, _ = family
    g, w = got[variant], want[variant]
    assert set(g) == set(w) == ({"semi", "desc", "objects"} if HAS_OBJECTS[name]
                                else {"semi", "desc"})
    for head in ("semi", "desc"):
        assert _nhwc(g[head]).shape == w[head].shape, head
        assert np.abs(_nhwc(g[head]) - np.asarray(w[head])).max() <= TOL, head
    if HAS_OBJECTS[name]:
        assert len(g["objects"]) == len(w["objects"]) == 3
        for gl, wl in zip(g["objects"], w["objects"]):
            assert tuple(gl.shape) == wl.shape  # (B, na, ny, nx, 5 + nc)
            assert np.abs(gl.numpy() - np.asarray(wl)).max() <= TOL


def test_state_dict_covers_the_model(family):
    name, _, _, sd, _ = family
    assert set(sd) == set(build_model(name, "n", nc=NC, device="cpu").state_dict())
    fused = build_model(name, "n", nc=NC, fused=True, device="cpu")
    assert set(fold_batch_norm(sd)) == set(fused.state_dict())
    assert is_folded(fold_batch_norm(sd))


def test_freeze_masks_count_in_reference_order(family):
    name, _, _, _, variables = family
    spec = "0-9, 17, 30-34"
    jmask = jstate.freeze_mask_from_spec(variables["params"], spec, J_ORDER[name])
    flags = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        lambda f, p: np.full(p.shape, float(f), np.float32), jmask, variables["params"])})
    names = [n for n, _ in build_model(name, "n", nc=NC, device="cpu").named_parameters()]
    tmask = tstate.freeze_mask_from_spec(names, spec, tstate.REFERENCE_MODULE_ORDER[name])
    assert set(tmask) == set(flags)
    assert all(tmask[n] == bool(flags[n].reshape(-1)[0]) for n in names)
    frozen = [i for i in tstate.parse_str_slice(spec) if i < len(names)]
    assert sum(not v for v in tmask.values()) == len(frozen) > 10


def test_module_order_is_the_jax_table():
    assert tstate.REFERENCE_MODULE_ORDER == J_ORDER


def test_superpoint_folded_is_unfused():
    sd = build_model("SuperPointNet", device="cpu").state_dict()
    assert is_folded(sd)
    folded = fold_batch_norm(sd)
    assert set(folded) == set(sd) and all(torch.equal(folded[k], sd[k]) for k in sd)
    fused = build_model("SuperPointNet", "x", nc=7, fused=True, device="cpu")
    fused.load_state_dict(folded)
    unfused = build_model("SuperPointNet", device="cpu")
    unfused.load_state_dict(sd)
    x = torch.rand(2, 3, 32, 48, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = fused(x), unfused(x)
    assert all(torch.equal(a[k], b[k]) for k in ("semi", "desc"))


def test_build_model_arguments():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("YOLOPointX", device="cpu")
    with pytest.raises(ValueError, match="version"):
        build_model("YOLOPointv52", "q", device="cpu")
    full = build_model("YOLOPointDet", None, device="cpu")
    assert full.Conv1.conv.out_channels == 64  # multipliers 1.0 / 1.0
    det = build_model("YOLOv8Point", "n", nc=7, anchors=((1, 2, 3, 4, 5, 6),) * 3, device="cpu")
    assert det.Detect.nc == 7 and det.Detect.anchors[0] == (1, 2, 3, 4, 5, 6)
    assert not hasattr(build_model("YOLOPointDet", "n", nc=7, device="cpu"), "Detect")


def test_transplant_matches_jax():
    """A numerically indexed state dict of YOLOPointDet-n weights (whose
    modules share YOLOPoint's first five) transplanted into YOLOPoint-n:
    the same tensors copied, and the same values, as the JAX function."""
    rng = np.random.default_rng(5)
    donor = build_model("YOLOPointDet", "n", device="cpu").state_dict()
    names = tstate.iter_params_reference_order(
        [k for k in donor if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))],
        tstate.REFERENCE_MODULE_ORDER["YOLOPointDet"])
    yolo = {}
    for i, n in enumerate(names):
        yolo[f"model.{i}.{'.'.join(n.split('.')[-2:])}"] = torch.from_numpy(
            rng.standard_normal(donor[n].shape).astype(np.float32))
        if n.endswith(".bn.bias"):
            for s in ("running_mean", "running_var"):
                yolo[f"model.{i}.bn.{s}"] = torch.from_numpy(
                    rng.uniform(0.5, 1.5, donor[n].shape).astype(np.float32))
            yolo[f"model.{i}.bn.num_batches_tracked"] = torch.tensor(0)

    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = jax.device_get(jax.jit(lambda k, v: jmodel.init(k, v, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    jnew, jcopied = jax_transplant(yolo, variables, J_ORDER["YOLOPoint"])
    target = jax_variables_to_state_dict(variables)
    new, copied = transplant_yolo_backbone(yolo, target, tstate.REFERENCE_MODULE_ORDER["YOLOPoint"])
    assert copied == jcopied > 20
    want = jax_variables_to_state_dict(jnew)
    assert set(new) == set(want)
    assert all(torch.equal(new[k], want[k]) for k in want)
    assert sum(not torch.equal(new[k], target[k]) for k in target) == copied


@pytest.mark.parametrize("name", FAMILIES)
def test_train_agent_refuses_the_other_families(name, tmp_path):
    """The agent no longer refuses the other families: it builds each one
    (their train and val steps against the JAX steps:
    `tests/test_torch_train_<family>.py`); a name that is no family raises."""
    from yolopoint_tpu_torch.training import TrainAgent

    agent = TrainAgent({"model": {"name": name, "version": "n"}, "names": ["a"]}, tmp_path, [],
                       device="cpu")
    assert type(agent.model).__name__ == name
    with pytest.raises(ValueError, match="unknown model"):
        TrainAgent({"model": {"name": name + "2", "version": "n"}, "names": ["a"]}, tmp_path,
                   [], device="cpu")


def test_checkpoint_converter_tool_on_a_family(tmp_path):
    """`tools/jax_checkpoint_to_torch.py` on an orbax `best` directory of a
    YOLOPointv52-n run (written here, the JAX package's layout): the port
    loads the file into the family its metadata names, with the JAX
    forward's outputs within 1e-4."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    import orbax.checkpoint as ocp

    from yolopoint_tpu_torch.models import load_weights

    repo = Path(__file__).resolve().parents[1]
    rng = np.random.default_rng(17)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_model("YOLOPointv52", "n", nc=2)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False), rng)
    run = tmp_path / "run"
    ckpt = ocp.StandardCheckpointer()
    ckpt.save(run / "best", {"params": variables["params"],
                             "batch_stats": variables["batch_stats"], "step": 1})
    ckpt.wait_until_finished()
    (run / "best_meta.json").write_text(json.dumps(
        {"names": ["a", "b"], "version": "n", "model_name": "YOLOPointv52"}))
    out = tmp_path / "v52.pt"
    proc = subprocess.run([sys.executable, str(repo / "tools" / "jax_checkpoint_to_torch.py"),
                           "--run", str(run / "best"), "--out", str(out)],
                          cwd=repo, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = load_weights(out)
    meta = loaded["meta"]
    assert (meta["model_name"], meta["version"], meta["names"]) == ("YOLOPointv52", "n",
                                                                    ["a", "b"])
    model = build_model(meta["model_name"], meta["version"], nc=len(meta["names"]), device="cpu")
    model.load_state_dict(loaded["state_dict"])
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for head in ("semi", "desc"):
        assert np.abs(_nhwc(got[head]) - np.asarray(want[head])).max() <= TOL
    for gl, wl in zip(got["objects"], want["objects"]):
        assert np.abs(gl.numpy() - np.asarray(wl)).max() <= TOL
