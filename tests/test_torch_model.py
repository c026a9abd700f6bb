"""YOLOPoint in the PyTorch port against the JAX model, on the CPU in f32.

The JAX package's YOLOPoint-n variables (BatchNorm statistics and affine
parameters made non-trivial) cross to the port as numpy through
`jax_variables_to_state_dict`; both models then run the same input. Semi,
desc and the raw Detect levels agree to 1e-4, unfused and with BN folded
(the port folding its own state dict, the JAX model the JAX-folded tree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import fold_batch_norm as jax_fold_batch_norm
from yolopoint_tpu_torch.models import build_model, fold_batch_norm, jax_variables_to_state_dict

torch.set_num_threads(1)

NC = 3
TOL = 1e-4


def randomize_bn(variables, rng):
    """Numpy copy of a variable tree with BN scale/bias/mean/var away from
    the identity, so that folding and the BN path are exercised."""
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))

    def walk(params, stats):
        for k, v in params.items():
            if k == "bn":
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
                v["bias"] = rng.uniform(-0.3, 0.3, v["bias"].shape).astype(np.float32)
                stats[k]["mean"] = rng.uniform(-0.5, 0.5, v["bias"].shape).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, v["bias"].shape).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    jmodel = jax_build_model("YOLOPoint", "n", nc=NC)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), rng)
    jfused = jax_build_model("YOLOPoint", "n", nc=NC, fused=True)
    folded = jax.device_get(jax_fold_batch_norm(variables))
    want = {
        "unfused": jmodel.apply(variables, jnp.asarray(x), train=False),
        "fused": jfused.apply(folded, jnp.asarray(x), train=False),
    }

    sd = jax_variables_to_state_dict(variables)
    model = build_model("YOLOPoint", "n", nc=NC, device="cpu")
    model.load_state_dict(sd)
    fused = build_model("YOLOPoint", "n", nc=NC, fused=True, device="cpu")
    fused.load_state_dict(fold_batch_norm(sd))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = {"unfused": model(xt), "fused": fused(xt)}
    return got, want, sd, folded


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("variant", ["unfused", "fused"])
@pytest.mark.parametrize("head", ["semi", "desc", "objects"])
def test_forward_matches_jax(outputs, variant, head):
    got, want, _, _ = outputs
    g, w = got[variant][head], want[variant][head]
    if head == "objects":
        assert len(g) == len(w) == 3
        for gl, wl in zip(g, w):
            assert tuple(gl.shape) == wl.shape  # (B, na, ny, nx, 5 + nc)
            assert np.abs(gl.numpy() - np.asarray(wl)).max() <= TOL
    else:
        assert _nhwc(g).shape == w.shape
        assert np.abs(_nhwc(g) - np.asarray(w)).max() <= TOL


def test_state_dict_covers_the_model(outputs):
    _, _, sd, _ = outputs
    model = build_model("YOLOPoint", "n", nc=NC, device="cpu")
    assert set(sd) == set(model.state_dict())
    fused = build_model("YOLOPoint", "n", nc=NC, fused=True, device="cpu")
    assert set(fold_batch_norm(sd)) == set(fused.state_dict())


def test_fold_batch_norm_matches_jax(outputs):
    _, _, sd, folded = outputs
    ours = fold_batch_norm(sd)
    theirs = jax_variables_to_state_dict(folded)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7)


def test_descriptors_are_unit_vectors(outputs):
    got, _, _, _ = outputs
    norms = got["fused"]["desc"].norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


def test_build_model_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("YOLOPoint", "n", nc=NC)
    with pytest.raises(NotImplementedError):
        build_model("SuperPointNet", device="cpu")
