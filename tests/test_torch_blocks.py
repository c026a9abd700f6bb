"""Every block of the port's `models/blocks.py` that no model family uses,
against its JAX module, on the CPU in f32: the JAX block's variables (BN made
non-trivial) cross through `jax_variables_to_state_dict` and both run the
same seeded input within 1e-4 (`tests/test_torch_model.py`'s `TOL`); the
parameter-free functions (`max_pool_2x2`, `contract`, `expand`) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import TOL, randomize_bn
from yolopoint_tpu.models import blocks as jb
from yolopoint_tpu_torch.models import blocks as tb
from yolopoint_tpu_torch.models import jax_variables_to_state_dict

torch.set_num_threads(1)

C1 = 8
# name -> (JAX module, port module, takes `train`)
BLOCKS = {
    "DWConv": (lambda: jb.DWConv(12, 3, 1, g=4), lambda: tb.DWConv(C1, 12, 3, 1), True),
    "BottleneckV8": (lambda: jb.BottleneckV8(C1, True, k=(1, 3)),
                     lambda: tb.BottleneckV8(C1, C1, True, k=(1, 3)), True),
    "C2f": (lambda: jb.C2f(16, 2, shortcut=True), lambda: tb.C2f(C1, 16, 2, True), True),
    "BottleneckCSP": (lambda: jb.BottleneckCSP(16, 2), lambda: tb.BottleneckCSP(C1, 16, 2), True),
    "SPP": (lambda: jb.SPP(12), lambda: tb.SPP(C1, 12), True),
    "Focus": (lambda: jb.Focus(16, 3), lambda: tb.Focus(C1, 16, 3), True),
    "GhostConv": (lambda: jb.GhostConv(16, 3), lambda: tb.GhostConv(C1, 16, 3), True),
    "GhostBottleneck": (lambda: jb.GhostBottleneck(C1), lambda: tb.GhostBottleneck(C1, C1), True),
    "GhostBottleneck_s2": (lambda: jb.GhostBottleneck(16, 3, 2),
                           lambda: tb.GhostBottleneck(C1, 16, 3, 2), True),
    "TransformerLayer": (lambda: jb.TransformerLayer(C1, 2), lambda: tb.TransformerLayer(C1, 2),
                         False),
    "TransformerBlock": (lambda: jb.TransformerBlock(16, 4, 2),
                         lambda: tb.TransformerBlock(C1, 16, 4, 2), True),
    "C3TR": (lambda: jb.C3TR(16, 1), lambda: tb.C3TR(C1, 16, 1), True),
    "C3SPP": (lambda: jb.C3SPP(C1, (3, 5)), lambda: tb.C3SPP(C1, C1, (3, 5)), True),
    "C3Ghost": (lambda: jb.C3Ghost(16, 2), lambda: tb.C3Ghost(C1, 16, 2), True),
    "C3MP": (lambda: jb.C3MP(12, 2), lambda: tb.C3MP(C1, 12, 2), True),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, takes_train = BLOCKS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "TransformerLayer":
        x = rng.standard_normal((6, 2, C1)).astype(np.float32)  # (tokens, B, C)
        xt = torch.from_numpy(x)
    else:
        x = rng.uniform(0, 1, (2, 8, 12, C1)).astype(np.float32)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    jmod = make_jax()
    kw = dict(train=False) if takes_train else {}
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **kw))
    # every kernel and bias away from its initialisation (Dense biases are 0)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(-0.2, 0.2, np.shape(v)).astype(np.float32),
        dict(variables))
    variables = randomize_bn(dict(variables, batch_stats=variables.get("batch_stats", {})), rng)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), **kw))

    model = make_port().eval()
    model.load_state_dict(jax_variables_to_state_dict(variables))
    with torch.no_grad():
        got = model(xt)
    got = got.numpy() if name == "TransformerLayer" else got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("name", ["max_pool_2x2", "contract", "expand"])
def test_function_matches_jax(name):
    x = np.random.default_rng(2).standard_normal((2, 8, 12, 16)).astype(np.float32)
    want = np.asarray(getattr(jb, name)(jnp.asarray(x)))
    got = getattr(tb, name)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_contract_expand_round_trip():
    x = torch.rand(2, 4, 8, 6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tb.expand(tb.contract(x)), x)
