"""The port's bf16 serving forward against the JAX package's, module by module,
on the CPU.

YOLOPoint-n with the JAX package's trained `artifacts/synth_r5_pseudo_ext`
(BN folded, bf16: the model both HPatches runners serve) on a 128x128 crop of
an HPatches image. One JAX forward records every top-level module's input;
each port module then runs on its JAX twin's own input, so that differences
do not compound, against the JAX module jitted alone on that input. The
cases cover the backbone stages, the semi head (`BottleneckDet`, `ConvDet`),
the descriptor head through `_l2_normalize`, the neck and Detect.

The two forwards round in one place apart, by design: the SiLU of a bf16
tensor. The JAX program computes `x * (1 / (1 + exp(-x)))` in bf16, each
step rounded (XLA:CPU runs it so); `F.silu` takes the sigmoid in f32 and
rounds once. `test_bf16_silu_rounds_apart_from_jax_by_design` measures
that over every bf16 value (at most 2 bf16 steps apart). The module test
gives the port's modules the JAX program's SiLU steps, so that it sees
every other cast.

Tolerance, one bf16 rounding: where both sides round at the same places they
run the same bf16 operations on the same values, and only a convolution's
f32 sum runs in another order (oneDNN against XLA:CPU), a few f32 ulps before
the bf16 rounding, which flips that rounding now and then. So every element
lies within one bf16 step of the JAX value (the spacing at the larger of the
two magnitudes), and at most 1e-3 of a module's elements are not bit-equal
(measured: at most 2e-4). Where the port added a conv's bias before the
conv's bf16 rounding (oneDNN on the CPU; Flax adds it after, as PyTorch's
cuDNN path does), every module with a biased conv failed this (48-77% of
the elements of the backbone's and heads' modules apart, many by more than
a step).
"""

from pathlib import Path

import cv2
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolopoint_tpu.models import build_model as jax_build_model
from yolopoint_tpu.models.convert import fold_batch_norm as jax_fold_batch_norm
from yolopoint_tpu.models.convert import load_weights as jax_load_weights
from yolopoint_tpu.models.yolopoint import _l2_normalize as jax_l2_normalize
from yolopoint_tpu_torch.models import build_model, jax_variables_to_state_dict
from yolopoint_tpu_torch.models.yolopoint import _l2_normalize

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "artifacts" / "synth_r5_pseudo_ext" / "best"
IMAGE = REPO / "datasets" / "hpatches_synth" / "i_synth000" / "1.ppm"
MODULES = ("Conv1", "Conv2", "Bottleneck1", "Conv3", "BottleneckDet", "ConvDet", "Bottleneck2",
           "ConvDescA", "ConvDescB", "BottleneckDesc", "ConvDesc", "Conv4", "Bottleneck3",
           "Conv5", "Bottleneck4", "SPPooling", "Conv6", "Bottleneck5", "Conv7", "Bottleneck6",
           "Conv8", "Bottleneck7", "Conv9", "Bottleneck8", "Detect")
MAX_UNEQUAL = 1e-3


@pytest.fixture(scope="module")
def models():
    """(the JAX modules' (module, variables, input) by name, the port model)."""
    loaded = jax_load_weights(RUN)
    nc = len(loaded["meta"]["names"])
    folded = jax.device_get(jax_fold_batch_norm(loaded["variables"]))
    jmodel = jax_build_model("YOLOPoint", "n", nc=nc, dtype=jnp.bfloat16, fused=True)
    img = cv2.imread(str(IMAGE))[:128, :128, ::-1]
    x = jnp.asarray(np.ascontiguousarray(img)[None]).astype(jnp.bfloat16) / 255.0
    recorded = {}

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and len(context.module.path) == 1:
            mod, variables = context.module.unbind()
            recorded[context.module.path[0]] = (mod, variables, args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jmodel.apply(folded, x, train=False)
    port = build_model("YOLOPoint", "n", nc=nc, fused=True, device="cpu")
    port.load_state_dict(jax_variables_to_state_dict(folded))
    return recorded, port.to(torch.bfloat16)


def _f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.float32))  # a writable copy


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(_f32(a)).permute(0, 3, 1, 2).to(torch.bfloat16)


def _jax_silu_steps(x: torch.Tensor) -> torch.Tensor:
    """The JAX program's SiLU, its steps in the tensor's type (bf16: each
    rounded)."""
    return x * (1 / (1 + torch.exp(-x)))


def _steps_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in bf16 steps (the spacing at the larger magnitude)."""
    mag = np.maximum(np.abs(a), np.abs(b))
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-126))) - 7)


def _assert_one_rounding(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    assert np.all(_steps_apart(got, want) <= 1)
    assert np.mean(got != want) <= MAX_UNEQUAL


@pytest.mark.parametrize("name", MODULES)
def test_module_within_one_bf16_rounding_of_jax(models, name, monkeypatch):
    recorded, port = models
    monkeypatch.setattr(F, "silu", _jax_silu_steps)
    mod, variables, x = recorded[name]
    if name == "Detect":  # raw levels (B, na, ny, nx, no) on both sides
        want = jax.jit(mod.apply)(variables, x)
        with torch.no_grad():
            got = port.Detect([_nchw(f) for f in x])
        pairs = [(g.float().numpy(), _f32(w)) for g, w in zip(got, want)]
    else:
        apply = mod.apply if isinstance(mod, nn.Conv) else (lambda v, a: mod.apply(v, a, False))
        want = jax.jit(apply)(variables, x)
        with torch.no_grad():
            got = port.get_submodule(name)(_nchw(x))
        pairs = [(got.float().permute(0, 2, 3, 1).numpy(), _f32(want))]
    for g, w in pairs:
        assert str(w.dtype) == "float32" and np.isfinite(w).all()
        _assert_one_rounding(g, w)


def test_l2_normalize_of_the_bf16_descriptors_as_jax(models):
    """`_l2_normalize` of the JAX `ConvDesc` output: the norm in f32, the
    bf16 map over it promoted to f32, on both sides: within f32 rounding."""
    recorded, port = models
    mod, variables, x = recorded["ConvDesc"]
    desc = jax.jit(mod.apply)(variables, x)
    want = np.asarray(jax_l2_normalize(desc))
    got = _l2_normalize(_nchw(desc)).permute(0, 2, 3, 1).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bf16_silu_rounds_apart_from_jax_by_design():
    """Over every bf16 value: the JAX program's SiLU steps, rounded as the
    port's torch ops round them, equal `jax.nn.silu` jitted on bf16 (NaN
    where it gives NaN) but where a step's result is subnormal, which
    XLA:CPU flushes to zero (|x| < 2^-125, and x < -87 where the sigmoid
    is); the port's `F.silu` lies within half a bf16 step of the exact SiLU,
    the JAX program's within 2.1, and the two within 2 steps of each other."""
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    x = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    want = _f32(jax.jit(jax.nn.silu)(x))
    xt = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    steps = _jax_silu_steps(xt).float().numpy()
    xf = _f32(x)
    apart = ~((steps == want) | (np.isnan(steps) & np.isnan(want)))
    assert np.all(want[apart] == 0) and np.all(np.abs(steps[apart]) < 2.0**-118)
    assert np.all((np.abs(xf[apart]) < 2.0**-125) | (xf[apart] < -87))

    port = F.silu(xt).float().numpy()
    normal = np.isfinite(xf) & (np.abs(xf) >= 2.0**-125) & (xf > -87)
    with np.errstate(over="ignore", invalid="ignore"):  # inf and NaN are not compared
        exact = xf.astype(np.float64) / (1 + np.exp(-xf.astype(np.float64)))
    assert _steps_apart(port[normal], exact[normal]).max() <= 0.5
    assert _steps_apart(want[normal], exact[normal]).max() <= 2.1
    assert _steps_apart(port[normal], want[normal]).max() <= 2
    assert np.mean(port[normal] != want[normal]) > 0.01  # they do round apart
