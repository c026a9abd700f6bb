"""`descriptor_loss_dense` against `yolopoint_tpu.losses.descriptor.
descriptor_loss_dense` on the CPU: random unit descriptor maps, homographies
from the JAX sampler, with and without a valid mask, at two map sizes and
the defaults' margins and at others. Tolerance 1e-5 relative (f32: the
packages form the pixel homography in another order, f32 in JAX and f64
rounded once here, and sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.losses.descriptor import descriptor_loss_dense as jax_dense
from yolopoint_tpu.ops.homography import sample_homography_batch
from yolopoint_tpu_torch.losses import descriptor_loss_dense

torch.set_num_threads(1)

HOMOGRAPHY = dict(perspective=True, scaling=True, rotation=True, translation=True,
                  patch_ratio=0.85, perspective_amplitude_x=0.1, perspective_amplitude_y=0.1,
                  scaling_amplitude=0.1, max_angle=0.3)


def inputs(seed, B, Hc, Wc, D=16, mask=True):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(2, B, Hc, Wc, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hom = np.asarray(sample_homography_batch(jax.random.PRNGKey(seed), B, **HOMOGRAPHY))
    valid = None
    if mask:
        valid = np.ones((B, Hc * 8, Wc * 8), np.float32)
        valid[:, : rng.integers(1, 12), :] = 0  # a few invalid rows of cells
        valid[:, :, -rng.integers(1, 12):] = 0
    return d[0], d[1], hom, valid


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("shape", [(2, 6, 8), (1, 10, 12)])
@pytest.mark.parametrize("margins", [{}, dict(lambda_d=250.0, margin_pos=0.8, margin_neg=0.3)])
def test_dense_loss_matches_jax(mask, shape, margins):
    da, db, hom, valid = inputs(sum(shape) + mask, *shape, mask=mask)
    ref = float(jax_dense(jnp.asarray(da), jnp.asarray(db), jnp.asarray(hom),
                          None if valid is None else jnp.asarray(valid), **margins))
    got = float(descriptor_loss_dense(torch.from_numpy(da), torch.from_numpy(db),
                                      torch.from_numpy(hom),
                                      None if valid is None else torch.from_numpy(valid),
                                      **margins))
    assert ref > 0
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)


def test_dense_loss_single_homography_and_gradient():
    """A (3, 3) homography is shared by the batch (the JAX `atleast_3d`),
    and the loss is differentiable in both maps."""
    da, db, hom, valid = inputs(3, 2, 6, 8)
    ref = float(jax_dense(jnp.asarray(da), jnp.asarray(db), jnp.asarray(hom[0]), None))
    ta = torch.from_numpy(da).requires_grad_()
    got = descriptor_loss_dense(ta, torch.from_numpy(db), torch.from_numpy(hom[0]))
    got.backward()
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)
    assert torch.isfinite(ta.grad).all() and float(ta.grad.abs().sum()) > 0
