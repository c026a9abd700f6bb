"""The port's homography warp and geometry helpers against the JAX package,
on the CPU.

* The plain warp (`warp_image_plain`, the port of `_warp_image_xla`) against
  the JAX package's exact warp: bilinear within 1e-5; nearest may differ only
  at rounding ties, on at most 1e-4 of the pixels.
* Against the two Pallas warps in interpret mode, with the JAX tests' own
  bf16 tolerances: K5 `warp_image_pallas` as `tests/test_pallas_warp.py`
  holds it (bilinear max < 8e-3 and mean < 1e-3; nearest on u8-valued
  content exact), K4 `warp_image_pallas_windowed` as
  `tests/test_pallas_warp_windowed.py` does (6e-3 bilinear, 2e-3 nearest).
* The kernel wrapper's autograd backward (the plain version's VJP) and its
  dispatch: a CPU tensor takes the plain version and launches nothing.
* `compute_valid_mask`, `warped_pair_valid_mask`, points, label maps,
  erosion and the homography sampler's invariants.
The kernel itself runs only on the card: `tests/test_torch_warp_tiles.py`
(`gpu` marker, no JAX, so it also runs where JAX is not installed) and
`chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.ops import geometry as jgeo
from yolopoint_tpu.ops.homography import sample_homography_np
from yolopoint_tpu.ops.pallas_warp import (
    warp_fits_pallas as jax_fits,
    warp_image_pallas,
    warp_image_pallas_windowed,
)
from yolopoint_tpu_torch.ops import _build, cuda_warp
from yolopoint_tpu_torch.ops import geometry as tgeo
from yolopoint_tpu_torch.ops.homography import perspective_transform, sample_homography_batch

torch.set_num_threads(1)

PARAMS = dict(patch_ratio=0.85, perspective=True, scaling=True, rotation=True, translation=True)
_jit_warp = jax.jit(jgeo._warp_image_xla, static_argnums=2)


def homs(B, seed=0, **kw):
    """Normalized-coords output -> source homographies (f32)."""
    return np.stack([sample_homography_np((2, 2), shift=-1, seed=seed + i, **{**PARAMS, **kw})
                     for i in range(B)]).astype(np.float32)


def image(shape, seed=3):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def port_warp(img, hom, mode):
    return tgeo.warp_image(torch.from_numpy(img), torch.from_numpy(hom), mode).numpy()


@pytest.mark.parametrize("shape", [(2, 96, 128, 3), (2, 80, 80, 1)])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_plain_warp_matches_jax_exact_warp(shape, mode):
    img, hom = image(shape), homs(shape[0])
    got = port_warp(img, hom, mode)
    ref = np.asarray(_jit_warp(jnp.asarray(img), jnp.asarray(hom), mode))
    if mode == "bilinear":
        assert np.abs(got - ref).max() <= 1e-5
    else:
        # the source coordinates may round differently at exact .5 ties only
        differ = (got != ref).any(-1).mean()
        assert differ <= 1e-4, differ


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kernel,shape", [
    ("K5", (2, 64, 128, 3)), ("K5", (2, 80, 80, 1)),
    ("K4", (2, 192, 384, 3)), ("K4", (1, 96, 256, 1)),
])
def test_plain_warp_matches_pallas_kernels(kernel, shape, mode):
    """K5 `warp_image_pallas` / K4 `warp_image_pallas_windowed` in interpret
    mode. Bilinear: the bf16 taps and weights stay within 8e-3 (the bound of
    `tests/test_pallas_warp.py`). Nearest, on u8-valued content (exact in
    bf16): the Pallas kernels compute coordinates from a pixel-frame
    homography, another rounding path, so they may pick the other pixel at
    a tie, on at most 1e-4 of the pixels."""
    if kernel == "K5":
        assert jax_fits(shape) and cuda_warp.warp_fits_pallas(shape)
        fn = warp_image_pallas
    else:
        fn = warp_image_pallas_windowed
    img, hom = image(shape), homs(shape[0], seed=7)
    if mode == "nearest":
        img = np.floor(img * 256).astype(np.float32)
    got = port_warp(img, hom, mode)
    ref = np.asarray(fn(jnp.asarray(img), jnp.asarray(hom), mode, interpret=True))
    if mode == "nearest":
        assert (got != ref).any(-1).mean() <= 1e-4
    else:
        assert np.abs(got - ref).max() < 8e-3


def test_gate_copy_matches_jax_gate():
    for shape in [(32, 640, 640, 3), (32, 80, 80, 1), (8, 240, 320, 3), (2, 128, 128, 3),
                  (2, 16, 16, 1), (1, 480, 640, 3), (1, 256, 320, 64)]:
        assert cuda_warp.warp_fits_pallas(shape) == jax_fits(shape), shape
    assert not cuda_warp.warp_fits_pallas((32, 640, 640, 3))  # -> counts as K4
    assert cuda_warp.warp_fits_pallas((32, 80, 80, 1))        # -> counts as K5


def test_cpu_tensor_takes_plain_version():
    img, hom = image((2, 32, 48, 3)), homs(2)
    before = dict(_build.launch_counts)
    got = tgeo.warp_image(torch.from_numpy(img), torch.from_numpy(hom))
    ref = tgeo.warp_image_plain(torch.from_numpy(img), torch.from_numpy(hom))
    assert torch.equal(got, ref)
    assert cuda_warp.warp_image_cuda(torch.from_numpy(img), torch.from_numpy(hom)).equal(ref)
    assert dict(_build.launch_counts) == before


def test_autograd_function_backward_is_plain_vjp(monkeypatch):
    """`_WarpImage`'s backward against the plain version's autograd, with
    the launch replaced by the plain forward (the kernel needs the card)."""
    monkeypatch.setattr(cuda_warp, "_launch",
                        lambda img, hom, mode: tgeo.warp_image_plain(img, hom, mode).detach())
    rng = np.random.default_rng(5)
    img0, hom0 = image((2, 24, 40, 2)), homs(2, seed=2)
    g = torch.from_numpy(rng.normal(size=(2, 24, 40, 2)).astype(np.float32))
    for mode in ("bilinear", "nearest"):
        a_img = torch.from_numpy(img0).requires_grad_()
        a_hom = torch.from_numpy(hom0).requires_grad_()
        out = cuda_warp._WarpImage.apply(a_img, a_hom, mode)
        out.backward(g)
        b_img = torch.from_numpy(img0).requires_grad_()
        b_hom = torch.from_numpy(hom0).requires_grad_()
        tgeo.warp_image_plain(b_img, b_hom, mode).backward(g)
        assert torch.equal(a_img.grad, b_img.grad)
        if mode == "bilinear":
            assert torch.allclose(a_hom.grad, b_hom.grad, rtol=1e-6, atol=1e-6)
        else:  # the nearest pick is piecewise constant in the homography
            assert b_hom.grad is None and not a_hom.grad.any()
        # and the plain version's gradient in the image is the JAX one
        _, vjp = jax.vjp(lambda i: jgeo._warp_image_xla(i, jnp.asarray(hom0), mode),
                         jnp.asarray(img0))
        ref = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
        np.testing.assert_allclose(a_img.grad.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("margin", [0, 3])
def test_compute_valid_mask_matches_jax(margin):
    hom = homs(3, seed=20)
    got = tgeo.compute_valid_mask((64, 96), torch.from_numpy(hom), margin).numpy()
    ref = np.asarray(jax.jit(lambda h: jgeo.compute_valid_mask((64, 96), h, margin))(hom))
    np.testing.assert_array_equal(got, ref)
    padded = tgeo.compute_valid_mask((64, 96), torch.from_numpy(hom), margin, (4, 2, 3, 5))
    ref = jax.jit(lambda h: jgeo.compute_valid_mask((64, 96), h, margin, (4, 2, 3, 5)))(hom)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ref))


@pytest.mark.parametrize("margin", [0, 3])
def test_warped_pair_valid_mask_matches_jax(margin):
    h1, h2 = homs(2, seed=30), homs(2, seed=40)
    got = tgeo.warped_pair_valid_mask((64, 96), torch.from_numpy(h1), torch.from_numpy(h2),
                                      margin).numpy()
    ref = np.asarray(jax.jit(lambda a, b: jgeo.warped_pair_valid_mask((64, 96), a, b, margin))(
        h1, h2))
    np.testing.assert_array_equal(got, ref)


def test_points_label_maps_and_erosion_match_jax():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-5, 70, (40, 2)).astype(np.float32)
    valid = rng.uniform(size=40) < 0.8
    hom = homs(1, seed=50)[0]
    np.testing.assert_allclose(
        tgeo.warp_points(torch.from_numpy(pts), torch.from_numpy(hom)).numpy(),
        np.asarray(jgeo.warp_points(jnp.asarray(pts), jnp.asarray(hom))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tgeo.homography_scaling(torch.from_numpy(hom), 48, 64).numpy(),
        np.asarray(jgeo.homography_scaling(jnp.asarray(hom), 48, 64)), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        tgeo.points_to_label_map(torch.from_numpy(pts), torch.from_numpy(valid), 48, 64).numpy(),
        np.asarray(jgeo.points_to_label_map(jnp.asarray(pts), jnp.asarray(valid), 48, 64)))
    got = tgeo.warp_label_map(torch.from_numpy(pts), torch.from_numpy(valid), 48, 64,
                              torch.from_numpy(hom))
    ref = jgeo.warp_label_map(jnp.asarray(pts), jnp.asarray(valid), 48, 64, jnp.asarray(hom))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for r in (1, 2, 3, 5):
        np.testing.assert_array_equal(tgeo.ellipse_kernel(r), jgeo.ellipse_kernel(r))
    mask = (rng.uniform(size=(2, 30, 40)) < 0.9).astype(np.float32)
    np.testing.assert_array_equal(
        tgeo.binary_erosion(torch.from_numpy(mask), tgeo.ellipse_kernel(3)).numpy(),
        np.asarray(jgeo.binary_erosion(jnp.asarray(mask), jgeo.ellipse_kernel(3))))


def test_homography_sampler_invariants():
    gen = torch.Generator().manual_seed(0)
    Hs = sample_homography_batch(gen, 64, **PARAMS, perspective_amplitude_x=0.2,
                                 perspective_amplitude_y=0.2, scaling_amplitude=0.2,
                                 max_angle=1.57)
    assert Hs.shape == (64, 3, 3) and Hs.dtype == torch.float32
    corners = torch.tensor([[-1.0, -1.0], [-1.0, 1.0], [1.0, 1.0], [1.0, -1.0]])
    w = tgeo.warp_points(corners, Hs)
    assert (w >= -1 - 5e-3).all() and (w <= 1 + 5e-3).all()  # no artifacts
    assert len({tuple(h.flatten().tolist()) for h in Hs}) == 64
    eye = sample_homography_batch(torch.Generator().manual_seed(1), 2, perspective=False,
                                  scaling=False, rotation=False, translation=False)
    np.testing.assert_allclose(eye.numpy(), np.eye(3)[None].repeat(2, 0), atol=1e-5)
    src = torch.rand(5, 4, 2, generator=gen) * 100
    dst = src + torch.rand(5, 4, 2, generator=gen) * 10
    H = perspective_transform(src, dst)
    np.testing.assert_allclose(tgeo.warp_points(src, H).numpy(), dst.numpy(), atol=1e-3)
