"""K3 (descriptor sampling) of the PyTorch port against the JAX package, on the
CPU, at every width the model families use and at two widths that take the
kernel's generic instantiation.

The port's `sample_descriptors` (the op `yolopoint::sample_descriptors`,
whose wrapper takes the plain version for a CPU tensor) is held to the JAX
package's exact f32 `sample_descriptors` within 1e-5, and, where
`sampling_fits_pallas` admits the shape, to the Pallas kernel in interpret
mode within 2e-2 (its bf16 one-hot matmul sets that bound), on f32 and bf16
maps, with N a multiple of no block's points and points on every edge of
the image and outside it. The kernel itself runs only on a GPU;
`chip_smoke.py` holds every instantiation against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.ops.pallas_gather import sample_descriptors_pallas, sampling_fits_pallas
from yolopoint_tpu.ops.sampling import sample_descriptors as jax_sample_descriptors
from yolopoint_tpu_torch.ops.sampling import sample_descriptors

torch.set_num_threads(1)

WIDTHS = (64, 128, 192, 256, 320)  # YOLOPoint n, s, m, l (and SuperPointNet), x
GENERIC = (100, 512)  # widths without an instantiation of their own


def _inputs(seed: int, D: int, dtype: torch.dtype, B=2, Hc=16, Wc=16, N=203):
    """A map rounded once to `dtype` (f32 numpy for JAX) and (B, N) pixel
    points: uniform ones, then each corner, a point on each edge, and
    points outside the image on every side."""
    rng = np.random.default_rng(seed)
    desc = torch.from_numpy(rng.normal(size=(B, Hc, Wc, D)).astype(np.float32)).to(dtype)
    W, H = Wc * 8 - 1.0, Hc * 8 - 1.0
    pts = rng.uniform(0, 1, (B, N, 2)).astype(np.float32) * np.float32([W, H])
    edges = [[0, 0], [W, 0], [0, H], [W, H], [W / 3, 0], [W / 3, H], [0, H / 2], [W, H / 2],
             [-3.0, H / 2], [W + 5.0, H / 3], [W / 2, -0.5], [W / 4, H + 9.0], [-40.0, -40.0],
             [W + 0.5, H + 0.5], [W - 0.25, H - 0.75]]
    pts[:, :len(edges)] = np.float32(edges)
    return desc, pts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDTHS + GENERIC)
def test_sample_descriptors_matches_jax(D, dtype):
    desc, pts = _inputs(D, D, dtype)
    got = sample_descriptors(desc, torch.from_numpy(pts))
    assert got.dtype == torch.float32 and got.shape == (2, 203, D)
    desc_np = desc.float().numpy()
    want = np.asarray(jax_sample_descriptors(jnp.asarray(desc_np), jnp.asarray(pts)))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    if sampling_fits_pallas(desc.shape):
        pallas = np.asarray(sample_descriptors_pallas(jnp.asarray(desc_np), jnp.asarray(pts),
                                                      interpret=True))
        assert np.abs(got.numpy() - pallas).max() <= 2e-2


@pytest.mark.parametrize("D", [0, 513, 1024])
def test_wrapper_refuses_widths_out_of_range(D):
    """The kernel holds at most 512 channels; the wrapper refuses a wider (or
    empty) map on the CPU as on the card."""
    desc = torch.zeros(1, 4, 4, D)
    with pytest.raises(ValueError, match="descriptor width"):
        sample_descriptors(desc, torch.zeros(1, 3, 2))
