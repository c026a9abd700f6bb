"""K6 (the keypoint NMS written out as the full suppressed map) and the
untiled path of `extract_keypoints`, against the JAX package on the CPU.

  `nms_tile_reduce`  against `yolopoint_tpu.ops.pallas_nms.nms_tile_reduce`
     run in interpret mode, at radius 3, 4 and 8, with tied-score plateaus:
     tile maxima and tile positions equal (ties: the last survivor, as the
     JAX function's max over packed keys picks it);
  `extract_keypoints` at shapes that are not multiples of the NMS tile
     (radius 3, 5, 7), against the JAX XLA path: points, scores and
     validity equal, scores exact (no key quantization on this path);
  the suppressed map at radii 15 and 22 (the kernel's global-memory
     branch), iterations 1-3, against the JAX XLA `simple_nms`.
The kernel itself runs only on the card (`chip_smoke.py` holds it against
the plain version there, as does the JAX-free
`tests/test_torch_nms_tiles.py` where a card is present).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.ops.keypoints import extract_keypoints as jax_extract_keypoints
from yolopoint_tpu.ops.pallas_nms import nms_tile_reduce as jax_nms_tile_reduce
from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.cuda_nms import (
    nms_suppressed_map,
    nms_suppressed_map_torch,
    nms_tile_reduce,
)
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints

torch.set_num_threads(1)

CONF, ITERS, BORDER = 0.015, 3, 4


def _heatmap(seed, B, H, W, n_peaks=120, edge_peaks=24):
    """A background around CONF, sparse peaks, a band of peaks along the
    bottom and right edges (inside and outside the border), and two tied
    plateaus: a 2x3 block of the map's largest value inside one tile for
    tile edges 3, 4 and 8, and a 2x5 block."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.02, (B, H, W)).astype(np.float32)
    for b in range(B):
        hm[b, rng.integers(0, H, n_peaks), rng.integers(0, W, n_peaks)] = \
            rng.uniform(0.1, 1.0, n_peaks)
        ys = rng.integers(H - 12, H, edge_peaks)
        xs = rng.integers(0, W, edge_peaks)
        hm[b, ys, xs] = rng.uniform(0.05, 0.9, edge_peaks)
        hm[b, xs % H, rng.integers(W - 12, W, edge_peaks)] = rng.uniform(0.05, 0.9, edge_peaks)
        hm[b, 24:26, 24:27] = 0.9999
        hm[b, 40:42, 11:16] = 0.6
    return hm


@pytest.mark.parametrize("radius,hw", [(3, (48, 60)), (4, (64, 64)), (8, (64, 80))])
def test_nms_tile_reduce_equal_to_jax(radius, hw):
    hm = _heatmap(radius, 2, *hw)
    tmax, targ = nms_tile_reduce(torch.from_numpy(hm), CONF, radius, ITERS, BORDER)
    jmax, jarg = jax_nms_tile_reduce(jnp.asarray(hm), CONF, radius, ITERS, BORDER,
                                     interpret=True)
    jmax, jarg = np.asarray(jmax), np.asarray(jarg)
    assert tmax.dtype == torch.float32 and targ.dtype == torch.int32
    np.testing.assert_array_equal(tmax.numpy(), jmax)
    np.testing.assert_array_equal(targ.numpy(), jarg)
    assert (jmax > 0).sum() > 20
    # the plateau left several survivors in one tile: the position is the
    # last of them, not the first
    nmsed = nms_suppressed_map_torch(torch.from_numpy(hm), CONF, radius, ITERS, BORDER)
    t = radius
    B, H, W = hm.shape
    tiles = nmsed.reshape(B, H // t, t, W // t, t).permute(0, 1, 3, 2, 4).reshape(B, -1, t * t)
    multi = (tiles > 0).sum(-1) > 1
    assert multi.any()
    last = t * t - 1 - tiles.flip(-1).argmax(-1)
    np.testing.assert_array_equal(targ[multi].numpy(), last[multi].numpy())


def test_nms_tile_reduce_rejects_untiled_shape():
    with pytest.raises(ValueError):
        nms_tile_reduce(torch.zeros(1, 30, 32), CONF, 4)


def test_suppressed_map_any_shape_matches_jax_xla():
    """The plain K6 at a shape no tile divides, against the JAX package's
    `simple_nms` + border on the same map."""
    from yolopoint_tpu.ops.keypoints import simple_nms as jax_simple_nms

    hm = _heatmap(11, 2, 53, 47)
    got = nms_suppressed_map(torch.from_numpy(hm), CONF, 5, ITERS, BORDER)
    x = jnp.asarray(hm)
    nmsed = np.asarray(jax_simple_nms(jnp.where(x >= CONF, x, 0.0), 5, ITERS))
    ys, xs = np.mgrid[:53, :47]
    ok = (xs >= BORDER) & (xs < 47 - BORDER) & (ys >= BORDER) & (ys < 53 - BORDER)
    np.testing.assert_array_equal(got.numpy(), np.where(ok[None], nmsed, 0.0))


@pytest.mark.parametrize("radius", [15, 22])
def test_suppressed_map_large_radius_matches_jax_xla(radius):
    """The plain K6 at radii whose halo fits no block of the kernel (it takes
    its global-memory branch on the card), iterations 1-3, against the JAX
    package's XLA `simple_nms` + border on the same map."""
    from yolopoint_tpu.ops.keypoints import simple_nms as jax_simple_nms

    H, W = 96, 112
    hm = _heatmap(radius, 2, H, W)
    x = jnp.asarray(hm)
    ys, xs = np.mgrid[:H, :W]
    ok = (xs >= BORDER) & (xs < W - BORDER) & (ys >= BORDER) & (ys < H - BORDER)
    for it in (1, 2, 3):
        got = nms_suppressed_map_torch(torch.from_numpy(hm), CONF, radius, it, BORDER)
        nmsed = np.asarray(jax_simple_nms(jnp.where(x >= CONF, x, 0.0), radius, it))
        np.testing.assert_array_equal(got.numpy(), np.where(ok[None], nmsed, 0.0))
        assert (got > 0).sum() > 0


@pytest.mark.parametrize("radius", [3, 5, 7])
def test_extract_keypoints_untiled_equal_to_jax(radius):
    H, W, max_k = 101, 94, 300
    assert H % radius and W % radius
    hm = _heatmap(20 + radius, 2, H, W)
    _build.launch_counts.clear()
    pts, sc, ok = extract_keypoints(torch.from_numpy(hm), CONF, radius, max_k, BORDER)
    assert not _build.launch_counts  # the CPU takes the plain versions
    jpts, jsc, jok = map(np.asarray, jax_extract_keypoints(jnp.asarray(hm), CONF, radius,
                                                          max_k, BORDER))
    assert pts.shape == (2, max_k, 2) and sc.shape == (2, max_k)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_array_equal(sc.numpy(), jsc)
    np.testing.assert_array_equal(pts.numpy()[jok], jpts[jok])
    assert jok.sum() > 40
    # points within `radius` of the bottom or right edge survived on both sides
    near = (jpts[..., 0] >= W - BORDER - radius) | (jpts[..., 1] >= H - BORDER - radius)
    assert (near & jok).any()


def test_untiled_radius_through_the_pipeline():
    """`InferencePipeline` at radius 3 (640 is no multiple of 3) returns
    keypoints instead of raising."""
    from yolopoint_tpu_torch.frontend import InferencePipeline
    from yolopoint_tpu_torch.models import build_model

    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=3, device="cpu").eval()
    pipe = InferencePipeline(model, {"nms": 3, "top_k": 50, "detection_threshold": 0.0},
                             device="cpu")
    out = pipe(torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8))
    assert out["keypoints"].shape == (1, 50, 2) and bool(out["kp_valid"].any())
