"""The port's mutual nearest-neighbour matching and point tracker against the
JAX package's, on the CPU: `mutual_nearest_neighbor` gives the JAX
function's indices and validity (distances within 4e-6: the f32 dot products
sum in another order, and the square root near 0 amplifies that), and `PointTracker`
gives the JAX tracker's tracks, bit for bit, over a seeded 6-frame sequence
whose points partly persist from frame to frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.frontend.tracker import PointTracker as JaxTracker
from yolopoint_tpu.frontend.tracker import match_descriptors as jax_match
from yolopoint_tpu.ops.matching import mutual_nearest_neighbor as jax_mnn
from yolopoint_tpu_torch.frontend import PointTracker, match_descriptors
from yolopoint_tpu_torch.ops import mutual_nearest_neighbor

torch.set_num_threads(1)


def unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("masked", [False, True])
def test_mutual_nearest_neighbor_matches_jax(masked):
    rng = np.random.default_rng(4)
    a = unit(rng, 80, 32)
    b = np.concatenate([a[:50] + 0.2 * unit(rng, 50, 32), unit(rng, 40, 32)])
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    b = b[rng.permutation(len(b))]
    va = rng.random(80) < 0.8 if masked else None
    vb = rng.random(90) < 0.8 if masked else None
    t = (lambda v: None if v is None else torch.from_numpy(v))
    j = (lambda v: None if v is None else jnp.asarray(v))
    got = mutual_nearest_neighbor(torch.from_numpy(a), torch.from_numpy(b), t(va), t(vb), 0.7)
    want = jax_mnn(jnp.asarray(a), jnp.asarray(b), j(va), j(vb), 0.7)
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["indices"].dtype == torch.int32
    d, jd = got["distance"].numpy(), np.asarray(want["distance"])
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(d), finite)
    assert np.abs(d[finite] - jd[finite]).max() <= 4e-6
    assert 20 < got["valid"].sum() < 80


def frames(seed=7, n=6, d=16):
    """Points and descriptors of `n` frames: each frame keeps ~70% of the
    previous frame's points (moved, descriptors perturbed) and adds new ones."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 100, (2, 40))
    desc = unit(rng, 40, d).astype(np.float64)
    out = []
    for _ in range(n):
        out.append((np.vstack([pts, rng.uniform(0, 1, (1, pts.shape[1]))]), desc.T.copy()))
        keep = rng.random(pts.shape[1]) < 0.7
        new = int(rng.integers(5, 20))
        pts = np.hstack([pts[:, keep] + rng.normal(0, 1, (2, int(keep.sum()))),
                         rng.uniform(0, 100, (2, new))])
        moved = desc[keep] + 0.05 * rng.standard_normal((int(keep.sum()), d))
        desc = np.vstack([moved / np.linalg.norm(moved, axis=1, keepdims=True),
                          unit(rng, new, d)])
    return out


def test_match_descriptors_matches_jax():
    (p1, d1), (p2, d2) = frames()[:2]
    np.testing.assert_array_equal(match_descriptors(d1, d2, 0.7), jax_match(d1, d2, 0.7))
    assert match_descriptors(d1, d2, 0.7).shape[1] > 10


@pytest.mark.parametrize("max_length", [2, 4])
def test_tracker_matches_jax(max_length):
    ours, theirs = PointTracker(max_length, 0.7), JaxTracker(max_length, 0.7)
    long_tracks = 0
    for pts, desc in frames():
        ours.update(pts, desc)
        theirs.update(pts, desc)
        np.testing.assert_array_equal(ours.tracks, theirs.tracks)
        assert ours.track_count == theirs.track_count
        for a, b in zip(ours.all_pts, theirs.all_pts):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours._offsets(), theirs._offsets())
        got, want = ours.get_tracks(min_length=2), theirs.get_tracks(min_length=2)
        np.testing.assert_array_equal(got, want)
        long_tracks = max(long_tracks, len(got))
    assert long_tracks > 10
    with pytest.raises(ValueError):
        PointTracker(1, 0.7)
    with pytest.raises(ValueError):
        ours.get_tracks(0)
