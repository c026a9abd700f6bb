"""Box NMS on decoded predictions (`batched_box_nms`), the tiled scan beyond
2048 candidates and merge-NMS, against `yolopoint_tpu.ops.nms` on the CPU.

Both packages get the same `(B, N, 5+nc)` predictions. Detections must be
equal: the same valid slots, classes and scores, boxes within 1e-5 (they
are gathered, not computed). Under merge-NMS the boxes are weighted means
whose sums run in another order than XLA's, and differ by a few f32 ulps
(measured up to 2.3e-5 px, 3.1e-7 relative, at 60-120 px): there boxes are
held to 1e-5 plus 1e-6 relative. `n_candidates` equal.

Tied scores: bf16 scores at the val protocol's conf 0.001 tie often, and
the order among equal scores decides which box suppresses which. The port
orders them lowest index first, as `jax.lax.top_k` does. The JAX package's
`exact_top_k` (`approx_max_k`) leaves that order unspecified, and under
`jit` on the CPU it is not the index order, so the tied cases hold the port
against the JAX package with `jax.lax.top_k` as its top-k (`lax_top_k`
fixture); the untied cases use the JAX package as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.models.detect import Detect as JaxDetect
from yolopoint_tpu.ops.nms import batched_box_nms as jax_batched_box_nms
from yolopoint_tpu.ops.nms import fused_detect_nms as jax_fused_detect_nms
from yolopoint_tpu_torch.models.detect import Detect, decode_levels
from yolopoint_tpu_torch.ops.nms import batched_box_nms, fused_detect_nms

torch.set_num_threads(1)


def _predictions(seed, B, N, nc, tied, img=128.0):
    """Decoded predictions: clustered boxes (so suppression has work), with
    continuous scores or, `tied`, scores from a few objectness and class
    levels (some below the gate either way)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1 * img, 0.9 * img, (B, 12, 2))
    which = rng.integers(0, 12, (B, N))
    ctr = np.take_along_axis(centers, which[..., None], 1) + rng.normal(0, 4.0, (B, N, 2))
    wh = rng.uniform(6, 30, (B, N, 2))
    if tied:
        obj = rng.choice([0.0005, 0.2, 0.5, 0.75, 1.0], (B, N, 1))
        cls = rng.choice([0.002, 0.1, 0.3, 0.6, 0.9], (B, N, nc))
    else:
        obj = rng.uniform(0, 1, (B, N, 1)) ** 2
        cls = rng.uniform(0, 1, (B, N, nc)) ** 2
    return np.concatenate([ctr, wh, obj, cls], -1).astype(np.float32)


@pytest.fixture
def lax_top_k(monkeypatch):
    """The JAX package's box NMS with `jax.lax.top_k` (ties lowest index
    first) as its top-k, traced afresh."""
    import jax

    import yolopoint_tpu.ops.nms as jnms

    monkeypatch.setattr(jnms, "exact_top_k", lambda x, k: jax.lax.top_k(x, k))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _assert_same_detections(got, want, merged=False, decoded_here=False):
    """`decoded_here`: the boxes and scores come out of each framework's own
    sigmoid, which differ by an ulp: scores and boxes are then held to 1e-6
    relative (plus 1e-5 px), as `tests/test_torch_kernels.py` holds the
    serving path's scores."""
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["n_candidates"].numpy(), want["n_candidates"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    ok = want["valid"]
    assert ok.sum(1).min() > 5
    np.testing.assert_array_equal(got["classes"].numpy()[ok], want["classes"][ok])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=1e-6 if decoded_here else 0, atol=0)
    np.testing.assert_allclose(got["boxes"].numpy()[ok], want["boxes"][ok],
                               rtol=1e-6 if merged or decoded_here else 0, atol=1e-5)


CASES = {  # name: (N anchors, max_nms, multi_label, merge, agnostic)
    "dense": (600, 2048, True, False, False),
    "dense-merge": (600, 2048, True, True, False),
    "dense-single-agnostic": (900, 2048, False, False, True),
    "tiled": (1500, 30000, True, False, False),
    "tiled-merge": (1500, 30000, True, True, False),
    "tiled-agnostic": (1500, 30000, True, False, True),
    "tiled-single-merge-agnostic": (2600, 30000, False, True, True),
}


def _check_case(case, tied):
    N, max_nms, multi_label, merge, agnostic = CASES[case]
    pred = _predictions(len(case), 2, N, 3, tied)
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=max_nms,
              multi_label=multi_label, merge=merge, agnostic=agnostic)
    got = batched_box_nms(torch.from_numpy(pred), **kw)
    want = jax_batched_box_nms(jnp.asarray(pred), **kw)
    n_cand = np.asarray(want["n_candidates"])
    assert (n_cand > 2048).all() == (max_nms > 2048)  # the branch the case names
    _assert_same_detections(got, want, merge)


@pytest.mark.parametrize("case", CASES)
def test_batched_box_nms_equal_to_jax(case):
    _check_case(case, tied=False)


@pytest.mark.parametrize("case", ["dense", "tiled", "tiled-merge"])
def test_batched_box_nms_tied_scores_equal_to_jax(case, lax_top_k):
    _check_case(case, tied=True)


def test_decode_levels_matches_jax_detect_decode():
    """`decode_levels` against the JAX Detect head's `decode=True` output
    (same 1x1 convolution weights, so the same raw levels)."""
    import jax

    rng = np.random.default_rng(3)
    feats = [jnp.asarray(rng.normal(size=(2, s, s, c)).astype(np.float32))
             for s, c in ((16, 32), (8, 64), (4, 128))]
    jdet = JaxDetect(nc=3)
    variables = jdet.init(jax.random.PRNGKey(0), feats)
    decoded, raw = jdet.apply(variables, feats, decode=True)
    got = decode_levels([torch.from_numpy(np.array(r)) for r in raw],
                        Detect(nc=3, ch=(32, 64, 128)).anchors_per_stride(), (8, 16, 32))
    assert got.shape == decoded.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(decoded), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("merge", [False, True])
def test_fused_detect_nms_tiled_equal_to_jax(merge):
    """The serving entry beyond 2048 candidates (conf 0.001) and with merge."""
    rng = np.random.default_rng(9)
    raw = [rng.normal(0, 2.0, (2, 3, s, s, 8)).astype(np.float32) for s in (32, 16, 8)]
    anchors = JaxDetect(nc=3).anchors_per_stride()
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, max_nms=30000, merge=merge)
    got = fused_detect_nms([torch.from_numpy(r) for r in raw], anchors, **kw)
    want = jax_fused_detect_nms([jnp.asarray(r) for r in raw], anchors, **kw)
    assert (np.asarray(want["n_candidates"]) > 2048).all()
    _assert_same_detections(got, want, merge, decoded_here=True)
