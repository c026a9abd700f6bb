"""Parity of the PyTorch port's kernel modules with the JAX package, on the CPU.

Each kernel wrapper of `yolopoint_tpu_torch` takes its plain PyTorch version
for a CPU tensor; here those plain versions are held against the JAX
package's own functions on the same numpy inputs: the Pallas kernels in
interpret mode (as the JAX package's tests run them) and their XLA twins.
  K1 `nms_tile_keys`  keys bit-equal;
  K2 `greedy_nms_keep` keep masks equal, also on the edge inputs of
     `tests/test_torch_box_nms_blocks.py` (duplicates, all invalid,
     zero-area and NaN boxes, class offsets; thresholds 0 and -0.1);
  K3 `sample_descriptors` within 1e-5 of the exact f32 path, and within
     2e-2 of the Pallas path, whose bf16 one-hot matmul sets that bound.
The kernels themselves run only on a GPU; `chip_smoke.py` holds them
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolopoint_tpu.ops.boxes import box_iou as jax_box_iou
from yolopoint_tpu.ops.boxes import xywh2xyxy as jax_xywh2xyxy
from yolopoint_tpu.ops.heatmap import cells_to_heatmap as jax_cells_to_heatmap
from yolopoint_tpu.ops.keypoints import extract_keypoints as jax_extract_keypoints
from yolopoint_tpu.ops.keypoints import simple_nms as jax_simple_nms
from yolopoint_tpu.ops.nms import _greedy_nms_keep
from yolopoint_tpu.ops.nms import fused_detect_nms as jax_fused_detect_nms
from yolopoint_tpu.ops.pallas_box_nms import pallas_greedy_nms
from yolopoint_tpu.ops.pallas_gather import sample_descriptors_pallas
from yolopoint_tpu.ops.pallas_nms import _tile_keys
from yolopoint_tpu.ops.pallas_nms import nms_tile_keys as jax_nms_tile_keys
from yolopoint_tpu.ops.sampling import sample_descriptors as jax_sample_descriptors
from yolopoint_tpu_torch.ops import _build
from yolopoint_tpu_torch.ops.boxes import box_iou, xywh2xyxy
from yolopoint_tpu_torch.ops.cuda_box_nms import greedy_nms_keep
from yolopoint_tpu_torch.ops.cuda_gather import sample_descriptors_cuda
from yolopoint_tpu_torch.ops.cuda_nms import nms_tile_keys
from yolopoint_tpu_torch.ops.heatmap import cells_to_heatmap
from yolopoint_tpu_torch.ops.keypoints import extract_keypoints
from yolopoint_tpu_torch.ops.nms import fused_detect_nms
from yolopoint_tpu_torch.ops.topk import exact_top_k
from tests.test_torch_box_nms_blocks import make_boxes

torch.set_num_threads(1)

CONF, RADIUS, ITERS, BORDER = 0.015, 4, 3, 4
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _heatmap(seed, B=2, H=128, W=128):
    """f32 maps with a background around CONF and sparse peaks."""
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0, 0.02, (B, H, W)).astype(np.float32)
    for b in range(B):
        n = 150
        hm[b, rng.integers(0, H, n), rng.integers(0, W, n)] = rng.uniform(0.1, 1.0, n)
    return hm


def _as_dtype(hm: np.ndarray, dtype: str) -> np.ndarray:
    """Round to `dtype` once, in torch; returned as f32 numpy so both
    frameworks see the same values."""
    return torch.from_numpy(hm).to(TORCH_DTYPES[dtype]).float().numpy()


# ------------------------------------------------------------------- K1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_k1_keys_bit_equal_to_jax(dtype, ref):
    hm = _as_dtype(_heatmap(0), dtype)
    got = nms_tile_keys(torch.from_numpy(hm).to(TORCH_DTYPES[dtype]), CONF, RADIUS, ITERS, BORDER)
    jhm = jnp.asarray(hm)
    if ref == "pallas_interpret":
        jhm = jhm.astype(jnp.bfloat16) if dtype == "bfloat16" else jhm
        want = jax_nms_tile_keys(jhm, CONF, RADIUS, ITERS, BORDER, RADIUS, interpret=True)
    else:  # `_tile_keys` of the XLA-suppressed, border-masked map
        B, H, W = hm.shape
        nmsed = jax_simple_nms(jnp.where(jhm >= CONF, jhm, 0.0), RADIUS, ITERS)
        ys, xs = np.mgrid[:H, :W]
        ok = (xs >= BORDER) & (xs < W - BORDER) & (ys >= BORDER) & (ys < H - BORDER)
        want = _tile_keys(jnp.where(jnp.asarray(ok)[None], nmsed, 0.0), RADIUS)
    want = np.asarray(want)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 100  # the scene had survivors


def test_extract_keypoints_matches_jax():
    """Same point sets as the JAX XLA path; scores within the keys'
    2^-19 relative quantization at radius 4."""
    hm = _heatmap(1)
    max_k = 400
    pts, sc, ok = extract_keypoints(torch.from_numpy(hm), CONF, RADIUS, max_k, BORDER)
    jpts, jsc, jok = jax_extract_keypoints(jnp.asarray(hm), CONF, RADIUS, max_k, BORDER)
    jpts, jsc, jok = map(np.asarray, (jpts, jsc, jok))
    assert pts.shape == (2, max_k, 2) and sc.shape == (2, max_k)
    for b in range(2):
        assert ok[b].sum() == jok[b].sum() > 50
        ours = {tuple(p): s for p, s in zip(pts[b][ok[b]].tolist(), sc[b][ok[b]].tolist())}
        theirs = {tuple(p): s for p, s in zip(jpts[b][jok[b]].tolist(), jsc[b][jok[b]].tolist())}
        assert ours.keys() == theirs.keys()
        for p, s in theirs.items():
            assert abs(ours[p] - s) <= s * 2.0**-19


def test_extract_keypoints_rejects_untiled_shape():
    """A height that is no multiple of the tile used to be rejected; it now
    takes the exact path (K6's map, padded, tile max) and returns what the
    JAX package returns, while K1 itself still rejects it."""
    hm = _heatmap(2, B=1, H=66, W=64)
    with pytest.raises(ValueError):
        nms_tile_keys(torch.from_numpy(hm), CONF, RADIUS)
    pts, sc, ok = extract_keypoints(torch.from_numpy(hm), CONF, RADIUS, 200)
    jpts, jsc, jok = map(np.asarray, jax_extract_keypoints(jnp.asarray(hm), CONF, RADIUS, 200))
    np.testing.assert_array_equal(sc.numpy(), jsc)
    np.testing.assert_array_equal(pts.numpy()[jok], jpts[jok])
    assert jok.sum() > 20


# ------------------------------------------------------------------- K2


# edge inputs of the kernel's own tests, with their IoU thresholds
K2_EDGE_KINDS = {"duplicates": 0.45, "invalid": 0.45, "edge": 0.45, "classes": 0.45,
                 "edge_thr0": 0.0, "random_negative_thr": -0.1}


def _boxes(seed, K, kind, B=3):
    if kind in K2_EDGE_KINDS:
        boxes, valid = make_boxes(seed, B, K, kind.split("_")[0])
        return boxes.numpy(), valid.numpy(), K2_EDGE_KINDS[kind]
    rng = np.random.default_rng(seed)
    if kind == "chain":  # every box overlaps its neighbours: keep alternates
        x = np.arange(K, dtype=np.float32) * 4.0
        b = np.stack([x, np.zeros(K, np.float32), x + 10.0, np.full(K, 10.0, np.float32)], -1)
        return np.repeat(b[None], B, 0), np.ones((B, K), bool), 0.3
    ctr = rng.uniform(0, 640, (B, K, 2))
    wh = rng.uniform(5, 150, (B, K, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], axis=-1).astype(np.float32)
    return boxes, rng.uniform(size=(B, K)) < 0.85, 0.45


@pytest.mark.parametrize("K", [256, 512])
@pytest.mark.parametrize("kind", ["random", "chain", *K2_EDGE_KINDS])
def test_k2_keep_equal_to_jax(K, kind):
    boxes, valid, iou = _boxes(K, K, kind)
    got = greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), iou).numpy()
    jb, jv = jnp.asarray(boxes), jnp.asarray(valid)
    want_xla = np.asarray(jax.vmap(_greedy_nms_keep, in_axes=(0, 0, None))(jb, jv, iou))
    want_pallas = np.asarray(pallas_greedy_nms(jb, jv, iou, interpret=True))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    if kind == "invalid":
        assert got.sum() == 0
    else:
        assert 0 < got.sum() < valid.sum()  # something was suppressed


def test_box_iou_and_xywh2xyxy_match_jax():
    rng = np.random.default_rng(5)
    xywh = np.concatenate([rng.uniform(0, 100, (40, 2)), rng.uniform(1, 30, (40, 2))], -1)
    xywh = xywh.astype(np.float32)
    xyxy = xywh2xyxy(torch.from_numpy(xywh))
    np.testing.assert_allclose(xyxy.numpy(), np.asarray(jax_xywh2xyxy(jnp.asarray(xywh))),
                               rtol=0, atol=1e-5)
    iou = box_iou(xyxy, xyxy[:25])
    want = np.asarray(jax_box_iou(jnp.asarray(xyxy.numpy()), jnp.asarray(xyxy.numpy()[:25])))
    np.testing.assert_allclose(iou.numpy(), want, rtol=0, atol=1e-6)


def _raw_levels(seed, B=2, nc=3, sizes=(16, 8, 4)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2.0, (B, 3, s, s, 5 + nc)).astype(np.float32) for s in sizes]


def test_fused_detect_nms_matches_jax():
    from yolopoint_tpu.models.detect import Detect as JaxDetect

    raw = _raw_levels(6)
    anchors = JaxDetect(nc=3).anchors_per_stride()
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=1024)
    got = fused_detect_nms([torch.from_numpy(r) for r in raw], anchors, **kw)
    want = {k: np.asarray(v) for k, v in
            jax_fused_detect_nms([jnp.asarray(r) for r in raw], anchors, **kw).items()}
    np.testing.assert_array_equal(got["n_candidates"].numpy(), want["n_candidates"])
    for b in range(2):
        ok, jok = got["valid"][b].numpy(), want["valid"][b]
        assert ok.sum() == jok.sum() > 10
        order = np.argsort(-got["scores"][b].numpy()[ok], kind="stable")
        jorder = np.argsort(-want["scores"][b][jok], kind="stable")
        np.testing.assert_allclose(got["boxes"][b].numpy()[ok][order],
                                   want["boxes"][b][jok][jorder], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(got["classes"][b].numpy()[ok][order],
                                      want["classes"][b][jok][jorder])
        np.testing.assert_allclose(got["scores"][b].numpy()[ok][order],
                                   want["scores"][b][jok][jorder], rtol=1e-6, atol=0)


def test_fused_detect_nms_unported_regimes_raise():
    """Merge-NMS and more than 2048 candidates used to raise; both now run
    (held against the JAX package in `tests/test_torch_box_nms.py`)."""
    raw = [torch.from_numpy(r) for r in _raw_levels(7)]
    anchors = np.ones((3, 3, 2), np.float32)
    out = fused_detect_nms(raw, anchors, merge=True)
    assert out["boxes"].shape == (2, 300, 4) and bool(out["valid"].any())
    big = [torch.zeros(1, 3, s, s, 8) for s in (32, 16, 8)]  # 4032 anchors
    out = fused_detect_nms(big, anchors, conf_thres=0.001, max_nms=4096)
    assert int(out["n_candidates"][0]) == 4032 and int(out["valid"].sum()) > 0


# ------------------------------------------------------------------- K3


def _desc_points(seed, B=2, Hc=40, Wc=40, D=128, N=200):
    rng = np.random.default_rng(seed)
    desc = rng.normal(size=(B, Hc, Wc, D)).astype(np.float32)
    pts = rng.uniform(0, Wc * 8 - 1, (B, N, 2)).astype(np.float32)
    pts[:, :3] = [[0.0, 0.0], [Wc * 8 - 1.0, Hc * 8 - 1.0], [Wc * 8 - 3.5, 1.0]]  # edge taps
    return desc, pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_matches_exact_jax_sampling(dtype):
    desc, pts = _desc_points(8)
    desc = _as_dtype(desc, dtype)
    got = sample_descriptors_cuda(torch.from_numpy(desc).to(TORCH_DTYPES[dtype]),
                                  torch.from_numpy(pts))
    want = np.asarray(jax_sample_descriptors(jnp.asarray(desc), jnp.asarray(pts)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5


def test_k3_matches_pallas_interpret():
    desc, pts = _desc_points(9)
    got = sample_descriptors_cuda(torch.from_numpy(desc), torch.from_numpy(pts)).numpy()
    want = np.asarray(sample_descriptors_pallas(jnp.asarray(desc), jnp.asarray(pts),
                                                interpret=True))
    assert np.abs(got - want).max() <= 2e-2


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cells_to_heatmap_matches_jax(dtype):
    semi = np.random.default_rng(10).normal(0, 3, (2, 8, 12, 65)).astype(np.float32)
    got = cells_to_heatmap(torch.from_numpy(semi), dtype=TORCH_DTYPES[dtype])
    want = jax_cells_to_heatmap(jnp.asarray(semi), dtype=getattr(jnp, dtype))
    assert got.shape == (2, 64, 96) and got.dtype == TORCH_DTYPES[dtype]
    tol = 1e-6 if dtype == "float32" else 2.0**-8  # one bf16 rounding step
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=1e-7)


def test_exact_top_k_on_int_keys():
    x = torch.tensor([[5, 0, 9, 7, 0x3F000000]], dtype=torch.int32)
    v, i = exact_top_k(x, 3)
    assert v.tolist() == [[0x3F000000, 9, 7]] and i.tolist() == [[4, 2, 3]]


# ------------------------------------------------------------------- wrappers


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is launched (and no library is built)."""
    _build.launch_counts.clear()
    hm = torch.from_numpy(_heatmap(11, B=1, H=64, W=64))
    pts, _, _ = extract_keypoints(hm, CONF, RADIUS, 50)
    boxes, valid, iou = _boxes(12, 64, "random", B=1)
    greedy_nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), iou)
    sample_descriptors_cuda(torch.randn(1, 8, 8, 16), pts)
    assert sum(_build.launch_counts.values()) == 0
    assert _build.library.cache_info().currsize == 0


def test_kernel_argument_checks():
    with pytest.raises(ValueError):
        _build.require_cuda(torch.zeros(2, 2), "x", (torch.float32,), 2)
    with pytest.raises(ValueError):
        greedy_nms_keep(torch.zeros(1, 8, 3), torch.ones(1, 8, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError):
        sample_descriptors_cuda(torch.zeros(1, 4, 4, 8), torch.zeros(1, 5, 3))
    with pytest.raises(ValueError):
        nms_tile_keys(torch.zeros(2, 30, 32), CONF, RADIUS)


def test_library_name_tracks_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in _build.sources()} >= {"nms_keys.cu", "box_nms.cu", "gather.cu"}
