"""The port's training losses against the JAX package's, on the CPU, in f32:
values within 1e-5 relative, and gradients with respect to the network
outputs within 1e-4 relative. The descriptor losses get the JAX package's
own sample draws replayed (`tests/torch_replay.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_replay import descriptor_draws
from yolopoint_tpu.losses import descriptor as jdesc
from yolopoint_tpu.losses.detector import detector_loss as j_det, detector_loss_ce as j_det_ce
from yolopoint_tpu.losses.objects import ObjectLossConfig as JCfg, object_loss as j_obj
from yolopoint_tpu.losses.objects import qfocal_factor as j_qfocal
from yolopoint_tpu.ops.boxes import bbox_iou as j_bbox_iou
from yolopoint_tpu.ops.heatmap import cell_valid_mask as j_cvm, labels_to_cells as j_l2c
from yolopoint_tpu.ops.homography import sample_homography_batch as jax_sample
from yolopoint_tpu_torch.losses import descriptor as tdesc
from yolopoint_tpu_torch.losses.detector import detector_loss, detector_loss_ce
from yolopoint_tpu_torch.losses.objects import ObjectLossConfig, object_loss, qfocal_factor
from yolopoint_tpu_torch.models import ANCHORS_DEFAULT, Detect
from yolopoint_tpu_torch.ops.boxes import bbox_iou
from yolopoint_tpu_torch.ops.heatmap import cell_valid_mask, labels_to_cells

torch.set_num_threads(1)
RTOL = 1e-5


def rel_close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-12), (got, ref)


def test_cell_encoding_matches_jax():
    rng = np.random.default_rng(0)
    labels = (rng.uniform(size=(2, 32, 48)) < 0.03).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 48)) < 0.97).astype(np.float32)
    np.testing.assert_allclose(labels_to_cells(torch.from_numpy(labels)).numpy(),
                               np.asarray(j_l2c(jnp.asarray(labels))), atol=1e-7)
    np.testing.assert_array_equal(cell_valid_mask(torch.from_numpy(mask)).numpy(),
                                  np.asarray(j_cvm(jnp.asarray(mask))))


@pytest.mark.parametrize("kind", ["bce", "ce"])
def test_detector_loss_matches_jax(kind):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 3, (2, 8, 12, 65)).astype(np.float32)
    labels = (rng.uniform(size=(2, 64, 96)) < 0.02).astype(np.float32)
    mask = (rng.uniform(size=(2, 64, 96)) < 0.995).astype(np.float32)
    t, m = j_l2c(jnp.asarray(labels)), j_cvm(jnp.asarray(mask))
    jfn, tfn = (j_det, detector_loss) if kind == "bce" else (j_det_ce, detector_loss_ce)
    ref, jgrad = jax.value_and_grad(lambda x: jfn(x, t, m))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x, labels_to_cells(torch.from_numpy(labels)), cell_valid_mask(torch.from_numpy(mask)))
    got.backward()
    rel_close(got.item(), ref)
    rel_close(x.grad.numpy(), jgrad, 1e-4)


def test_ciou_matches_jax():
    rng = np.random.default_rng(2)
    b1 = np.concatenate([rng.uniform(0, 4, (50, 2)), rng.uniform(0.2, 5, (50, 2))], 1)
    b2 = b1 + rng.normal(0, 0.5, (50, 4))
    b2[:, 2:] = np.abs(b2[:, 2:]) + 0.1
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    for kw in ({"CIoU": True}, {"DIoU": True}, {"GIoU": True}, {}):
        rel_close(bbox_iou(torch.from_numpy(b1), torch.from_numpy(b2), **kw).numpy(),
                  j_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), **kw))


def check_object_loss(fl_gamma, nc, classes):
    """The object loss and its gradients against JAX's, labels drawn from
    `classes` classes."""
    rng = np.random.default_rng(3)
    B, M, na = 2, 6, 3
    sizes = [(8, 12), (4, 6), (2, 3)]
    preds = [rng.normal(0, 1, (B, na, ny, nx, nc + 5)).astype(np.float32) for ny, nx in sizes]
    boxes = np.concatenate([rng.integers(0, classes, (B, M, 1)), rng.uniform(0.1, 0.9, (B, M, 2)),
                            rng.uniform(0.02, 0.6, (B, M, 2))], -1).astype(np.float32)
    mask = rng.uniform(size=(B, M)) < 0.8
    anchors = Detect(nc, ANCHORS_DEFAULT).anchors_per_stride()
    kw = dict(box=0.05, obj=1.0, cls=0.5, anchor_t=4.0, fl_gamma=fl_gamma, label_smoothing=0.1)
    (ref, ref_items), jgrads = jax.value_and_grad(
        lambda p: j_obj(p, jnp.asarray(boxes), jnp.asarray(mask), anchors, JCfg(**kw), nc),
        has_aux=True)([jnp.asarray(p) for p in preds])
    xs = [torch.from_numpy(p).requires_grad_() for p in preds]
    got, items = object_loss(xs, torch.from_numpy(boxes), torch.from_numpy(mask), anchors,
                             ObjectLossConfig(**kw), nc)
    got.backward()
    rel_close(got.item(), ref)
    for k in ("box", "obj", "cls"):
        rel_close(items[k].item(), ref_items[k])
    for x, g in zip(xs, jgrads):
        rel_close(x.grad.numpy(), g, 1e-4)
    return boxes


@pytest.mark.parametrize("fl_gamma,nc", [(0.0, 5), (1.5, 5), (0.0, 1)])
def test_object_loss_matches_jax(fl_gamma, nc):
    check_object_loss(fl_gamma, nc, nc)


def test_object_loss_drops_classes_past_nc_as_jax():
    """Labels of a dataset mix can name classes past the model's `nc`
    (`configs/concat_datasets.yaml`: COCO's 80 under KITTI's 8 names): the
    JAX scatter drops their class targets, and so does the port."""
    boxes = check_object_loss(0.0, 5, 9)
    assert (boxes[..., 0] >= 5).sum() >= 3


def test_qfocal_factor_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (64, 5)).astype(np.float32)
    targets = rng.uniform(size=(64, 5)).astype(np.float32)
    rel_close(qfocal_factor(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
              j_qfocal(jnp.asarray(logits), jnp.asarray(targets)))


def unit_map(rng, shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", ["sparse", "infonce"])
def test_descriptor_loss_matches_jax(kind):
    rng = np.random.default_rng(4)
    B, Hc, Wc, D, N, K = 2, 8, 12, 32, 150, 20
    da, db = unit_map(rng, (B, Hc, Wc, D)), unit_map(rng, (B, Hc, Wc, D))
    valid = np.ones((B, Hc * 8, Wc * 8), np.float32)
    valid[:, :9] = 0
    inv_h = np.asarray(jax_sample(jax.random.PRNGKey(5), B, patch_ratio=0.85))
    key = jax.random.PRNGKey(6)
    jfn = jdesc.descriptor_loss_sparse if kind == "sparse" else jdesc.infonce_loss
    ref, (ga, gb) = jax.value_and_grad(
        lambda a, b: jfn(a, b, jnp.asarray(valid), jnp.asarray(inv_h), key,
                         num_samples_per_image=N, num_masked_non_matches_per_match=K),
        argnums=(0, 1))(jnp.asarray(da), jnp.asarray(db))
    samples = descriptor_draws(key, B, Hc, Wc, N, K)
    ta, tb = torch.from_numpy(da).requires_grad_(), torch.from_numpy(db).requires_grad_()
    tfn = tdesc.descriptor_loss_sparse if kind == "sparse" else tdesc.infonce_loss
    got = tfn(ta, tb, torch.from_numpy(valid), torch.from_numpy(inv_h), samples)
    got.backward()
    rel_close(got.item(), ref)
    rel_close(ta.grad.numpy(), ga, 1e-4)
    rel_close(tb.grad.numpy(), gb, 1e-4)
