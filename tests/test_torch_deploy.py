"""The port's ROS layer (`yolopoint_tpu_torch/deploy/`) against the JAX
package's (`yolopoint_tpu/deploy/`), on the CPU, through a fake rospy /
sensor_msgs / keypoint_msg / object_msgs / message_filters stack (and, for
the JAX nodes only, a fake cv_bridge that converts as cv_bridge does, with
`cv2.cvtColor`):

* every case of `tests/test_deploy.py` (message codecs, the covariance
  helper, the node's callback with a canned pipeline, the template mask,
  the no-publish flag, the listener, the parameter config), run against
  both packages as cases of one parametrised test;
* the node (`ros_node.main`) and the parameter node (`build_node`) with a
  real pipeline on both sides: YOLOPoint-n in f32, frames of a panned
  canvas at 128 px, weights whose BN statistics are the frames' own (as
  `tests/test_torch_demo.py` makes them): `x`, `y`, `desc_len` and the
  instances equal, `score` and `desc_flat` within 1e-5;
* the template mask (the port's grey read and `erode`) against
  `cv2.imread(path, 0)` and `cv2.erode`, for PNG, JPEG and BMP templates;
* `image_msg.imgmsg_to_bgr8` against `cv2.cvtColor` for the five encodings
  with padded rows, and the refusal of the others;
* the listener's tracks, and `_draw`'s frame against what the JAX listener
  hands to `cv2.imshow`;
* the catkin package's message IDL and covariance header byte-equal to the
  JAX package's (three comments name the reference's package without its
  path), its scripts importing the port;
* the compiled covariance pack / unpack (`host_image.cpp`, built here with
  g++) against the numpy twins.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolopoint_tpu.deploy import messages as jax_messages
from yolopoint_tpu_torch.deploy import image_msg
from yolopoint_tpu_torch.deploy import messages as port_messages
from yolopoint_tpu_torch.models import build_model
from yolopoint_tpu_torch.models.convert import state_dict_to_reference

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")
NAMES = ["car", "truck", "bike"]


def messages(pkg):
    return jax_messages if pkg == "jax" else port_messages


def host_kwargs(pkg) -> dict:
    """The port's host code runs where `device` says: here the CPU."""
    return {} if pkg == "jax" else {"device": "cpu"}


def node_module(pkg, name):
    import importlib

    return importlib.import_module(f"yolopoint_tpu{'' if pkg == 'jax' else '_torch'}.deploy.{name}")


def _pipeline_output(n=5, d=8, with_boxes=True):
    """Canned `InferencePipeline.process_frame`-style output: 5 keypoints of
    which 3 valid, 3 boxes of which 2 valid (`tests/test_deploy.py`'s)."""
    rng = np.random.default_rng(0)
    out = {
        "keypoints": np.array(
            [[10.4, 20.6], [100.0, 50.0], [3.0, 7.0], [640.0, 480.0], [1.0, 1.0]],
            np.float32,
        )[:n],
        "kp_scores": np.linspace(0.9, 0.1, n).astype(np.float32),
        "kp_valid": np.array([True, True, False, True, False])[:n],
        "descriptors": (lambda v: v / np.linalg.norm(v, axis=1, keepdims=True))(
            rng.normal(size=(n, d))
        ).astype(np.float32),
    }
    if with_boxes:
        out.update(
            boxes=np.array([[0, 0, 50, 60], [10, 10, 90, 120], [5, 5, 6, 6]], np.float32),
            box_scores=np.array([0.9, 0.7, 0.2], np.float32),
            box_classes=np.array([2, 0, 1], np.int32),
            box_valid=np.array([True, True, False]),
        )
    return out


# ---------------------------------------------------------------------------
# message codecs and the covariance helper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_keypoint_array_roundtrip(pkg):
    m = messages(pkg)
    out = _pipeline_output()
    kp = m.keypoints_from_pipeline_output(out, frame_id="cam0", stamp=1.5)
    assert kp.x.tolist() == [10, 100, 640]
    assert kp.y.tolist() == [21, 50, 480]
    assert kp.desc_len == 8 and kp.desc_flat.shape == (3 * 8,)
    np.testing.assert_array_equal(kp.descriptors(), out["descriptors"][out["kp_valid"]])
    kp2 = m.KeypointArray.from_dict(kp.to_dict())
    for f in ("x", "y", "score", "desc_flat"):
        np.testing.assert_array_equal(getattr(kp2, f), getattr(kp, f))
    assert kp2.frame_id == "cam0" and kp2.stamp == 1.5
    # np.round: halves to even, as the JAX package rounds
    out["keypoints"][:2] = [[2.5, 3.5], [0.5, 1.5]]
    half = m.keypoints_from_pipeline_output(out)
    assert half.x.tolist() == [2, 0, 640] and half.y.tolist() == [4, 2, 480]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_keypoint_array_empty(pkg):
    out = _pipeline_output()
    out["kp_valid"] = np.zeros(5, bool)
    kp = messages(pkg).keypoints_from_pipeline_output(out)
    assert len(kp.x) == 0 and kp.desc_len == 0
    assert kp.descriptors().shape == (0, 0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_objects_from_pipeline_output(pkg):
    m = messages(pkg)
    arr = m.objects_from_pipeline_output(_pipeline_output(), NAMES, frame_id="cam0")
    assert isinstance(arr, m.ObjectInstance2DArray)
    assert len(arr.instances) == 2
    a, b = arr.instances
    assert a.class_name == "bike" and a.class_index == 2
    assert (a.bounding_box_min_x, a.bounding_box_min_y,
            a.bounding_box_max_x, a.bounding_box_max_y) == (0, 0, 50, 60)
    assert a.class_probabilities == [pytest.approx(0.9)]
    assert b.class_name == "car" and b.class_count == 3
    assert m.objects_from_pipeline_output(_pipeline_output(with_boxes=False), NAMES).instances \
        == []
    # the dict codec of both packages gives the same dicts
    other = messages("port" if pkg == "jax" else "jax")
    twin = other.objects_from_pipeline_output(_pipeline_output(), NAMES, frame_id="cam0")
    assert arr.to_dict() == twin.to_dict()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_objects_unknown_class_index(pkg):
    out = _pipeline_output()
    out["box_classes"] = np.array([7, 0, 1], np.int32)
    arr = messages(pkg).objects_from_pipeline_output(out, ["car"])
    assert arr.instances[0].class_name == "7"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_covariance_msg_roundtrip(pkg):
    m = messages(pkg)
    rng = np.random.default_rng(1)
    n = 4
    a = rng.normal(size=(n, n)).astype(np.float32)
    cov = a @ a.T
    mask = m.CovarianceHelper.mask_from_indices([0, 2, 5, 7])
    msg = m.CovarianceHelper.covariance_to_msg(cov, mask, m.Object3D(), **host_kwargs(pkg))
    assert msg.complete_covariance.shape == (n * (n + 1) // 2,)
    back = m.CovarianceHelper.covariance_from_msg(msg, **host_kwargs(pkg))
    np.testing.assert_allclose(back, cov, rtol=1e-6)
    assert m.NUM_STATES == 24 and m.Object3D().existence_probability == -1.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_covariance_sub_matrix_and_reshape(pkg):
    H = messages(pkg).CovarianceHelper
    cov = np.arange(16, dtype=np.float32).reshape(4, 4)
    sub = H.get_sub_matrix(cov, [1, 3])
    np.testing.assert_array_equal(sub, [[5, 7], [13, 15]])
    cov2 = H.set_sub_matrix(cov.copy(), [0, 2], np.zeros((2, 2)))
    assert cov2[0, 0] == 0 and cov2[0, 2] == 0 and cov2[2, 0] == 0 and cov2[1, 1] == 5
    out = H.reshape_by_random_variables(sub, [1, 3], [3, 9, 1])
    np.testing.assert_array_equal(out, [[15, 0, 13], [0, 0, 0], [7, 0, 5]])
    assert H.indices_from_mask(H.mask_from_indices([2, 11, 23])).tolist() == [2, 11, 23]
    assert H.mask_from_indices([0]).shape == (messages(pkg).NUM_STATES,)


# ---------------------------------------------------------------------------
# the fake ROS stack
# ---------------------------------------------------------------------------


class _FakePublisher:
    def __init__(self, topic, msg_type, queue_size=10):
        self.topic, self.msg_type = topic, msg_type
        self.published = []

    def publish(self, msg):
        self.published.append(msg)


class _Bag:
    """Attribute bag standing in for a rospy message instance."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


CVT = {"rgb8": cv2.COLOR_RGB2BGR, "bgra8": cv2.COLOR_BGRA2BGR, "rgba8": cv2.COLOR_RGBA2BGR,
       "mono8": cv2.COLOR_GRAY2BGR}


def cv_bridge_bgr8(msg) -> np.ndarray:
    """`CvBridge().imgmsg_to_cv2(msg, "bgr8")` for the 8-bit encodings: the
    rows (their padding dropped), then `cv2.cvtColor` to BGR."""
    ch = {"bgr8": 3, "rgb8": 3, "bgra8": 4, "rgba8": 4, "mono8": 1}[msg.encoding]
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    rows = buf[:msg.step * msg.height].reshape(msg.height, msg.step)[:, :msg.width * ch]
    img = np.ascontiguousarray(rows.reshape(msg.height, msg.width, ch))
    return img if msg.encoding == "bgr8" else cv2.cvtColor(img, CVT[msg.encoding])


class _FakeCvBridge:
    def imgmsg_to_cv2(self, msg, encoding):
        assert encoding == "bgr8"
        return cv_bridge_bgr8(msg)


def image_message(img: np.ndarray, encoding: str = "bgr8", pad: int = 0, frame_id: str = "cam0",
                  as_list: bool = False):
    """A `sensor_msgs/Image` of `img` (already in `encoding`'s channel
    order), each row padded by `pad` bytes."""
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    step = rows.shape[1] + pad
    data = np.concatenate([rows, np.full((h, pad), 0xAB, np.uint8)], axis=1).tobytes()
    return _Bag(header=_Bag(frame_id=frame_id, stamp=0.0), height=h, width=w, encoding=encoding,
                step=step, is_bigendian=0, data=list(data) if as_list else data)


@pytest.fixture
def fake_ros(monkeypatch):
    """Fake rospy / cv_bridge / msg modules; returns a handle with the
    captured publishers, subscribers and parameters."""
    handle = types.SimpleNamespace(publishers=[], subscribers=[], params={})
    rospy = types.ModuleType("rospy")

    def Publisher(topic, msg_type, queue_size=10):
        p = _FakePublisher(topic, msg_type, queue_size)
        handle.publishers.append(p)
        return p

    def Subscriber(topic, msg_type, cb):
        handle.subscribers.append((topic, msg_type, cb))
        return (topic, cb)

    rospy.Publisher = Publisher
    rospy.Subscriber = Subscriber
    rospy.get_param = lambda name, default=None: handle.params.get(name, default)
    rospy.init_node = lambda name: None
    rospy.spin = lambda: None

    cv_bridge = types.ModuleType("cv_bridge")
    cv_bridge.CvBridge = _FakeCvBridge
    sensor_msgs, sensor_msgs_msg = types.ModuleType("sensor_msgs"), types.ModuleType(
        "sensor_msgs.msg")
    sensor_msgs_msg.Image = object
    sensor_msgs.msg = sensor_msgs_msg
    keypoint_msg, keypoint_msg_msg = types.ModuleType("keypoint_msg"), types.ModuleType(
        "keypoint_msg.msg")
    keypoint_msg_msg.KeypointArray = _Bag
    keypoint_msg.msg = keypoint_msg_msg
    object_msgs, object_msgs_msg = types.ModuleType("object_msgs"), types.ModuleType(
        "object_msgs.msg")
    object_msgs_msg.ObjectInstance2DArray = lambda: _Bag(instances=[])
    object_msgs_msg.ObjectInstance2D = _Bag
    object_msgs.msg = object_msgs_msg
    message_filters = types.ModuleType("message_filters")

    class _MFSub:
        def __init__(self, topic, msg_type):
            self.topic = topic

    class _Sync:
        def __init__(self, subs, queue_size=10, slop=0.1):
            self.subs = subs

        def registerCallback(self, cb):
            handle.sync_callback = cb

    message_filters.Subscriber = _MFSub
    message_filters.ApproximateTimeSynchronizer = _Sync
    for name, mod in [
        ("rospy", rospy), ("cv_bridge", cv_bridge),
        ("sensor_msgs", sensor_msgs), ("sensor_msgs.msg", sensor_msgs_msg),
        ("keypoint_msg", keypoint_msg), ("keypoint_msg.msg", keypoint_msg_msg),
        ("object_msgs", object_msgs), ("object_msgs.msg", object_msgs_msg),
        ("message_filters", message_filters),
    ]:
        monkeypatch.setitem(sys.modules, name, mod)
    return handle


class _FakePipeline:
    """process_frame stub returning the canned output (records calls)."""

    def __init__(self, out):
        self.out = out
        self.calls = []

    def process_frame(self, img, img_size=None):
        self.calls.append((img.shape, img_size))
        return {k: v.copy() for k, v in self.out.items()}


def _node(pkg, *args, **kwargs):
    return node_module(pkg, "ros_node").YoloPointRosNode(*args, **kwargs, **host_kwargs(pkg))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ros_node_callback_publishes(fake_ros, pkg):
    pipe = _FakePipeline(_pipeline_output())
    _node(pkg, pipe, NAMES, "camera/image", img_size=512)
    assert fake_ros.subscribers[0][0] == "camera/image"
    cb = fake_ros.subscribers[0][2]
    cb(image_message(np.zeros((480, 640, 3), np.uint8)))
    assert pipe.calls == [((480, 640, 3), 512)]
    kp_pub = next(p for p in fake_ros.publishers if p.topic == "keypoints")
    obj_pub = next(p for p in fake_ros.publishers if p.topic == "objects")
    assert len(kp_pub.published) == 1 and len(obj_pub.published) == 1
    kp_msg = kp_pub.published[0]
    assert list(kp_msg.x) == [10, 100, 640]
    assert int(kp_msg.desc_len) == 8 and len(kp_msg.desc_flat) == 24
    assert kp_msg.desc_flat.dtype == np.float64  # astype(float), as the JAX node sends it
    obj_msg = obj_pub.published[0]
    assert [m.class_name for m in obj_msg.instances] == ["bike", "car"]
    assert obj_msg.instances[0].bounding_box_max_y == 60


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ros_node_template_masking(fake_ros, tmp_path, pkg):
    """Keypoints under the (eroded) static ego template are suppressed; the
    bounds check keeps one outside the template's frame; another camera's
    frames are not masked; a template that does not read is skipped."""
    tpl = np.zeros((480, 640), np.uint8)
    tpl[60:160, 40:140] = 255
    path = tmp_path / "cam0.png"
    cv2.imwrite(str(path), tpl)
    (tmp_path / "broken.png").write_bytes(b"not an image")
    out = _pipeline_output()
    out["keypoints"][1] = (100.0, 100.0)
    node = _node(pkg, _FakePipeline(out), ["car"], "cam",
                 templates={"cam0": str(path), "cam9": str(tmp_path / "broken.png"),
                            "cam8": str(tmp_path / "missing.png")})
    assert set(node.templates) == {"cam0"}
    cb = fake_ros.subscribers[0][2]
    cb(image_message(np.zeros((480, 640, 3), np.uint8), frame_id="cam0"))
    kp_pub = next(p for p in fake_ros.publishers if p.topic == "keypoints")
    assert list(kp_pub.published[0].x) == [10, 640]
    cb(image_message(np.zeros((480, 640, 3), np.uint8), frame_id="other"))
    assert list(kp_pub.published[1].x) == [10, 100, 640]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ros_node_no_publish_flag(fake_ros, pkg):
    _node(pkg, _FakePipeline(_pipeline_output()), [], "cam", publish=False)
    fake_ros.subscribers[0][2](image_message(np.zeros((48, 64, 3), np.uint8)))
    assert fake_ros.publishers == []


def _listener(pkg, *args, **kwargs):
    return node_module(pkg, "ros_listener").KeypointListener(*args, **kwargs)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_listener_feeds_tracker(fake_ros, pkg):
    listener = _listener(pkg, "cam/image", show=False)
    assert hasattr(fake_ros, "sync_callback")
    kp = messages(pkg).keypoints_from_pipeline_output(_pipeline_output(), frame_id="cam0")
    kp_msg = _Bag(x=kp.x, y=kp.y, score=kp.score, desc_len=kp.desc_len,
                  desc_flat=kp.desc_flat)
    img = image_message(np.zeros((48, 64, 3), np.uint8))
    fake_ros.sync_callback(img, kp_msg)
    fake_ros.sync_callback(img, kp_msg)  # same points -> all matched
    assert len(listener.tracker.get_tracks(min_length=2)) == 3


def test_port_listener_refuses_show(fake_ros):
    with pytest.raises(NotImplementedError, match="cv2.imshow.*display"):
        _listener("port", "cam/image")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_param_node_config(fake_ros, pkg):
    import rospy

    load = node_module(pkg, "ros_param_node").load_param_config
    fake_ros.params["~yolocfg"] = {"weights": "w", "top_k": 600}
    assert load(rospy)["top_k"] == 600
    fake_ros.params.clear()
    fake_ros.params["yolocfg"] = {"weights": "g"}
    assert load(rospy)["weights"] == "g"
    fake_ros.params["~yolocfg"] = "nope"
    with pytest.raises(ValueError):
        load(rospy)


# ---------------------------------------------------------------------------
# image messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["bgr8", "rgb8", "bgra8", "rgba8", "mono8"])
def test_image_msg_equals_cv_bridge(encoding):
    rng = np.random.default_rng(len(encoding))
    ch = {"bgr8": 3, "rgb8": 3, "bgra8": 4, "rgba8": 4, "mono8": 1}[encoding]
    for (h, w), pad, as_list in (((7, 5), 0, False), ((9, 13), 3, False), ((4, 6), 8, True)):
        img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        msg = image_message(img, encoding, pad, as_list=as_list)
        got = image_msg.imgmsg_to_bgr8(msg)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, cv_bridge_bgr8(image_message(img, encoding, pad)))


def test_image_msg_refuses_other_encodings():
    img = np.zeros((4, 4, 2), np.uint8)
    for encoding in ("mono16", "bayer_rggb8", "16UC1", "yuv422", "32FC1"):
        msg = image_message(img, "bgr8")
        msg.encoding = encoding
        with pytest.raises(ValueError, match=encoding):
            image_msg.imgmsg_to_bgr8(msg)
    short = image_message(np.zeros((4, 4, 3), np.uint8))
    short.data = short.data[:-1]
    with pytest.raises(ValueError, match="bytes of data"):
        image_msg.imgmsg_to_bgr8(short)


# ---------------------------------------------------------------------------
# the template mask
# ---------------------------------------------------------------------------


def test_template_mask_equals_cv2(tmp_path):
    """The port's grey read of a template and its 7x7 erosion of `> 0`
    against `cv2.imread(path, 0)`, `cv2.erode` and `> 0`, for a grey PNG,
    an RGB PNG (libpng's grey), a JPEG (the Y component) and a BMP
    (OpenCV's grey), with holes and edges the erosion must keep."""
    from yolopoint_tpu_torch.deploy.ros_node import TEMPLATE_KERNEL, YoloPointRosNode

    rng = np.random.default_rng(3)
    tpl = np.zeros((60, 80, 3), np.uint8)
    tpl[10:45, 5:70] = rng.integers(1, 256, (35, 65, 3))
    tpl[20:25, 30:33] = 0  # a hole: it grows by 3 pixels a side
    tpl[50:, :] = 200      # touching the frame's edge: not eroded there
    paths = {"grey_png": (tmp_path / "g.png", tpl[..., 1]), "rgb_png": (tmp_path / "c.png", tpl),
             "jpeg": (tmp_path / "t.jpg", tpl), "bmp": (tmp_path / "t.bmp", tpl)}
    for path, img in paths.values():
        cv2.imwrite(str(path), img)
    node = YoloPointRosNode.__new__(YoloPointRosNode)
    node.device, node.templates = torch.device("cpu"), {}
    node._load_templates({k: str(p) for k, (p, _) in paths.items()})
    for key, (path, _) in paths.items():
        want = cv2.erode(cv2.imread(str(path), 0), TEMPLATE_KERNEL, iterations=1) > 0
        np.testing.assert_array_equal(node.templates[key] > 0, want, err_msg=key)


# ---------------------------------------------------------------------------
# the nodes with a real pipeline on both sides
# ---------------------------------------------------------------------------


def calibrate_bn(model, frames):
    """BatchNorm statistics of the frames (one train-mode pass with momentum
    1), so that scores and descriptors depend on the image."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(np.stack(frames)).permute(0, 3, 1, 2).float() / 255.0)
    model.eval()
    for bn in bns:
        bn.momentum = 0.1


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Four 96x128 frames panning by 32 px over a noise canvas (one of them
    sent as rgb8, one as mono8 with padded rows), a weights file of
    YOLOPoint-n with the frames' BN statistics, and a grey template."""
    tmp = tmp_path_factory.mktemp("ros")
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (96, 128 + 3 * 32, 3), dtype=np.uint8)
    frames = [canvas[:, 32 * i:32 * i + 128] for i in range(4)]
    frames[3] = np.repeat(frames[3][..., 1:2], 3, axis=2)  # sent as mono8
    torch.manual_seed(0)
    model = build_model("YOLOPoint", "n", nc=len(NAMES), device="cpu")
    calibrate_bn(model, frames)
    weights = tmp / "w.pt"
    torch.save({"model_state_dict": state_dict_to_reference(model.state_dict()), "names": NAMES,
                "version": "n", "model_name": "YOLOPoint"}, weights)
    tpl = np.zeros((96, 128), np.uint8)
    tpl[60:, 20:100] = 255  # the ego vehicle's bonnet
    cv2.imwrite(str(tmp / "cam0.png"), tpl)
    msgs = [image_message(frames[0]), image_message(frames[1][..., ::-1].copy(), "rgb8"),
            image_message(frames[2], frame_id="cam1"),
            image_message(frames[3][..., :1].copy(), "mono8", pad=4)]
    return types.SimpleNamespace(weights=weights, template=tmp / "cam0.png", msgs=msgs)


def box_gate(weights, msgs) -> float:
    """A box confidence gate that one to twelve anchors of each frame pass,
    none within 0.4% of it: random weights make neighbouring anchors tie to
    ~1e-7, and an ulp between the packages must not move a box across the
    gate (as `tests/test_torch_demo.py` picks its gate)."""
    from yolopoint_tpu_torch.frontend.pipeline import (
        InferencePipeline,
        deploy_model,
        preprocess_frame,
    )

    model, dtype, _, _ = deploy_model(str(weights), "YOLOPoint", "n", None, True)
    pipe = InferencePipeline(model, {}, dtype, device="cpu")
    scores = []
    for m in msgs:
        img = preprocess_frame(image_msg.imgmsg_to_bgr8(m), 128)[0]
        with torch.no_grad():
            levels = pipe.forward(torch.from_numpy(img[None]))["objects"]
        s = torch.cat([(torch.sigmoid(r[..., 4]) * torch.sigmoid(r[..., 5:].amax(-1))).flatten()
                       for r in levels])
        scores.append(s.sort(descending=True).values.numpy())
    for t in np.sort(np.concatenate([s[:40] for s in scores]))[::-1]:
        gate = t * 0.995
        counts = [(s > gate).sum() for s in scores]
        if min(counts) >= 1 and max(counts) <= 12 and all(
                np.abs(s[:20] / gate - 1).min() > 0.004 for s in scores):
            return float(gate)
    raise AssertionError("no clean box gate")


def published(handle) -> tuple[list, list]:
    kp = next(p for p in handle.publishers if p.topic == "keypoints").published
    obj = next(p for p in handle.publishers if p.topic == "objects").published
    return kp, obj


def assert_same_messages(got, want):
    (gk, go), (wk, wo) = got, want
    assert len(gk) == len(wk) == len(go) == len(wo) > 0
    for g, w in zip(gk, wk):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert int(g.desc_len) == int(w.desc_len)
        np.testing.assert_allclose(g.score, w.score, rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.desc_flat, w.desc_flat, rtol=0, atol=1e-5)
        assert g.header.frame_id == w.header.frame_id
    assert sum(len(g.x) for g in gk) > 20
    for g, w in zip(go, wo):  # every field equal, the box score within 1e-5 as the points'
        strip = lambda insts: [{k: v for k, v in vars(i).items()  # noqa: E731
                                if k != "class_probabilities"} for i in insts]
        assert strip(g.instances) == strip(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_allclose(gi.class_probabilities, wi.class_probabilities, rtol=0,
                                       atol=1e-5)


def run_messages(handle, msgs):
    cb = handle.subscribers[-1][2]
    for m in msgs:
        cb(m)
    return published(handle)


def test_node_main_equals_jax(fake_ros, scene, monkeypatch):
    """`ros_node.main` of both packages (the checkpoint's model in f32, not
    folded) on the same frames: the same messages."""
    from yolopoint_tpu.deploy import ros_node as jax_node
    from yolopoint_tpu_torch.deploy import ros_node as port_node

    monkeypatch.setattr(sys, "argv", ["ros_node", "--weights", str(scene.weights), "--source",
                                      "cam", "--img-size", "128"])
    jax_node.main()
    want = run_messages(fake_ros, scene.msgs)
    fake_ros.publishers.clear()
    port_node.main(["--weights", str(scene.weights), "--source", "cam", "--img-size", "128",
                    "--device", "cpu"])
    got = run_messages(fake_ros, scene.msgs)
    assert_same_messages(got, want)


def test_param_node_equals_jax(fake_ros, scene):
    """`build_node` of both packages from one parameter server (BN folded,
    the fused model in f32, the launch file's keys, a template on camera
    `cam0`): the same messages, the template's keypoints suppressed."""
    from yolopoint_tpu.deploy import ros_param_node as jax_param
    from yolopoint_tpu_torch.deploy import ros_param_node as port_param

    cfg = {"weights": str(scene.weights), "image_topic": "image_raw", "img_size": 128,
           "detection_threshold": 0.015, "nms": 4, "top_k": 300,
           "conf_thresh": box_gate(scene.weights, scene.msgs),
           "iou_thresh": 0.45, "max_det": 300, "compute_dtype": "f32",
           "template": {"cam0": str(scene.template)}}
    fake_ros.params["~yolocfg"] = cfg
    jax_param.build_node()
    want = run_messages(fake_ros, scene.msgs)
    assert fake_ros.subscribers[-1][0] == "image_raw"
    fake_ros.publishers.clear()
    node = port_param.build_node(device="cpu")
    got = run_messages(fake_ros, scene.msgs)
    assert_same_messages(got, want)
    assert sum(len(o.instances) for o in got[1]) >= len(scene.msgs)
    assert node.pipeline.compute_dtype == torch.float32 and set(node.templates) == {"cam0"}
    first = got[0][0]  # camera cam0: no keypoint on the eroded bonnet
    bonnet = node.templates["cam0"]
    assert not bonnet[np.asarray(first.y, int), np.asarray(first.x, int)].any()
    assert set(node.last_timing) == {"decode", "process_frame", "mask", "publish"}


def test_listener_tracks_and_drawing_equal_jax(fake_ros, monkeypatch):
    """Both listeners on the same panning keypoints: the same tracks, and
    the port's `_draw` frame equal to what the JAX listener passes to
    `cv2.imshow`."""
    from yolopoint_tpu.deploy import ros_listener as jax_listener
    from yolopoint_tpu_torch.deploy import ros_listener as port_listener

    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append(img.copy()))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    rng = np.random.default_rng(5)
    base = rng.uniform(10, 110, (40, 2)).astype(np.float32)
    desc = rng.normal(size=(40, 16)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    frames = []
    for t in range(4):
        pts = np.round(base + [2 * t, t])
        noisy = desc + 0.01 * rng.normal(size=desc.shape).astype(np.float32)
        frames.append(_Bag(x=pts[:, 0].astype(np.uint16), y=pts[:, 1].astype(np.uint16),
                           score=rng.uniform(0.02, 0.6, 40).astype(np.float32), desc_len=16,
                           desc_flat=noisy.reshape(-1).astype(float)))
    jl = jax_listener.KeypointListener("cam/image", show=True)
    jcb = fake_ros.sync_callback
    pl = port_listener.KeypointListener("cam/image", show=False)
    pcb = fake_ros.sync_callback
    for kp in frames:
        jcb(image_message(img), kp)
        pcb(image_message(img), kp)
        np.testing.assert_array_equal(pl.tracker.get_tracks(2), jl.tracker.get_tracks(2))
        np.testing.assert_array_equal(pl._draw(pl.last_image), shown[-1])
    assert len(pl.tracker.get_tracks(2)) > 10 and len(shown) == 4
    assert (shown[-1] != img).any()  # tracks were drawn


# ---------------------------------------------------------------------------
# the catkin package and the compiled covariance
# ---------------------------------------------------------------------------


def test_ros_pkg_idl_equals_jax():
    jax_pkg = REPO / "yolopoint_tpu" / "deploy" / "ros_pkg"
    port_pkg = REPO / "yolopoint_tpu_torch" / "deploy" / "ros_pkg"
    same = [p.relative_to(jax_pkg) for p in sorted(jax_pkg.rglob("*"))
            if p.is_file() and (p.suffix in (".msg", ".h") or "object_msgs" in p.parts)]
    assert len(same) >= 15
    for rel in same:  # the same bytes, but for where a comment names the reference's path
        want = re.sub(rb"/\S*?/ros_messages/", b"reference ros_messages/",
                      (jax_pkg / rel).read_bytes())
        assert (port_pkg / rel).read_bytes() == want, rel
    for name in ("yolopoint_node", "yolopoint_param_node", "yolopoint_listener"):
        text = (port_pkg / "scripts" / name).read_text()
        assert "from yolopoint_tpu_torch.deploy." in text and "yolopoint_tpu.deploy" not in text
    for launch in ("yolopoint.launch", "surround_all.launch"):
        text = (port_pkg / "launch" / launch).read_text()
        assert "yolopoint_tpu_torch_ros" in text and "yolopoint_tpu_ros" not in text
    assert "<name>yolopoint_tpu_torch_ros</name>" in (port_pkg / "package.xml").read_text()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host: the compiled twin is checked on the card")
    out = tmp_path_factory.mktemp("host") / "host_image.so"
    src = REPO / "yolopoint_tpu_torch" / "ops" / "csrc" / "host_image.cpp"
    subprocess.run([cxx, "-std=c++17", "-O3", "-fPIC", "-ffp-contract=off", "-shared", "-o",
                    str(out), str(src)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(out))


def test_compiled_covariance_equals_numpy(host_lib, monkeypatch):
    from yolopoint_tpu.data import native as jax_native
    from yolopoint_tpu_torch.data import native
    from yolopoint_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "library", lambda: host_lib)
    for name in ("yp_cov_pack_upper", "yp_cov_unpack_upper"):
        getattr(host_lib, name).argtypes = _build._SIGNATURES[name]
    rng = np.random.default_rng(7)
    for n in (1, 2, 6, 24):
        a = rng.normal(size=(n, n)).astype(np.float32)
        cov = a @ a.T
        packed = native.cov_pack_upper(cov, "cuda")  # compiled
        np.testing.assert_array_equal(packed, native.cov_pack_upper(cov, "cpu"))
        np.testing.assert_array_equal(packed, jax_native.cov_pack_upper(cov))
        full = native.cov_unpack_upper(packed, n, "cuda")
        np.testing.assert_array_equal(full, native.cov_unpack_upper(packed, n, "cpu"))
        np.testing.assert_array_equal(full, jax_native.cov_unpack_upper(packed, n))
    with pytest.raises(ValueError, match="packed values"):
        native.cov_unpack_upper(np.zeros(5, np.float32), 3, "cpu")
