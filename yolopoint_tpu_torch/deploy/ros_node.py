"""The ROS1 node of the port (import-gated: the package has no ROS
dependency).

Counterpart of `yolopoint_tpu/deploy/ros_node.py`: subscribe a
`sensor_msgs/Image` topic, run the port's `InferencePipeline` on each frame
(on the GPU: one K1 keypoint NMS, one K2 box NMS and one K3 descriptor
sampling launch a frame), and publish `keypoints` (KeypointArray, the
descriptors flattened) and `objects` (ObjectInstance2DArray). Static
per-camera templates of the ego vehicle suppress the keypoints that fall on
them: each template is read in grey as `cv2.imread(path, 0)` reads it
(`data/datasets._imread`), and `tpl > 0` is eroded by a 7x7 square
(`data/native.erode`, which is `cv2.erode` of the u8 template followed by
`> 0`). The image is decoded by `image_msg.imgmsg_to_bgr8` in place of
cv_bridge.

Run inside a ROS environment:
  python -m yolopoint_tpu_torch.deploy.ros_node --weights FILE --source /camera/image
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch

from yolopoint_tpu_torch.deploy.image_msg import imgmsg_to_bgr8

TEMPLATE_KERNEL = np.ones((7, 7), np.uint8)


class YoloPointRosNode:
    """rospy wrapper around the InferencePipeline.

    Args:
      pipeline: the port's `InferencePipeline`.
      names: class names.
      source_topic: `sensor_msgs/Image` topic to subscribe.
      img_size: the longer side frames are resized to (None: as they come).
      templates: optional `{frame_id: mask image path}` of static ego-vehicle
        masks; keypoints inside a mask are suppressed before publishing.
      publish: publish the two topics (False: only run the callback).
      device: where the host code runs (the template's grey read and
        erosion): compiled for a GPU, numpy for the CPU; default the
        pipeline's device.

    After each callback `last_timing` holds its phases in ms: `decode`,
    `process_frame`, `mask` and `publish`.
    """

    def __init__(
        self,
        pipeline,
        names: list[str],
        source_topic: str,
        img_size: Optional[int] = None,
        templates: Optional[Mapping[str, str]] = None,
        publish: bool = True,
        device: str | torch.device | None = None,
    ):
        import rospy  # gated: only available inside a ROS environment
        from sensor_msgs.msg import Image

        self.rospy = rospy
        self.pipeline = pipeline
        self.names = names
        self.img_size = img_size
        self.device = torch.device(device if device is not None
                                   else getattr(pipeline, "device", "cuda"))
        self.templates: dict[str, np.ndarray] = {}
        if templates:
            self._load_templates(templates)
        self.last_timing: dict[str, float] = {}

        self.publish = publish
        if publish:
            self.keypoints_pub = rospy.Publisher("keypoints", self._kp_msg_type(), queue_size=10)
            self.objects_pub = rospy.Publisher("objects", self._obj_msg_type(), queue_size=10)
        self.image_sub = rospy.Subscriber(source_topic, Image, self.callback)

    @staticmethod
    def _kp_msg_type():
        from keypoint_msg.msg import KeypointArray

        return KeypointArray

    @staticmethod
    def _obj_msg_type():
        from object_msgs.msg import ObjectInstance2DArray

        return ObjectInstance2DArray

    def _load_templates(self, templates: Mapping[str, str]) -> None:
        """Each readable template as its eroded `> 0` mask (uint8 0/1); a
        file that `cv2.imread` returns None for is skipped, as the JAX node
        skips it (one it reads and the port does not raises)."""
        from yolopoint_tpu_torch.data.datasets import _imread
        from yolopoint_tpu_torch.data.native import host_warp_for

        erode = host_warp_for(self.device).erode
        for frame_id, path in templates.items():
            try:
                t = _imread(str(path), self.device, channels=1)[..., 0]
            except FileNotFoundError:
                continue
            mask = erode((t > 0).astype(np.float32), TEMPLATE_KERNEL)
            self.templates[frame_id] = (mask > 0).astype(np.uint8)

    def callback(self, data) -> None:
        t0 = time.perf_counter()
        img = imgmsg_to_bgr8(data)
        t1 = time.perf_counter()
        out = self.pipeline.process_frame(img, self.img_size)
        t2 = time.perf_counter()

        # suppress keypoints inside the static template for this camera
        tpl = self.templates.get(data.header.frame_id)
        if tpl is not None:
            kp = out["keypoints"].astype(int)
            inside = (
                (kp[:, 1] >= 0) & (kp[:, 1] < tpl.shape[0])
                & (kp[:, 0] >= 0) & (kp[:, 0] < tpl.shape[1])
            )
            hit = np.zeros(len(kp), bool)
            hit[inside] = tpl[kp[inside, 1], kp[inside, 0]] > 0
            out["kp_valid"] = out["kp_valid"] & ~hit
        t3 = time.perf_counter()

        if self.publish:
            self._publish(out, data.header)
        t4 = time.perf_counter()
        self.last_timing = {k: v * 1e3 for k, v in (
            ("decode", t1 - t0), ("process_frame", t2 - t1), ("mask", t3 - t2),
            ("publish", t4 - t3))}

    def _publish(self, out, header) -> None:
        from yolopoint_tpu_torch.deploy.messages import (
            keypoints_from_pipeline_output,
            objects_from_pipeline_output,
        )

        kp = keypoints_from_pipeline_output(out)
        KeypointArray = self._kp_msg_type()
        msg = KeypointArray()
        msg.header = header
        msg.x = kp.x
        msg.y = kp.y
        msg.score = kp.score
        msg.desc_len = np.uint8(kp.desc_len)
        msg.desc_flat = kp.desc_flat.astype(float)
        self.keypoints_pub.publish(msg)

        objs = objects_from_pipeline_output(out, self.names)
        ObjectInstance2DArray = self._obj_msg_type()
        arr = ObjectInstance2DArray()
        arr.header = header
        for inst in objs.instances:
            from object_msgs.msg import ObjectInstance2D

            m = ObjectInstance2D()
            m.class_name = inst.class_name
            m.class_index = inst.class_index
            m.class_count = inst.class_count
            m.class_probabilities = inst.class_probabilities
            m.is_instance = inst.is_instance
            m.bounding_box_min_x = inst.bounding_box_min_x
            m.bounding_box_min_y = inst.bounding_box_min_y
            m.bounding_box_max_x = inst.bounding_box_max_x
            m.bounding_box_max_y = inst.bounding_box_max_y
            arr.instances.append(m)
        self.objects_pub.publish(arr)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="YOLOPoint ROS node (PyTorch port)")
    parser.add_argument("--weights", required=True)
    parser.add_argument("--source", required=True, help="image topic")
    parser.add_argument("--img-size", type=int, default=None)
    parser.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = parser.parse_args(argv)

    import rospy

    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, deploy_model
    from yolopoint_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # the JAX node's model: the checkpoint's architecture, not folded, in f32
    model, dtype, names, _ = deploy_model(args.weights, "YOLOPoint", "s", None, f32=True,
                                          device=device)
    pipeline = InferencePipeline(model, compute_dtype=dtype, device=device)

    rospy.init_node("yolopoint_tpu")
    YoloPointRosNode(pipeline, list(names or []), args.source, args.img_size, device=device)
    rospy.spin()


if __name__ == "__main__":
    main()
