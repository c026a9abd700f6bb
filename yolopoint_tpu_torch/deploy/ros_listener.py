"""Example listener of the port: consume the keypoints and images and track
points (import-gated, like the nodes).

Counterpart of `yolopoint_tpu/deploy/ros_listener.py`: subscribes the
`keypoints` (KeypointArray) and image topics through an approximate time
synchronizer, un-flattens the descriptors and feeds the frame-to-frame
`PointTracker`. `_draw` returns the frame with the tracks drawn (the port's
`PointTracker.draw_tracks`, bit-equal to OpenCV's drawing), the frame the
JAX listener shows with `cv2.imshow`. The port imports no OpenCV and its
machine has no display, so `show=True` raises; pass `show=False`.

Run inside a ROS environment:
  python -m yolopoint_tpu_torch.deploy.ros_listener --image /camera/image \\
      --keypoints keypoints
"""

from __future__ import annotations

import numpy as np

from yolopoint_tpu_torch.deploy.image_msg import imgmsg_to_bgr8
from yolopoint_tpu_torch.deploy.messages import KeypointArray
from yolopoint_tpu_torch.frontend.tracker import PointTracker


class KeypointListener:
    """Time-synchronized (image, KeypointArray) consumer with track drawing."""

    def __init__(
        self,
        image_topic: str,
        keypoint_topic: str = "keypoints",
        max_length: int = 5,
        nn_thresh: float = 0.7,
        show: bool = True,
        slop: float = 0.1,
    ):
        if show:
            raise NotImplementedError(
                "show=True: the port has no cv2.imshow (it imports no OpenCV) and its machine "
                "no display; pass show=False and take the drawn frame from _draw")
        import message_filters
        import rospy
        from keypoint_msg.msg import KeypointArray as RosKeypointArray
        from sensor_msgs.msg import Image

        self.rospy = rospy
        self.tracker = PointTracker(max_length=max_length, nn_thresh=nn_thresh)
        self.show = show

        img_sub = message_filters.Subscriber(image_topic, Image)
        kp_sub = message_filters.Subscriber(keypoint_topic, RosKeypointArray)
        sync = message_filters.ApproximateTimeSynchronizer(
            [img_sub, kp_sub], queue_size=10, slop=slop
        )
        sync.registerCallback(self.callback)

    def callback(self, img_msg, kp_msg) -> None:
        self.last_image = imgmsg_to_bgr8(img_msg)  # the frame `_draw` draws on
        kp = KeypointArray(
            x=np.asarray(kp_msg.x, np.uint16),
            y=np.asarray(kp_msg.y, np.uint16),
            score=np.asarray(kp_msg.score, np.float32),
            desc_len=int(kp_msg.desc_len),
            desc_flat=np.asarray(kp_msg.desc_flat, np.float32),
            frame_id=img_msg.header.frame_id,
        )
        pts = np.stack([kp.x.astype(np.float32), kp.y.astype(np.float32), kp.score])
        desc = kp.descriptors().T  # (D, N) like the tracker expects
        self.tracker.update(pts, desc)

    def _draw(self, img) -> np.ndarray:
        """`img` with the tracks of at least two points drawn, their scores
        normalised by the tracker's threshold."""
        tracks = self.tracker.get_tracks(min_length=2)
        out = img.copy()
        if len(tracks):
            tracks[:, 1] /= max(self.tracker.nn_thresh, 1e-6)  # normalize score
            self.tracker.draw_tracks(out, tracks)
        return out


def main():
    import argparse

    parser = argparse.ArgumentParser(description="YOLOPoint ROS listener (PyTorch port)")
    parser.add_argument("--image", required=True, help="sensor_msgs/Image topic")
    parser.add_argument("--keypoints", default="keypoints")
    parser.add_argument("--max-length", type=int, default=5)
    parser.add_argument("--nn-thresh", type=float, default=0.7)
    args = parser.parse_args()

    import rospy

    rospy.init_node("yolopoint_tpu_listener")
    KeypointListener(args.image, args.keypoints, args.max_length, args.nn_thresh, show=False)
    rospy.spin()


if __name__ == "__main__":
    main()
