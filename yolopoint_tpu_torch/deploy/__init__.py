"""The ROS layer of the port: transport-agnostic message schemas, the
`sensor_msgs/Image` decode, and the rospy nodes (import-gated: the package
has no ROS dependency).

Counterpart of `yolopoint_tpu/deploy/`. The nodes run the port's
`InferencePipeline` on the GPU (K1 keypoint NMS, K2 box NMS, K3 descriptor
sampling a frame) and publish the same topics and messages as the JAX
package's nodes; images are decoded by `image_msg.imgmsg_to_bgr8`, not by
cv_bridge, and the catkin package is `ros_pkg/` (`yolopoint_tpu_torch_ros`).
"""

from yolopoint_tpu_torch.deploy.messages import (
    KeypointArray,
    ObjectInstance2D,
    ObjectInstance2DArray,
    keypoints_from_pipeline_output,
    objects_from_pipeline_output,
)
