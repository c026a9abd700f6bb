"""The ROS1 node of the port driven by the parameter server (roslaunch
style); import-gated like `ros_node.py`.

Counterpart of `yolopoint_tpu/deploy/ros_param_node.py`: every setting
comes from a private `~yolocfg` namespace filled by a launch file
(`ros_pkg/launch/yolopoint.launch`), so several per-camera nodes can share
one launch file under different namespaces.

Params read under `~yolocfg/`:
  weights        reference-schema checkpoint file
  image_topic    sensor_msgs/Image source
  img_size       optional resize of the longer side
  detection_threshold / nms / top_k / conf_thresh / iou_thresh / max_det /
  filter_pts_in_boxes
  template       optional {frame_id: mask path} dict for static ego masks
  compute_dtype  'bf16' (default) or 'f32'
  device         optional torch device (default: the GPU)
"""

from __future__ import annotations

from typing import Any

import torch

PIPELINE_KEYS = ("detection_threshold", "nms", "top_k", "conf_thresh", "iou_thresh", "max_det",
                 "filter_pts_in_boxes")


def load_param_config(rospy) -> dict[str, Any]:
    """Fetch the `~yolocfg` dict from the parameter server, falling back to
    the global `yolocfg`."""
    cfg = rospy.get_param("~yolocfg", None)
    if cfg is None:
        cfg = rospy.get_param("yolocfg", {})
    if not isinstance(cfg, dict):
        raise ValueError("yolocfg parameter must be a dict (set via rosparam)")
    return cfg


def build_node(device: str | torch.device | None = None):
    """Construct the pipeline and node from the parameter server and return
    the running `YoloPointRosNode`. The deploy path of the JAX package's
    node: BN folded into the convolutions, the fused model in bf16 unless
    `compute_dtype` is f32. It runs on `device`, else the config's
    `device`, else the GPU."""
    import rospy

    from yolopoint_tpu_torch.deploy.ros_node import YoloPointRosNode
    from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline
    from yolopoint_tpu_torch.models import build_model
    from yolopoint_tpu_torch.models.convert import fold_batch_norm, is_folded, load_weights
    from yolopoint_tpu_torch.utils.device import resolve_device

    rospy.init_node("yolopoint_tpu")
    cfg = load_param_config(rospy)
    device = resolve_device(device if device is not None else cfg.get("device"))

    loaded = load_weights(str(cfg["weights"]), device)
    meta = loaded["meta"]
    names = list(meta.get("names", cfg.get("names", [])))
    bf16 = str(cfg.get("compute_dtype", "bf16")).lower() in ("bf16", "bfloat16")
    dtype = torch.bfloat16 if bf16 else torch.float32

    state = loaded["state_dict"]
    if not is_folded(state):
        state = fold_batch_norm(state)
    model = build_model(
        meta.get("model_name", cfg.get("model_name", "YOLOPoint")),
        meta.get("version", cfg.get("version", "s")),
        nc=max(len(names), 1), fused=True, device="cpu",
    )
    model.load_state_dict(state)
    pipeline = InferencePipeline(model, {k: cfg[k] for k in PIPELINE_KEYS if k in cfg},
                                 compute_dtype=dtype, device=device)
    return YoloPointRosNode(
        pipeline, names,
        source_topic=str(cfg.get("image_topic", "image")),
        img_size=cfg.get("img_size"),
        templates=cfg.get("template"),
        device=device,
    )


def main():
    import rospy

    build_node()
    rospy.spin()


if __name__ == "__main__":
    main()
