"""Message schemas of the ROS layer, transport-agnostic (the port's own copy
of the JAX package's `deploy/messages.py`: the same names, fields, defaults
and codecs).

`KeypointArray` (uint16 x/y, float32 score, uint8 desc_len, float32
desc_flat) and the `ObjectInstance2D` fields the node fills mirror the IDL
in `deploy/ros_pkg/msg/`; the `object_msgs` dataclasses mirror
`deploy/ros_pkg/object_msgs/msg/`. `CovarianceHelper` packs and unpacks the
validity-reduced covariance of `Object3D` through the port's host code
(`data/native.py:cov_pack_upper` / `cov_unpack_upper`: compiled for a GPU
run, numpy for `device` cpu).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class KeypointArray:
    """Sparse keypoints + flattened descriptors for one frame."""

    x: np.ndarray            # (N,) uint16
    y: np.ndarray            # (N,) uint16
    score: np.ndarray        # (N,) float32
    desc_len: int            # descriptor dimension (64/128/192/256)
    desc_flat: np.ndarray    # (N * desc_len,) float32
    frame_id: str = ""
    stamp: float = 0.0

    def descriptors(self) -> np.ndarray:
        """(N, D) unflattened descriptors (the listener's reconstruction)."""
        n = len(self.x)
        return self.desc_flat.reshape(n, self.desc_len) if n else np.zeros((0, self.desc_len))

    def to_dict(self) -> dict[str, Any]:
        return {
            "x": self.x.tolist(), "y": self.y.tolist(),
            "score": self.score.tolist(), "desc_len": int(self.desc_len),
            "desc_flat": self.desc_flat.tolist(),
            "frame_id": self.frame_id, "stamp": self.stamp,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "KeypointArray":
        return cls(
            x=np.asarray(d["x"], np.uint16), y=np.asarray(d["y"], np.uint16),
            score=np.asarray(d["score"], np.float32), desc_len=int(d["desc_len"]),
            desc_flat=np.asarray(d["desc_flat"], np.float32),
            frame_id=d.get("frame_id", ""), stamp=float(d.get("stamp", 0.0)),
        )


@dataclasses.dataclass
class ObjectInstance2D:
    """One 2D detection (the ObjectInstance2D fields the node fills)."""

    class_name: str
    class_index: int
    class_count: int
    class_probabilities: list[float]
    bounding_box_min_x: int
    bounding_box_min_y: int
    bounding_box_max_x: int
    bounding_box_max_y: int
    is_instance: bool = True
    # optional covariance (packed upper triangle, as covariance_helper.h packs it)
    complete_covariance: Optional[np.ndarray] = None

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        if self.complete_covariance is not None:
            d["complete_covariance"] = self.complete_covariance.tolist()
        return d


@dataclasses.dataclass
class ObjectInstance2DArray:
    instances: list[ObjectInstance2D] = dataclasses.field(default_factory=list)
    frame_id: str = ""
    stamp: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "instances": [i.to_dict() for i in self.instances],
            "frame_id": self.frame_id, "stamp": self.stamp,
        }


def keypoints_from_pipeline_output(out: dict[str, np.ndarray], frame_id: str = "",
                                   stamp: float = 0.0) -> KeypointArray:
    """Build a KeypointArray from `InferencePipeline.process_frame` output:
    the valid keypoints, their coordinates rounded half to even
    (`np.round`)."""
    v = out["kp_valid"]
    kp = out["keypoints"][v]
    desc = out["descriptors"][v]
    return KeypointArray(
        x=np.round(kp[:, 0]).astype(np.uint16),
        y=np.round(kp[:, 1]).astype(np.uint16),
        score=out["kp_scores"][v].astype(np.float32),
        desc_len=int(desc.shape[1]) if len(desc) else 0,
        desc_flat=desc.reshape(-1).astype(np.float32),
        frame_id=frame_id, stamp=stamp,
    )


def objects_from_pipeline_output(
    out: dict[str, np.ndarray], names: list[str], frame_id: str = "", stamp: float = 0.0
) -> ObjectInstance2DArray:
    """Build the detection array of the valid boxes; a class index past
    `names` is named by its digits."""
    arr = ObjectInstance2DArray(frame_id=frame_id, stamp=stamp)
    if "boxes" not in out:
        return arr
    for box, score, cls, ok in zip(
        out["boxes"], out["box_scores"], out["box_classes"], out["box_valid"]
    ):
        if not ok:
            continue
        c = int(cls)
        arr.instances.append(
            ObjectInstance2D(
                class_name=names[c] if c < len(names) else str(c),
                class_index=c,
                class_count=len(names),
                class_probabilities=[float(score)],
                bounding_box_min_x=int(box[0]),
                bounding_box_min_y=int(box[1]),
                bounding_box_max_x=int(box[2]),
                bounding_box_max_y=int(box[3]),
            )
        )
    return arr


# --------------------------------------------------------------------------
# object_msgs mirrors: the message set of `deploy/ros_pkg/object_msgs/msg/`
# as transport-agnostic dataclasses, their host-side twins.
# --------------------------------------------------------------------------

NUM_STATES = 24  # ObjectStateIndex range


class ObjectStateIndex:
    """Index constants of the 24-element object state vector
    (`ObjectStateIndex.msg`)."""

    POSE_X, POSE_Y, POSE_Z, POSE_ROLL, POSE_PITCH, POSE_YAW = range(6)
    (VELOCITY_X, VELOCITY_Y, VELOCITY_Z,
     VELOCITY_ROLL, VELOCITY_PITCH, VELOCITY_YAW) = range(6, 12)
    (ACCELERATION_X, ACCELERATION_Y, ACCELERATION_Z,
     ACCELERATION_ROLL, ACCELERATION_PITCH, ACCELERATION_YAW) = range(12, 18)
    (DIMENSION_LENGTH_TO_FRONT, DIMENSION_LENGTH_TO_REAR,
     DIMENSION_WIDTH_TO_LEFT, DIMENSION_WIDTH_TO_RIGHT,
     DIMENSION_HEIGHT_TO_UPPER, DIMENSION_HEIGHT_TO_BOTTOM) = range(18, 24)


class MotionType:
    UNKNOWN = 0
    GENERIC_STATIC = 1
    GENERIC_DYNAMIC = 2


class ObjectClass:
    (UNKNOWN, CAR, TRUCK, BICYCLE, MOTORCYCLE, PEDESTRIAN, TREE, BUSH,
     TRAFFIC_SIGN, ERICARD, BUS, TRAILER, CONSTRUCTION_VEHICLE,
     TRAFFIC_CONE, BARRIER) = range(15)


class ReferencePointType:
    UNKNOWN = 0
    BOUNDING_BOX_CENTER = 1
    REAR_AXLE_CENTER_GROUND = 2


@dataclasses.dataclass
class Pose32:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0


Pose64 = Pose32  # same fields; float64 is numpy-side a dtype concern only


@dataclasses.dataclass
class ObjectDimension:
    """Signed box extents from the reference point (`ObjectDimension.msg`)."""

    length_to_front: float = 0.0
    length_to_rear: float = 0.0
    width_to_left: float = 0.0
    width_to_right: float = 0.0
    height_to_upper: float = 0.0
    height_to_bottom: float = 0.0


@dataclasses.dataclass
class ObjectClassEstimate:
    class_id: int = 0
    certainty: float = 0.0


@dataclasses.dataclass
class Object3D:
    """Full object message (`Object.msg`): pose/velocity/acceleration,
    dimensions, validity-reduced packed covariance and class info."""

    object_id: int = 0
    description: str = ""
    pose: Pose32 = dataclasses.field(default_factory=Pose32)
    velocity: Pose32 = dataclasses.field(default_factory=Pose32)
    acceleration: Pose32 = dataclasses.field(default_factory=Pose32)
    dimension: ObjectDimension = dataclasses.field(default_factory=ObjectDimension)
    state_validity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(NUM_STATES, bool))
    complete_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    reference_point_type: int = ReferencePointType.UNKNOWN
    motion_type: int = MotionType.UNKNOWN
    object_class: int = ObjectClass.UNKNOWN
    object_class_estimate: list[ObjectClassEstimate] = dataclasses.field(default_factory=list)
    existence_probability: float = -1.0
    timestamp: float = 0.0


@dataclasses.dataclass
class Objects3D:
    objects: list[Object3D] = dataclasses.field(default_factory=list)
    frame_id: str = ""
    stamp: float = 0.0


class CovarianceHelper:
    """Pack/unpack/reshape helpers for the validity-reduced covariance of
    `Object3D`: the python twin of the C++ header
    (`deploy/ros_pkg/object_msgs/include/object_msgs/covariance_helper.h`).
    The pack and unpack run in the port's compiled host code unless
    `device` is the CPU (`data.native.cov_pack_upper` / `cov_unpack_upper`);
    a failed build raises."""

    @staticmethod
    def covariance_from_msg(msg: Object3D, device: str | torch.device = "cuda") -> np.ndarray:
        from yolopoint_tpu_torch.data.native import cov_unpack_upper

        n = int(np.asarray(msg.state_validity, bool).sum())
        return cov_unpack_upper(np.asarray(msg.complete_covariance, np.float32), n, device)

    @staticmethod
    def covariance_to_msg(cov: np.ndarray, mask: np.ndarray, msg: Object3D,
                          device: str | torch.device = "cuda") -> Object3D:
        from yolopoint_tpu_torch.data.native import cov_pack_upper

        msg.complete_covariance = cov_pack_upper(np.asarray(cov, np.float32), device)
        msg.state_validity = np.asarray(mask, bool)
        return msg

    @staticmethod
    def get_sub_matrix(cov: np.ndarray, indices) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        return cov[idx[:, None], idx[None, :]]

    @staticmethod
    def set_sub_matrix(cov: np.ndarray, indices, sub: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        cov[idx[:, None], idx[None, :]] = sub
        return cov

    @staticmethod
    def indices_from_mask(mask) -> np.ndarray:
        return np.flatnonzero(np.asarray(mask, bool))

    @staticmethod
    def mask_from_indices(indices) -> np.ndarray:
        mask = np.zeros(NUM_STATES, bool)
        mask[np.asarray(indices, np.int64)] = True
        return mask

    @staticmethod
    def reshape_by_random_variables(in_cov: np.ndarray, in_states, out_states) -> np.ndarray:
        """Covariance over `in_states` -> covariance over `out_states`:
        shared states copy across, new states get zero rows/cols."""
        in_states = list(in_states)
        out_states = list(out_states)
        out = np.zeros((len(out_states), len(out_states)), in_cov.dtype)
        pos = {s: i for i, s in enumerate(in_states)}
        for a, sa in enumerate(out_states):
            ia = pos.get(sa)
            if ia is None:
                continue
            for b, sb in enumerate(out_states):
                ib = pos.get(sb)
                if ib is not None:
                    out[a, b] = in_cov[ia, ib]
        return out
