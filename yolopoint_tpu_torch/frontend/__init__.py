"""Serving frontend of the port: the pipeline, the point tracker and the
demo CLI (`frontend.demo`)."""

from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, preprocess_frame
from yolopoint_tpu_torch.frontend.tracker import PointTracker, match_descriptors

__all__ = ["InferencePipeline", "PointTracker", "match_descriptors", "preprocess_frame"]
