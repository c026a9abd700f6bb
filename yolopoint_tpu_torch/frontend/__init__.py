"""Serving frontend of the port."""

from yolopoint_tpu_torch.frontend.pipeline import InferencePipeline, preprocess_frame

__all__ = ["InferencePipeline", "preprocess_frame"]
