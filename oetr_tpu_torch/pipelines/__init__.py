"""The port's matching pipelines, the public matching API and the
benchmark runner."""
from .api import build_model, build_shipped_model, get_matches, get_pose
from .matching import (DensePipeline, PipelineConfig, SparsePipeline,
                       gate_boxes, overlap_scale_score)
from .runner import run_benchmark

__all__ = ["DensePipeline", "PipelineConfig", "SparsePipeline", "gate_boxes",
           "overlap_scale_score", "build_model", "build_shipped_model",
           "get_matches", "get_pose",
           "run_benchmark"]
