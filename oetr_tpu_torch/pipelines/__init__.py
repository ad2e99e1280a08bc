"""The port's matching pipelines."""
from .matching import (PipelineConfig, SparsePipeline, gate_boxes,
                       overlap_scale_score)

__all__ = ["PipelineConfig", "SparsePipeline", "gate_boxes",
           "overlap_scale_score"]
