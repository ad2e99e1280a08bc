"""The port's matching pipelines."""
from .matching import (DensePipeline, PipelineConfig, SparsePipeline,
                       gate_boxes, overlap_scale_score)

__all__ = ["DensePipeline", "PipelineConfig", "SparsePipeline", "gate_boxes",
           "overlap_scale_score"]
