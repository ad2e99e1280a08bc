"""PyTorch + CUDA port of oetr_tpu: the OETR forward and the overlap-guided
sparse matching pipeline (SuperPoint + SuperGlue).

The package stands alone: it imports torch and numpy, never JAX or the
``oetr_tpu`` package, so it runs where only torch is installed (the
machine with the CUDA card has neither flax nor orbax, which the JAX
package's models and checkpoints need).
Entry points (``build_oetr``, ``build_superpoint``, ``build_superglue``
and the modules and pipeline they feed) run on the card unless the caller
passes ``device="cpu"``.
"""
from .config import (BackboneConfig, NeckConfig, OETRConfig,
                     oetr_fc_r50_config, oetr_r50_config,
                     oetr_r50_kernels_config, replace)
from .models import (OETR, SuperGlue, SuperPoint, build_oetr, build_superglue,
                     build_superpoint, decode_boxes)
from .pipelines import PipelineConfig, SparsePipeline

__all__ = ["BackboneConfig", "NeckConfig", "OETRConfig", "oetr_fc_r50_config",
           "oetr_r50_config", "oetr_r50_kernels_config", "replace", "OETR",
           "build_oetr", "decode_boxes", "SuperGlue", "SuperPoint",
           "build_superglue",
           "build_superpoint", "PipelineConfig", "SparsePipeline"]
