"""PyTorch + CUDA port of the oetr_tpu OETR forward.

The package stands alone: it imports torch and numpy, never JAX or the
``oetr_tpu`` package, so it runs where only torch is installed (the
machine with the CUDA card has neither flax nor orbax, which the JAX
package's models and checkpoints need).
Entry points (``build_oetr`` and the model's forward) run on the card
unless the caller passes ``device="cpu"``.
"""
from .config import (BackboneConfig, NeckConfig, OETRConfig, oetr_r50_config,
                     oetr_r50_kernels_config, replace)
from .models import OETR, build_oetr, decode_boxes

__all__ = ["BackboneConfig", "NeckConfig", "OETRConfig", "oetr_r50_config",
           "oetr_r50_kernels_config", "replace", "OETR", "build_oetr", "decode_boxes"]
