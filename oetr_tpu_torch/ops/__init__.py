"""Attention ops (plain torch) and the CUDA kernels with their wrappers."""
from .attention import elu_feature_map, full_attention, linear_attention
from .linear_encoder import (linear_encoder_attention,
                             linear_encoder_attention_reference)
from .norm import (gn_scale_shift, groupnorm_relu_maxpool,
                   groupnorm_relu_maxpool_reference)

__all__ = ["elu_feature_map", "full_attention", "linear_attention",
           "linear_encoder_attention", "linear_encoder_attention_reference",
           "gn_scale_shift", "groupnorm_relu_maxpool",
           "groupnorm_relu_maxpool_reference"]
