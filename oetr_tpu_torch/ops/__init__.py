"""Plain torch ops and the CUDA kernels with their wrappers."""
from .attention import elu_feature_map, full_attention, linear_attention
from .small_eigh import eigh, eigh_reference, svd3
from .attention_kernels import (flash_attention_cuda,
                                flash_attention_reference,
                                full_attention_cuda, full_attention_reference,
                                linear_attention_cuda,
                                linear_attention_reference)
from .linear_encoder import (linear_encoder_attention,
                             linear_encoder_attention_op,
                             linear_encoder_attention_reference)
from .norm import (gn_scale_shift, gn_scale_shift_cuda,
                   groupnorm_relu_maxpool, groupnorm_relu_maxpool_reference)
from .sinkhorn import (log_optimal_transport, log_sinkhorn,
                       log_sinkhorn_cuda)

__all__ = ["eigh", "eigh_reference", "svd3", "elu_feature_map", "full_attention", "linear_attention",
           "flash_attention_cuda", "flash_attention_reference",
           "full_attention_cuda", "full_attention_reference",
           "linear_attention_cuda", "linear_attention_reference",
           "linear_encoder_attention", "linear_encoder_attention_op",
           "linear_encoder_attention_reference",
           "gn_scale_shift", "gn_scale_shift_cuda", "groupnorm_relu_maxpool",
           "groupnorm_relu_maxpool_reference", "log_optimal_transport",
           "log_sinkhorn", "log_sinkhorn_cuda"]
