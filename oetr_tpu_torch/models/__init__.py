"""Model modules of the port."""
from . import registry
from .aslfeat import ASLFeat, build_aslfeat
from .cotr import COTR, build_cotr, cotr_match, make_composite
from .d2net import D2Net, build_d2net
from .disk import DISK, build_disk
from .fcos import (DynamicConv, FCOSHead, Scale, build_fcos_head,
                   compute_centerness_targets, fcos_losses, fcos_targets,
                   sigmoid_focal_loss, softmax_focal_loss)
from .icp import icp_match
from .loftr import LoFTR, build_loftr
from .matchers import disk_brute_match, nearest_neighbor_match
from .oetr import (OETR, PatchEmbed, PatchMerging, build_oetr, decode_boxes,
                   detr_position_embedding, sine_position_encoding)
from .r2d2 import R2D2, build_r2d2
from .resnet import (FrozenBatchNorm, ResNetEncoder, backbone_channels,
                     space_to_depth_kernel)
from .sift_based import (ContextDesc, ContextDescAugmenter,
                         build_contextdesc, build_contextdesc_augmenter,
                         contextdesc_extract, landmark_extract)
from .superglue import SuperGlue, build_superglue
from .superpoint import (SuperPoint, SuperPointNet, build_superpoint,
                         build_superpoint_net, grayscale)
from .transformer import (ChannelAttention, DecoderLayer, EncoderLayer,
                          MultiHeadAttention, QueryTransformer,
                          SpatialAttention)

__all__ = ["registry", "ASLFeat", "build_aslfeat", "COTR", "build_cotr",
           "cotr_match", "make_composite", "D2Net", "build_d2net", "DISK",
           "build_disk", "DynamicConv", "FCOSHead", "Scale",
           "build_fcos_head", "compute_centerness_targets", "fcos_losses",
           "fcos_targets", "sigmoid_focal_loss", "softmax_focal_loss",
           "icp_match", "LoFTR", "build_loftr",
           "disk_brute_match", "nearest_neighbor_match", "OETR",
           "PatchEmbed", "PatchMerging", "build_oetr", "decode_boxes",
           "detr_position_embedding", "sine_position_encoding", "R2D2",
           "build_r2d2", "FrozenBatchNorm", "ResNetEncoder",
           "backbone_channels", "space_to_depth_kernel", "ContextDesc", "ContextDescAugmenter",
           "build_contextdesc", "build_contextdesc_augmenter",
           "contextdesc_extract", "landmark_extract", "SuperGlue",
           "build_superglue", "SuperPoint", "SuperPointNet",
           "build_superpoint", "build_superpoint_net", "grayscale",
           "ChannelAttention", "DecoderLayer", "EncoderLayer",
           "MultiHeadAttention", "QueryTransformer", "SpatialAttention"]
