"""Model modules of the port."""
from .oetr import (OETR, PatchMerging, build_oetr, decode_boxes,
                   sine_position_encoding)
from .resnet import ResNetEncoder, backbone_channels
from .superglue import SuperGlue, build_superglue
from .superpoint import SuperPoint, SuperPointNet, build_superpoint, grayscale
from .transformer import (DecoderLayer, EncoderLayer, MultiHeadAttention,
                          QueryTransformer)

__all__ = ["OETR", "PatchMerging", "build_oetr", "decode_boxes",
           "sine_position_encoding", "ResNetEncoder", "backbone_channels",
           "SuperGlue", "build_superglue", "SuperPoint", "SuperPointNet",
           "build_superpoint", "grayscale", "DecoderLayer", "EncoderLayer",
           "MultiHeadAttention", "QueryTransformer"]
