"""OETR model modules of the port."""
from .oetr import (OETR, PatchMerging, build_oetr, decode_boxes,
                   sine_position_encoding)
from .resnet import ResNetEncoder, backbone_channels
from .transformer import (DecoderLayer, EncoderLayer, MultiHeadAttention,
                          QueryTransformer)

__all__ = ["OETR", "PatchMerging", "build_oetr", "decode_boxes",
           "sine_position_encoding", "ResNetEncoder", "backbone_channels",
           "DecoderLayer", "EncoderLayer", "MultiHeadAttention",
           "QueryTransformer"]
