"""GroupNorm ResNet encoder, truncatable (port of ``oetr_tpu/models/resnet.py``).

Tensors are NCHW in shape and channels_last in memory, so the NHWC images
the model takes become NCHW with a permute and no copy, and the fused stem
kernel reads NHWC the same way. Submodule names are flax's auto-names
(``Conv_0``, ``GroupNorm_0``, ``Bottleneck_3``, ...), so a parameter's
state_dict key is its flax path joined by dots.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import groupnorm_relu_maxpool
from .layers import Conv, GroupNorm

# depth -> (block type, blocks per stage)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
STAGE_COUNT = {"layer1": 1, "layer2": 2, "layer3": 3, "layer4": 4}
WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride, 1, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, dtype)
        self.Conv_1 = Conv(features, features, 3, 1, 1, bias=False, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(features, dtype)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = Conv(cin, features, 1, stride, 0, bias=False,
                               dtype=dtype)
            self.GroupNorm_2 = GroupNorm(features, dtype)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(residual + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, dtype):
        super().__init__()
        out_ch = features * 4
        self.Conv_0 = Conv(cin, features, 1, bias=False, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, dtype)
        self.Conv_1 = Conv(features, features, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.GroupNorm_1 = GroupNorm(features, dtype)
        self.Conv_2 = Conv(features, out_ch, 1, bias=False, dtype=dtype)
        self.GroupNorm_2 = GroupNorm(out_ch, dtype)
        self.project = stride != 1 or cin != out_ch
        if self.project:
            self.Conv_3 = Conv(cin, out_ch, 1, stride, 0, bias=False,
                               dtype=dtype)
            self.GroupNorm_3 = GroupNorm(out_ch, dtype)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(residual + y)


class FusedGNPool(nn.Module):
    """The stem's GroupNorm -> ReLU -> max-pool as one kernel (K3), with
    GroupNorm's parameters, so checkpoints interchange with the plain stem."""

    is_norm = True

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        y = groupnorm_relu_maxpool(x.permute(0, 2, 3, 1).contiguous(),
                                   self.weight, self.bias, 32, 1e-5)
        return y.permute(0, 3, 1, 2)


class ResNetEncoder(nn.Module):
    """Truncated ResNet. Input [B, H, W, 3] in [0, 1] (NHWC); output
    [B, C, H/s, W/s] (channels_last), s = 16 at layer3, 32 at layer4."""

    def __init__(self, depth: int = 50, stop_layer: str = "layer3",
                 norm_input: bool = True, fused_stem: bool = False,
                 dtype=torch.float32):
        super().__init__()
        kind, stages = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.norm_input = norm_input
        self.dtype = dtype
        self.Conv_0 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.fused_stem = fused_stem
        self.GroupNorm_0 = (FusedGNPool(64) if fused_stem
                            else GroupNorm(64, dtype))
        blocks = []
        cin = 64
        for stage in range(STAGE_COUNT[stop_layer]):
            for i in range(stages[stage]):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(cin, WIDTHS[stage], stride, dtype))
                cin = WIDTHS[stage] * block.expansion
        self.block_names = [f"{block.__name__}_{i}" for i in range(len(blocks))]
        for name, blk in zip(self.block_names, blocks):
            self.add_module(name, blk)

    def forward(self, x):
        if self.norm_input:
            x = (x - 0.45) / 0.225
        x = x.to(self.dtype).permute(0, 3, 1, 2)   # NHWC memory, NCHW shape
        x = self.Conv_0(x)
        if self.fused_stem:
            x = self.GroupNorm_0(x)
        else:
            x = F.relu(self.GroupNorm_0(x))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def backbone_channels(depth: int, stop_layer: str) -> int:
    """Output channel count at ``stop_layer``."""
    mult = 4 if depth > 34 else 1
    return WIDTHS[STAGE_COUNT[stop_layer] - 1] * mult
