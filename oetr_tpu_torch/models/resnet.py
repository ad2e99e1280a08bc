"""ResNet encoder, truncatable (port of ``oetr_tpu/models/resnet.py``).

Tensors are NCHW in shape and channels_last in memory, so the NHWC images
the model takes become NCHW with a permute and no copy, and the fused stem
kernel reads NHWC the same way. The norm is GroupNorm (``'gn'``, the
default), a LayerNorm over the channels of each pixel (``'ln'``) or a
frozen BatchNorm (``'bn'``, for the reference's torchvision checkpoints).
Submodule names are flax's auto-names (``Conv_0``, ``GroupNorm_0``,
``LayerNorm_0``, ``FrozenBatchNorm_0``, ``Bottleneck_3``, ...), so a
parameter's state_dict key is its flax path joined by dots.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.norm import groupnorm_relu_maxpool
from .layers import Conv, GroupNorm, PixelLayerNorm

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


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW: y = (x - mean) / sqrt(var + eps)
    * weight + bias. All four tensors are parameters, as in JAX (whose
    optimizer updates them too); the per-channel multiplier and shift are
    formed in float32, cast to ``dtype`` and applied there, JAX's
    rounding."""

    is_norm = True

    def __init__(self, channels: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.mean = nn.Parameter(torch.empty(channels))
        self.var = nn.Parameter(torch.empty(channels))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        root = torch.sqrt(self.var + self.eps)
        inv = (self.weight / root).to(self.dtype)
        shift = (self.bias - self.mean * self.weight / root).to(self.dtype)
        return x.to(self.dtype) * inv[:, None, None] + shift[:, None, None]


# norm kind -> (flax's auto-name prefix, module over `channels` in `dtype`)
NORMS = {"gn": ("GroupNorm", GroupNorm),
         "ln": ("LayerNorm", PixelLayerNorm),
         "bn": ("FrozenBatchNorm", FrozenBatchNorm)}


def _norm_kind(norm: str):
    if norm not in NORMS:
        raise ValueError(f"unknown norm {norm!r}")
    return NORMS[norm]


class _Block(nn.Module):
    """A residual block's norms under flax's names, ``{prefix}_{i}``,
    registered after their convolutions in flax's order (a seed gives the
    same weights whatever the norm)."""

    def _set_norm(self, norm: str, i: int, channels: int, dtype):
        self.norm_prefix, make = _norm_kind(norm)
        self.add_module(f"{self.norm_prefix}_{i}", make(channels, dtype))

    def norm(self, i: int, x):
        return getattr(self, f"{self.norm_prefix}_{i}")(x)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, dtype,
                 norm: str = "gn"):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride, 1, bias=False, dtype=dtype)
        self._set_norm(norm, 0, features, dtype)
        self.Conv_1 = Conv(features, features, 3, 1, 1, bias=False, dtype=dtype)
        self._set_norm(norm, 1, features, dtype)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = Conv(cin, features, 1, stride, 0, bias=False,
                               dtype=dtype)
            self._set_norm(norm, 2, features, dtype)

    def forward(self, x):
        y = F.relu(self.norm(0, self.Conv_0(x)))
        y = self.norm(1, self.Conv_1(y))
        residual = self.norm(2, self.Conv_2(x)) if self.project else x
        return F.relu(residual + y)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, dtype,
                 norm: str = "gn"):
        super().__init__()
        out_ch = features * 4
        self.Conv_0 = Conv(cin, features, 1, bias=False, dtype=dtype)
        self._set_norm(norm, 0, features, dtype)
        self.Conv_1 = Conv(features, features, 3, stride, 1, bias=False,
                           dtype=dtype)
        self._set_norm(norm, 1, features, dtype)
        self.Conv_2 = Conv(features, out_ch, 1, bias=False, dtype=dtype)
        self._set_norm(norm, 2, out_ch, dtype)
        self.project = stride != 1 or cin != out_ch
        if self.project:
            self.Conv_3 = Conv(cin, out_ch, 1, stride, 0, bias=False,
                               dtype=dtype)
            self._set_norm(norm, 3, out_ch, dtype)

    def forward(self, x):
        y = F.relu(self.norm(0, self.Conv_0(x)))
        y = F.relu(self.norm(1, self.Conv_1(y)))
        y = self.norm(2, self.Conv_2(y))
        residual = self.norm(3, self.Conv_3(x)) if self.project else x
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
    [B, C, H/s, W/s] (channels_last), s = 16 at layer3, 32 at layer4.

    ``stem_s2d``: the stem folds 2x2 pixel blocks into channels ([B, H, W,
    3] -> [B, H/2, W/2, 12], channels in (dy, dx, c) order) and convolves
    with a 4x4/s1 kernel padded (2, 1) on each axis, the exact equivalent
    of the 7x7/s2 stem under ``space_to_depth_kernel`` (H and W even).
    ``fused_stem`` takes K3 for the stem's GroupNorm -> ReLU -> max-pool,
    with norm 'gn' only (JAX's rule; other norms run the plain stem).
    """

    def __init__(self, depth: int = 50, stop_layer: str = "layer3",
                 norm_input: bool = True, fused_stem: bool = False,
                 dtype=torch.float32, norm: str = "gn",
                 stem_s2d: bool = False):
        super().__init__()
        kind, stages = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.norm_input = norm_input
        self.dtype = dtype
        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.Conv_0 = Conv(12, 64, 4, 1, 0, bias=False, dtype=dtype)
        else:
            self.Conv_0 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        prefix, make = _norm_kind(norm)
        self.fused_stem = fused_stem and norm == "gn"
        self.stem_norm = f"{prefix}_0"
        self.add_module(self.stem_norm, FusedGNPool(64) if self.fused_stem
                        else make(64, dtype))
        blocks = []
        cin = 64
        for stage in range(STAGE_COUNT[stop_layer]):
            for i in range(stages[stage]):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(cin, WIDTHS[stage], stride, dtype, norm))
                cin = WIDTHS[stage] * block.expansion
        self.block_names = [f"{block.__name__}_{i}" for i in range(len(blocks))]
        for name, blk in zip(self.block_names, blocks):
            self.add_module(name, blk)

    def forward(self, x):
        if self.norm_input:
            x = (x - 0.45) / 0.225
        x = x.to(self.dtype)
        if self.stem_s2d:
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).transpose(2, 3)
            x = x.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
            x = self.Conv_0(F.pad(x, (2, 1, 2, 1)))
        else:
            x = self.Conv_0(x.permute(0, 3, 1, 2))  # NHWC memory, NCHW shape
        stem_norm = getattr(self, self.stem_norm)
        if self.fused_stem:
            x = stem_norm(x)
        else:
            x = F.relu(stem_norm(x))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def space_to_depth_kernel(k7: torch.Tensor) -> torch.Tensor:
    """Map a [O, C, 7, 7] stride-2 stem kernel (OIHW) to the exactly
    equivalent [O, 4C, 4, 4] kernel of the space-to-depth stem: zero-pad to
    8x8 at the top-left (K8[u, v] = K7[u-1, v-1]), then interleave pixel
    phases, K'[o, (dy, dx, c), p, q] = K8[o, c, 2p+dy, 2q+dx], the (dy,
    dx, c) channel order of the stem's fold."""
    o, c = k7.shape[:2]
    k8 = k7.new_zeros(o, c, 8, 8)
    k8[:, :, 1:, 1:] = k7
    # [O, C, p, dy, q, dx] -> [O, dy, dx, C, p, q]
    k = k8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k.reshape(o, 4 * c, 4, 4)


def backbone_channels(depth: int, stop_layer: str) -> int:
    """Output channel count at ``stop_layer``."""
    mult = 4 if depth > 34 else 1
    return WIDTHS[STAGE_COUNT[stop_layer] - 1] * mult
