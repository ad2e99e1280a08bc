"""Parameter-holding layers with flax's dtype semantics.

Parameters are float32 (as flax's default ``param_dtype``); each layer
computes in its ``dtype`` the way the matching ``flax.linen`` layer does:
Dense and Conv cast inputs and parameters to ``dtype``; LayerNorm and
GroupNorm take statistics and apply the affine in float32 and return
``dtype``. Parameters are created empty: ``build_oetr`` fills them.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """flax's ``nn.Dense``: weight [out, in] as ``nn.Linear`` holds it (an
    ``nn.Linear``, so that torch's tensor-parallel styles take it)."""

    def __init__(self, cin: int, cout: int, bias: bool, dtype: torch.dtype):
        nn.Module.__init__(self)
        self.in_features, self.out_features = cin, cout
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def same_padding(size: int, k: int, stride: int, dilation: int
                 ) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: (before, after). The output has
    ceil(size / stride) positions; of the padding that needs, ``total // 2``
    goes before and the rest after (so a stride-2 conv on an even size pads
    0 before and 1 after, where a symmetric padding of 1 would shift the
    map by a pixel)."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution on NCHW (channels_last in memory), as flax's
    ``nn.Conv``: ``padding`` an integer (symmetric) or ``"SAME"`` (XLA's,
    flax's default, which pads the end more when the total is odd), with
    ``dilation`` as flax's ``kernel_dilation``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | str = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, dilation: int = 1):
        super().__init__()
        if isinstance(padding, str) and padding != "SAME":
            raise ValueError(f"padding {padding!r}: an integer or 'SAME'")
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.k, self.dilation = k, dilation

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        x = x.to(self.dtype)
        pad = self.padding
        if pad == "SAME":
            top, bottom = same_padding(x.shape[2], self.k, self.stride,
                                       self.dilation)
            left, right = same_padding(x.shape[3], self.k, self.stride,
                                       self.dilation)
            if (top, left) == (bottom, right):
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride,
                        pad, self.dilation)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, eps 1e-5 (OETR's; flax's default, which
    SuperGlue keeps, is 1e-6)."""

    is_norm = True

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.dtype = dtype
        self.eps = eps

    def stacked(self) -> torch.Tensor:
        """(weight, bias) as one [2, C] f32 tensor, the fused kernel's form."""
        return torch.stack([self.weight, self.bias])

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class PixelLayerNorm(LayerNorm):
    """LayerNorm over the channels of each pixel of an NCHW map (flax's
    ``nn.LayerNorm`` on NHWC): on a channels_last tensor the permutes are
    views."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW: 32 groups and eps 1e-5 by default (OETR's);
    LoFTR keeps flax's eps of 1e-6 with its own group counts."""

    is_norm = True

    def __init__(self, channels: int, dtype: torch.dtype,
                 num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.dtype = dtype
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.dtype)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator`` (a CPU generator, so that a
    seed gives the same weights on every device): Dense and Conv weights
    ~ N(0, 1/fan_in) (flax's lecun_normal without truncation), biases (and
    a frozen BatchNorm's means) 0, the other parameters of modules with
    ``is_norm`` (scales, variances) 1, any other parameter ~ N(0, 1)."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, (Dense, Conv)) and name == "weight":
                fan_in = p[0].numel()
                val = torch.randn(p.shape, generator=generator) * fan_in ** -0.5
            elif isinstance(module, (Dense, Conv)) or name in ("bias",
                                                                "mean"):
                val = torch.zeros(p.shape)
            elif getattr(module, "is_norm", False):
                val = torch.ones(p.shape)
            else:
                val = torch.randn(p.shape, generator=generator)
            p.copy_(val)


def materialize(model: nn.Module, device, generator: torch.Generator | None
                ) -> nn.Module:
    """Give a model built on the meta device storage on ``device`` and fill
    it with ``init_params`` (seed 0 when ``generator`` is None), in eval
    mode, with conv weights channels_last. ``device="meta"`` returns the
    model with shapes only."""
    model.eval()
    if torch.device(device).type == "meta":
        return model
    model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_params(model, generator)
    for module in model.modules():
        if isinstance(module, Conv):
            module.weight.data = module.weight.data.contiguous(
                memory_format=torch.channels_last)
    return model
