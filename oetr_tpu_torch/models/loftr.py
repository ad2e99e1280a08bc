"""LoFTR detector-free dense matcher (port of ``oetr_tpu/models/loftr.py``).

ResNet-FPN (coarse 1/8 at ``d_coarse``, fine 1/2 at ``d_fine``) -> legacy
sine positional encoding -> ``coarse_layers`` x (self, cross)
linear-attention layers -> dual-softmax coarse matching (mutual nearest +
threshold) -> a static top-K of the row maxima -> 5x5 windows of the fine
features -> ``fine_layers`` x (self, cross) on the windows -> a soft-argmax
of the window correlation that refines the image-1 position.

Images are NHWC [B, H, W, 1] in [0, 1]; convolutions run NCHW in shape and
channels_last in memory, as ``models/resnet.py`` does. Submodule names are
the flax names, so a state_dict key is the flax path joined by dots. The
norms keep flax's eps of 1e-6, with ``_gn_groups`` groups. The encoder
layers call the plain ``ops/attention.py`` ops: JAX's LoFTR reaches no
Pallas kernel (its linear attention takes ``den + eps``; K1 takes
``max(den, eps)``). The stages run in ``torch.profiler.record_function``
ranges ``loftr_backbone``, ``loftr_coarse``, ``coarse_matching`` and
``loftr_fine``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.attention import full_attention, linear_attention
from .layers import Conv, Dense, GroupNorm, LayerNorm, materialize
from .oetr import sine_position_encoding

EPS = 1e-6   # flax's GroupNorm and LayerNorm default, which LoFTR keeps


def _gn_groups(features: int) -> int:
    """Largest of (32, 16, 8, 4, 1) dividing ``features``."""
    for g in (32, 16, 8, 4):
        if features % g == 0:
            return g
    return 1


def _gn(channels: int, dtype) -> GroupNorm:
    return GroupNorm(channels, dtype, _gn_groups(channels), EPS)


class _BasicBlock(nn.Module):
    """Two 3x3 conv + GN, with a 1x1 conv + GN residual where the shape
    changes."""

    def __init__(self, cin: int, features: int, stride: int, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride, 1, bias=False,
                           dtype=dtype)
        self.GroupNorm_0 = _gn(features, dtype)
        self.Conv_1 = Conv(features, features, 3, 1, 1, bias=False,
                           dtype=dtype)
        self.GroupNorm_1 = _gn(features, dtype)
        self.project = stride != 1 or cin != features
        if self.project:
            self.Conv_2 = Conv(cin, features, 1, stride, 0, bias=False,
                               dtype=dtype)
            self.GroupNorm_2 = _gn(features, dtype)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(residual + y)


def _upsample2(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``like``'s H, W: half-pixel
    centres with the edge taps renormalised, which at exactly 2x is
    ``jax.image.resize(..., "bilinear")``."""
    return F.interpolate(x, size=like.shape[2:], mode="bilinear",
                         align_corners=False)


class ResNetFPN_8_2(nn.Module):
    """LoFTR's backbone: coarse 1/8 (block_dims[2]) + fine 1/2 (d_fine)
    maps."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: tuple[int, int, int] = (128, 192, 256),
                 d_fine: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        d0, d1, d2 = block_dims
        self.conv1 = Conv(1, initial_dim, 7, 2, 3, bias=False, dtype=dtype)
        self.GroupNorm_0 = _gn(initial_dim, dtype)
        specs = ((initial_dim, d0, 1), (d0, d0, 1), (d0, d1, 2), (d1, d1, 1),
                 (d1, d2, 2), (d2, d2, 1))
        for i, (cin, cout, stride) in enumerate(specs):
            self.add_module(f"_BasicBlock_{i}",
                            _BasicBlock(cin, cout, stride, dtype))
        self.out3 = Conv(d2, d2, 1, dtype=dtype)
        self.lat2 = Conv(d1, d2, 1, dtype=dtype)
        self.smooth2 = Conv(d2, d1, 3, 1, 1, dtype=dtype)
        self.lat1 = Conv(d0, d1, 1, dtype=dtype)
        self.smooth1 = Conv(d1, d_fine, 3, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x [B, H, W, 1] -> (coarse [B, H/8, W/8, d2], fine
        [B, H/2, W/2, d_fine]), NHWC views of channels_last maps.

        The convolutions run with cuDNN's autotuner on (each shape timed
        once, then cached), as XLA autotunes the JAX model's: for these f32
        shapes cuDNN's heuristic picks FFT tiling, which an H100 runs
        several times slower than the autotuner's choice."""
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=True,
                         deterministic=cudnn.deterministic,
                         allow_tf32=cudnn.allow_tf32):
            return self._forward(x)

    def _forward(self, x: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x0 = F.relu(self.GroupNorm_0(self.conv1(x)))            # 1/2
        block = lambda i, t: getattr(self, f"_BasicBlock_{i}")(t)
        x1 = block(1, block(0, x0))                             # 1/2
        x2 = block(3, block(2, x1))                             # 1/4
        x3 = block(5, block(4, x2))                             # 1/8

        c3 = self.out3(x3)
        m2 = self.smooth2(F.relu(_upsample2(c3, x2) + self.lat2(x2)))
        fine = self.smooth1(F.relu(_upsample2(m2, x1) + self.lat1(x1)))
        return c3.permute(0, 2, 3, 1), fine.permute(0, 2, 3, 1)


class LoFTREncoderLayer(nn.Module):
    """LoFTR's transformer layer: an attention message, then a residual
    MLP over [x, message]."""

    def __init__(self, d_model: int, nhead: int = 8,
                 attention: str = "linear", dtype=torch.float32):
        super().__init__()
        if attention not in ("linear", "full"):
            raise ValueError(f"unknown attention {attention!r}")
        self.d_model, self.nhead = d_model, nhead
        self.attend = linear_attention if attention == "linear" \
            else full_attention
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            self.add_module(name, Dense(d_model, d_model, False, dtype))
        self.norm1 = LayerNorm(d_model, dtype, EPS)
        self.Dense_0 = Dense(2 * d_model, 2 * d_model, False, dtype)
        self.Dense_1 = Dense(2 * d_model, d_model, False, dtype)
        self.norm2 = LayerNorm(d_model, dtype, EPS)

    def forward(self, x, source, x_mask=None, source_mask=None):
        b, n, _ = x.shape
        hd = self.d_model // self.nhead
        q = self.q_proj(x).reshape(b, n, self.nhead, hd)
        k = self.k_proj(source).reshape(b, -1, self.nhead, hd)
        v = self.v_proj(source).reshape(b, -1, self.nhead, hd)
        msg = self.attend(q, k, v, x_mask, source_mask)
        msg = self.norm1(self.merge(msg.reshape(b, n, self.d_model)))
        y = F.relu(self.Dense_0(torch.cat([x, msg], dim=-1)))
        return x + self.norm2(self.Dense_1(y))


class LoFTRModule(nn.Module):
    """num_layers x (self, cross) over two token streams."""

    def __init__(self, d_model: int, num_layers: int, nhead: int = 8,
                 attention: str = "linear", dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            for kind in ("self", "cross"):
                self.add_module(f"{kind}_{i}", LoFTREncoderLayer(
                    d_model, nhead, attention, dtype))

    def forward(self, f0, f1, m0=None, m1=None):
        for i in range(self.num_layers):
            s, c = getattr(self, f"self_{i}"), getattr(self, f"cross_{i}")
            f0 = s(f0, f0, m0, m0)
            f1 = s(f1, f1, m1, m1)
            f0, f1 = c(f0, f1, m0, m1), c(f1, f0, m1, m0)
        return f0, f1


def _gather_windows(feat: torch.Tensor, centers_xy: torch.Tensor,
                    window: int) -> torch.Tensor:
    """[B, K, W*W, C] windows of ``feat`` [B, H, W, C] around ``centers_xy``
    [B, K, 2] (x, y), truncated to integers toward zero; out-of-range
    positions clamp to the edge."""
    b, h, w, _ = feat.shape
    r = window // 2
    offs = torch.arange(-r, r + 1, device=feat.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    cen = centers_xy.to(torch.int32)                  # truncates toward zero
    ys = torch.clamp(cen[..., 1:2] + oy.reshape(1, 1, -1), 0, h - 1).long()
    xs = torch.clamp(cen[..., 0:1] + ox.reshape(1, 1, -1), 0, w - 1).long()
    bidx = torch.arange(b, device=feat.device)[:, None, None]
    return feat[bidx, ys, xs]


def _grid_xy(idx: torch.Tensor, wc: int) -> torch.Tensor:
    """Coarse cell index -> its (x, y) cell coordinates, float32."""
    return torch.stack([(idx % wc).float(), (idx // wc).float()], dim=-1)


class LoFTR(nn.Module):
    """End-to-end dense matcher: fixed-K matched keypoint pairs with
    confidences and validity."""

    def __init__(self, d_coarse: int = 256, d_fine: int = 128,
                 coarse_layers: int = 4, fine_layers: int = 1, nhead: int = 8,
                 temperature: float = 0.1, match_threshold: float = 0.2,
                 max_matches: int = 1024, fine_window: int = 5,
                 dtype=torch.float32):
        super().__init__()
        self.d_coarse, self.d_fine = d_coarse, d_fine
        self.temperature = temperature
        self.match_threshold = match_threshold
        self.max_matches = max_matches
        self.fine_window = fine_window
        self.backbone = ResNetFPN_8_2(
            initial_dim=d_coarse // 2,
            block_dims=(d_coarse // 2, 3 * d_coarse // 4, d_coarse),
            d_fine=d_fine, dtype=dtype)
        self.coarse = LoFTRModule(d_coarse, coarse_layers, nhead, "linear",
                                  dtype)
        self.fine_proj = Dense(d_fine, d_fine, True, dtype)
        self.fine = LoFTRModule(d_fine, fine_layers, nhead, "linear", dtype)

    def coarse_match(self, c0, c1, m0=None, m1=None) -> dict:
        """Dual-softmax coarse matching of [B, N, C] tokens: the mutual
        nearest neighbours above the threshold, then the top K rows.

        Each of the [B, N, N] f32 intermediates is freed once used (at the
        dense pipeline's 104² tokens each is 468 MB a pair); ``coarse_conf``
        is returned.
        """
        feat0 = F.normalize(c0.float(), dim=-1, eps=1e-12)
        feat1 = F.normalize(c1.float(), dim=-1, eps=1e-12)
        sim = torch.einsum("bmd,bnd->bmn", feat0, feat1) / self.temperature
        if m0 is not None:
            sim = sim.masked_fill(~(m0[:, :, None] & m1[:, None, :]), -1e9)
        conf = torch.softmax(sim, dim=1)
        if sim.requires_grad:
            # Training: the backward reads both softmaxes as they are.
            conf = conf * torch.softmax(sim, dim=2)
        else:
            conf.mul_(torch.softmax(sim, dim=2))
        del sim

        # Mutual nearest + threshold, from the one ``conf`` tensor. Every
        # mutual entry of row i equals the row's max, so the row's best
        # candidate is that max where the row has one (else 0), and its
        # argmax the first mutual column (else 0), as JAX's max and
        # argmax over where(mutual, conf, 0) give them.
        max_r = conf.amax(dim=2, keepdim=True)
        mutual = conf == max_r
        mutual &= conf == conf.amax(dim=1, keepdim=True)
        mutual &= conf > self.match_threshold
        row_best = torch.where(mutual.any(dim=2), max_r[..., 0], 0.0)
        row_arg = mutual.view(torch.uint8).argmax(dim=2)
        del mutual

        # Static top-K over the row maxima; the stable descending sort puts
        # the lower index first among equal values, as lax.top_k does.
        k = min(self.max_matches, row_best.shape[1])
        topv, topi = torch.sort(row_best, dim=1, descending=True, stable=True)
        topv, topi = topv[:, :k], topi[:, :k]
        j_idx = torch.gather(row_arg, 1, topi)
        return {"conf": topv, "valid": topv > 0.0, "coarse_conf": conf,
                "cells0": topi, "cells1": j_idx}

    def forward(self, image0: torch.Tensor, image1: torch.Tensor,
                mask0: torch.Tensor | None = None,
                mask1: torch.Tensor | None = None) -> dict:
        """image0/1 [B, H, W, 1] grayscale in [0, 1], H and W divisible by
        8; mask0/1 optional [B, H/8, W/8] bool coarse masks.

        Returns mkpts0, mkpts1 [B, K, 2] full-resolution (x, y), conf [B, K],
        valid [B, K], coarse_conf [B, N, N], cells0, cells1 [B, K] and
        mkpts1_coarse [B, K, 2].
        """
        b = image0.shape[0]
        with record_function("loftr_backbone"):
            c0, f0 = self.backbone(image0)
            c1, f1 = self.backbone(image1)
        hc, wc = c0.shape[1:3]
        n = hc * wc
        with record_function("loftr_coarse"):
            pe = sine_position_encoding(self.d_coarse, (hc, wc), legacy=True,
                                        device=c0.device)
            c0 = (c0 + pe[None]).reshape(b, n, self.d_coarse)
            c1 = (c1 + pe[None]).reshape(b, n, self.d_coarse)
            m0 = mask0.reshape(b, n) if mask0 is not None else None
            m1 = mask1.reshape(b, n) if mask1 is not None else None
            c0, c1 = self.coarse(c0, c1, m0, m1)
        with record_function("coarse_matching"):
            out = self.coarse_match(c0, c1, m0, m1)
            mk0 = _grid_xy(out["cells0"], wc) * 8.0 + 4.0    # [B, K, 2]
            mk1 = _grid_xy(out["cells1"], wc) * 8.0 + 4.0

        with record_function("loftr_fine"):
            k = mk0.shape[1]
            ww = self.fine_window ** 2
            w0 = _gather_windows(self.fine_proj(f0), mk0 / 2.0,
                                 self.fine_window)           # [B, K, ww, C]
            w1 = _gather_windows(self.fine_proj(f1), mk1 / 2.0,
                                 self.fine_window)
            w0f, w1f = self.fine(w0.reshape(b * k, ww, self.d_fine),
                                 w1.reshape(b * k, ww, self.d_fine))
            w0f = w0f.reshape(b, k, ww, self.d_fine).float()
            w1f = w1f.reshape(b, k, ww, self.d_fine).float()
            # The window-0 centre against all of window 1, soft-argmax.
            heat = torch.einsum("bkc,bkwc->bkw", w0f[:, :, ww // 2],
                                w1f) / (self.d_fine ** 0.5)
            prob = torch.softmax(heat, dim=-1)
            r = self.fine_window // 2
            offs = torch.arange(-r, r + 1, dtype=torch.float32,
                                device=prob.device)
            oy, ox = torch.meshgrid(offs, offs, indexing="ij")
            grid = torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)
            delta = torch.einsum("bkw,wd->bkd", prob, grid)
            mk1_fine = mk1 + delta * 2.0          # the fine stride is 2 px
        return {"mkpts0": mk0, "mkpts1": mk1_fine, "conf": out["conf"],
                "valid": out["valid"], "coarse_conf": out["coarse_conf"],
                "cells0": out["cells0"], "cells1": out["cells1"],
                "mkpts1_coarse": mk1}


def build_loftr(device="cuda", generator: torch.Generator | None = None,
                dtype=torch.float32, **kwargs) -> LoFTR:
    """``LoFTR(dtype=dtype, **kwargs)`` on ``device`` in eval mode, with
    weights drawn from ``generator`` (a CPU generator; seed 0 when None).
    ``device="meta"`` returns the model with shapes only."""
    with torch.device("meta"):
        model = LoFTR(dtype=dtype, **kwargs)
    return materialize(model, device, generator)
