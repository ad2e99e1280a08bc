"""COTR functional correspondence transformer (port of
``oetr_tpu/models/cotr.py``).

The two images side by side make one composite; a GroupNorm ResNet cut at
layer3 and a 1x1 projection give its joint feature map with a 2-D sine
encoding (``legacy=False``). Query points, normalised coordinates in the
composite, take the same encoding (sampled bilinearly) and a DETR-style
decoder regresses the matching composite-frame locations. ``cotr_match``
queries the predictions back and keeps the cycle-consistent ones that
land in the right half. Attention is the plain softmax (``full_attention``,
as JAX's model calls XLA's op); LayerNorms keep flax's eps of 1e-6.
Images are NHWC [B, H, W, 3] in [0, 1].
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import full_attention
from ..ops.nms import _bilinear
from .layers import Conv, Dense, LayerNorm, materialize
from .oetr import sine_position_encoding
from .resnet import ResNetEncoder, backbone_channels

LN_EPS = 1e-6   # flax nn.LayerNorm's default


class _TransformerLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dtype):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        for name in ("q", "k", "v", "merge"):
            self.add_module(name, Dense(d_model, d_model, True, dtype))
        self.LayerNorm_0 = LayerNorm(d_model, dtype, LN_EPS)
        self.Dense_0 = Dense(d_model, 4 * d_model, True, dtype)
        self.Dense_1 = Dense(4 * d_model, d_model, True, dtype)
        self.LayerNorm_1 = LayerNorm(d_model, dtype, LN_EPS)

    def forward(self, x, source, x_pos=None, s_pos=None):
        b, n, _ = x.shape
        hd = self.d_model // self.nhead
        q_in = x if x_pos is None else x + x_pos
        k_in = source if s_pos is None else source + s_pos
        q = self.q(q_in).reshape(b, n, self.nhead, hd)
        k = self.k(k_in).reshape(b, -1, self.nhead, hd)
        v = self.v(source).reshape(b, -1, self.nhead, hd)
        msg = self.merge(full_attention(q, k, v).reshape(b, n, self.d_model))
        x = self.LayerNorm_0(x + msg)
        y = self.Dense_1(F.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + y)


class COTR(nn.Module):
    """composite [B, H, 2W, 3], queries [B, Q, 2] (normalised composite
    coordinates), valid [B, Q] -> predicted normalised coordinates
    [B, Q, 2]."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 enc_layers: int = 3, dec_layers: int = 3,
                 backbone_depth: int = 50, dtype=torch.float32):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.enc_layers, self.dec_layers = enc_layers, dec_layers
        self.backbone = ResNetEncoder(depth=backbone_depth,
                                      stop_layer="layer3", dtype=dtype)
        self.input_proj = Conv(backbone_channels(backbone_depth, "layer3"),
                               d_model, 1, dtype=dtype)
        for i in range(enc_layers):
            self.add_module(f"enc_{i}", _TransformerLayer(d_model, nhead,
                                                          dtype))
        for i in range(dec_layers):
            self.add_module(f"dec_self_{i}", _TransformerLayer(d_model, nhead,
                                                               dtype))
            self.add_module(f"dec_cross_{i}", _TransformerLayer(d_model,
                                                                nhead, dtype))
        self.Dense_0 = Dense(d_model, d_model, True, dtype)
        self.coord_head = Dense(d_model, 2, True, dtype)

    def forward(self, composite, queries, valid=None):
        feats = self.input_proj(self.backbone(composite))
        b, _, hf, wf = feats.shape
        pe = sine_position_encoding(self.d_model, (hf, wf), legacy=False,
                                    device=feats.device)
        tokens = feats.permute(0, 2, 3, 1).reshape(b, hf * wf, self.d_model)
        pos = pe.to(self.dtype).reshape(1, hf * wf, self.d_model).expand(
            b, -1, -1)
        for i in range(self.enc_layers):
            tokens = getattr(self, f"enc_{i}")(tokens, tokens, pos, pos)

        scale = torch.tensor([wf - 1.0, hf - 1.0], device=queries.device)
        q_pe = _bilinear(pe.expand(b, hf, wf, self.d_model),
                         queries.float() * scale).to(self.dtype)
        tgt = torch.zeros_like(q_pe)
        for i in range(self.dec_layers):
            tgt = getattr(self, f"dec_self_{i}")(tgt, tgt, q_pe, q_pe)
            tgt = getattr(self, f"dec_cross_{i}")(tgt, tokens, q_pe, pos)

        out = self.coord_head(F.relu(self.Dense_0(tgt)))
        pred = torch.sigmoid(out.float())
        if valid is not None:
            pred = pred * valid[..., None]
        return pred


def make_composite(image0: torch.Tensor, image1: torch.Tensor):
    """[B, H, W, 3] x2 -> the side-by-side [B, H, 2W, 3] composite."""
    return torch.cat([image0, image1], dim=2)


@torch.no_grad()
def cotr_match(model: COTR, image0: torch.Tensor, image1: torch.Tensor,
               queries_xy: torch.Tensor, cycle_threshold: float = 0.02
               ) -> dict:
    """Match query points of image0 into image1 with cycle filtering.

    image0/1 [B, H, W, 3]; queries_xy [B, Q, 2] normalised coordinates in
    image0's own frame. Returns mkpts0/mkpts1 [B, Q, 2] (normalised, each
    in its image's frame), valid [B, Q] (cycle-consistent and landed in the
    right half) and cycle_error [B, Q].
    """
    comp = make_composite(image0, image1)
    # image0 holds x in [0, 0.5) of the composite.
    q_comp = torch.stack([queries_xy[..., 0] * 0.5, queries_xy[..., 1]], -1)
    fwd = model(comp, q_comp)
    in_right = fwd[..., 0] > 0.5
    back = model(comp, fwd)
    err = torch.linalg.vector_norm(back - q_comp, dim=-1)
    mk1 = torch.stack([(fwd[..., 0] - 0.5) * 2.0, fwd[..., 1]], -1)
    return {"mkpts0": queries_xy, "mkpts1": mk1,
            "valid": in_right & (err < cycle_threshold),
            "cycle_error": err}


def build_cotr(device="cuda", generator: torch.Generator | None = None,
               **kwargs) -> COTR:
    """``COTR(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = COTR(**kwargs)
    return materialize(model, device, generator)
