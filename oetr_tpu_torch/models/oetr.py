"""OETR overlap estimator (port of ``oetr_tpu/models/oetr.py``).

ResNet backbone -> 1x1 projection -> PatchMerging neck -> 1x1 projection
-> sine positional encoding -> QueryTransformer -> heatmap soft-argmax
center + tlbr size head -> overlap boxes. Images are NHWC [B, H, W, 3] in
[0, 1]; tokens are flattened row-major, as the JAX package does.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import OETRConfig
from ..geometry.boxes import (box_tlbr_to_xyxy, boxes_from_prob_map,
                              mesh_grid_centers)
from .layers import Conv, Dense, GroupNorm, PixelLayerNorm, materialize
from .resnet import ResNetEncoder, backbone_channels
from .transformer import QueryTransformer

NEG_INF = -1e9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sine_position_encoding(d_model: int, max_shape: tuple[int, int],
                           legacy: bool = True, device=None) -> torch.Tensor:
    """2-D sine positional encoding table [H, W, C] (float32, contiguous:
    a token grid of the table's whole size reaches K2 as it is).

    ``legacy=True`` keeps the reference's div_term expression, whose
    floor-division collapses the frequency spectrum:
    exp(arange(0, d/2, 2) * floor(-log(10000) / d_model / 2)).
    """
    h, w = max_shape
    ones = torch.ones(h, w, dtype=torch.float32, device=device)
    y_pos = torch.cumsum(ones, dim=0)[None]
    x_pos = torch.cumsum(ones, dim=1)[None]
    freq_idx = torch.arange(0, d_model // 2, 2, dtype=torch.float32,
                            device=device)
    if legacy:
        scale = math.floor(-math.log(10000.0) / d_model / 2.0)
    else:
        scale = -math.log(10000.0) / (d_model // 2)
    div_term = torch.exp(freq_idx * scale)[:, None, None]
    pe = torch.zeros(d_model, h, w, dtype=torch.float32, device=device)
    pe[0::4] = torch.sin(x_pos * div_term)
    pe[1::4] = torch.cos(x_pos * div_term)
    pe[2::4] = torch.sin(y_pos * div_term)
    pe[3::4] = torch.cos(y_pos * div_term)
    return pe.permute(1, 2, 0).contiguous()


def detr_position_embedding(mask: torch.Tensor, d_model: int,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float | None = None) -> torch.Tensor:
    """DETR's mask-aware sine embedding [B, H, W, d_model] (float32).

    Positions are cumsums over the validity ``mask`` [B, H, W] (True = a
    valid pixel), so padding does not stretch the coordinate frame;
    ``normalize`` maps each image's extent to [0, ``scale``] (2*pi by
    default). The channels are the y features, then the x features, each
    sin and cos interleaved.
    """
    if scale is None:
        scale = 2.0 * math.pi
    m = mask.float()
    y_embed = torch.cumsum(m, dim=1)
    x_embed = torch.cumsum(m, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    num_pos_feats = d_model // 2
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def sines(embed):
        pos = embed[..., None] / dim_t
        return torch.stack([torch.sin(pos[..., 0::2]),
                            torch.cos(pos[..., 1::2])],
                           dim=-1).reshape(*pos.shape[:-1], -1)

    return torch.cat([sines(y_embed), sines(x_embed)], dim=-1)


class PatchMerging(nn.Module):
    """LayerNorm over channels, then parallel stride-2 convs with kernel
    sizes ``patch_sizes`` (padding (ps-2)//2), channel-concatenated."""

    def __init__(self, dim: int, patch_sizes=(4, 8, 16), dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = PixelLayerNorm(dim, dtype)
        n = len(patch_sizes)
        self.n = n
        for i, ps in enumerate(patch_sizes):
            out_dim = 2 * dim // (2 ** i if i == n - 1 else 2 ** (i + 1))
            self.add_module(f"reduction_{i}",
                            Conv(dim, out_dim, ps, 2, (ps - 2) // 2,
                                 dtype=dtype))

    def forward(self, x):
        x = self.LayerNorm_0(x)
        return torch.cat([getattr(self, f"reduction_{i}")(x)
                          for i in range(self.n)], dim=1)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: a stride-``patch_size`` conv (XLA's
    "SAME" padding, flax's default), then optionally a LayerNorm over the
    channels. [B, C, H, W] -> [B, embed_dim, H/ps, W/ps] (ceil)."""

    def __init__(self, in_chans: int = 3, patch_size: int = 4,
                 embed_dim: int = 96, use_norm: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.proj = Conv(in_chans, embed_dim, patch_size, patch_size, "SAME",
                         dtype=dtype)
        self.use_norm = use_norm
        if use_norm:
            self.LayerNorm_0 = PixelLayerNorm(embed_dim, dtype)

    def forward(self, x):
        x = self.proj(x)
        return self.LayerNorm_0(x) if self.use_norm else x


class OETR(nn.Module):
    """Overlap-box predictor over an image pair.

    forward(image1, image2, mask1=None, mask2=None, with_cycle=False,
    generator=None): images [B, H, W, 3]; masks [B, hf, wf] bool at feature
    resolution (True = valid). Returns a dict of pred_bbox1/2 [B, 4],
    center1/2 [B, 2], tlbr1/2 [B, 4], prob_map1/2 [B, N] (float32) and
    mem1/2 [B, N, d] (float32); with ``with_cycle`` also cycle_center1/2
    [B, 2], the centres re-estimated with the other image's query. In
    training mode the decoder's dropout draws its masks from ``generator``
    (a generator on the images' device).
    """

    def __init__(self, cfg: OETRConfig):
        super().__init__()
        self.cfg = cfg
        dtype = DTYPES[cfg.dtype]
        self.dtype = dtype
        d = cfg.neck.d_model
        bb = cfg.backbone
        self.backbone = ResNetEncoder(bb.depth, bb.stop_layer, bb.norm_input,
                                      bb.fused_stem, dtype, bb.norm,
                                      bb.stem_s2d)
        self.input_proj = Conv(backbone_channels(bb.depth, bb.stop_layer), d,
                               1, dtype=dtype)
        self.patchmerging = PatchMerging(d, cfg.neck.patch_sizes, dtype)
        self.input_proj2 = Conv(2 * d, d, 1, dtype=dtype)
        self.query_embed1 = nn.Parameter(torch.empty(1, d))
        self.query_embed2 = nn.Parameter(torch.empty(1, d))
        self.transformer = QueryTransformer(
            d, cfg.neck.nhead, cfg.neck.num_layers,
            cfg.neck.num_decoder_layers, cfg.neck.attention, dtype)
        self.hm_conv1 = Conv(d, d, 3, 1, 1, dtype=dtype)
        self.hm_gn = GroupNorm(d, dtype)
        self.hm_conv2 = Conv(d, 1, 1, dtype=dtype)
        self.tlbr_fc1 = Dense(d, d, False, dtype)
        self.tlbr_fc2 = Dense(d, 4, True, dtype)

    def extract(self, img):
        f = self.input_proj(self.backbone(img))
        return self.input_proj2(self.patchmerging(f))

    def center_estimation(self, hs, memory, hf, wf, img_h, img_w, mask):
        """Soft-argmax box center over the token grid."""
        b, _, d = memory.shape
        att = torch.einsum("blc,bnc->bln", memory, hs)         # [B, N, 1]
        hm = (memory * att).reshape(b, hf, wf, d).permute(0, 3, 1, 2)
        hm = self.hm_conv2(F.relu(self.hm_gn(self.hm_conv1(hm))))
        hm = hm.reshape(b, hf * wf, 1)
        if mask is not None:
            hm = torch.where(mask[..., None], hm,
                             torch.tensor(NEG_INF, dtype=hm.dtype,
                                          device=hm.device))
        prob = torch.softmax(hm.float(), dim=1)
        grid = mesh_grid_centers(hf, wf, img_h / hf, img_w / wf,
                                 device=prob.device)[None]
        center = torch.sum(prob * grid, dim=1)
        return center, prob[..., 0]

    def forward(self, image1, image2, mask1=None, mask2=None,
                with_cycle: bool = False,
                generator: torch.Generator | None = None):
        cfg = self.cfg
        d = cfg.neck.d_model
        h1, w1 = image1.shape[1:3]
        h2, w2 = image2.shape[1:3]
        if image1.shape == image2.shape:
            # One doubled batch through the backbone and neck.
            feat1, feat2 = self.extract(torch.cat([image1, image2])).chunk(2)
        else:
            feat1, feat2 = self.extract(image1), self.extract(image2)
        b, _, hf1, wf1 = feat1.shape
        hf2, wf2 = feat2.shape[2:]

        pe = sine_position_encoding(d, cfg.neck.max_shape,
                                    cfg.neck.legacy_pos_enc,
                                    device=feat1.device).to(self.dtype)
        p1 = pe[:hf1, :wf1].reshape(1, hf1 * wf1, d)
        p2 = pe[:hf2, :wf2].reshape(1, hf2 * wf2, d)
        t1 = feat1.permute(0, 2, 3, 1).reshape(b, hf1 * wf1, d)
        t2 = feat2.permute(0, 2, 3, 1).reshape(b, hf2 * wf2, d)
        m1 = mask1.reshape(b, hf1 * wf1) if mask1 is not None else None
        m2 = mask2.reshape(b, hf2 * wf2) if mask2 is not None else None

        hs1, hs2, mem1, mem2 = self.transformer(
            t1, t2, self.query_embed1, self.query_embed2, p1, p2, m1, m2,
            generator)

        center1, prob1 = self.center_estimation(hs1, mem1, hf1, wf1, h1, w1, m1)
        center2, prob2 = self.center_estimation(hs2, mem2, hf2, wf2, h2, w2, m2)

        def tlbr(hs):
            y = self.tlbr_fc2(F.relu(self.tlbr_fc1(hs)))
            return torch.sigmoid(y.float())[:, 0]

        tlbr1, tlbr2 = tlbr(hs1), tlbr(hs2)
        out = {
            "pred_bbox1": box_tlbr_to_xyxy(center1, tlbr1, h1, w1),
            "pred_bbox2": box_tlbr_to_xyxy(center2, tlbr2, h2, w2),
            "center1": center1, "center2": center2,
            "tlbr1": tlbr1, "tlbr2": tlbr2,
            "prob_map1": prob1, "prob_map2": prob2,
            "mem1": mem1.float(), "mem2": mem2.float(),
        }
        if with_cycle:
            # Cycle consistency: the centres with the queries swapped.
            out["cycle_center1"], _ = self.center_estimation(
                hs2, mem1, hf1, wf1, h1, w1, m1)
            out["cycle_center2"], _ = self.center_estimation(
                hs1, mem2, hf2, wf2, h2, w2, m2)
        return out

    def predict_boxes(self, image1, image2, mask1=None, mask2=None):
        """(pred_bbox1, pred_bbox2), clamped xyxy, from a forward in eval
        mode (no dropout) whatever the model's mode; the mode is restored."""
        training = self.training
        self.eval()
        try:
            out = self(image1, image2, mask1, mask2)
        finally:
            self.train(training)
        return out["pred_bbox1"], out["pred_bbox2"]


def decode_boxes(out: dict, image_hw1: tuple[int, int],
                 image_hw2: tuple[int, int], source: str = "tlbr",
                 q: float = 0.1, pad: float = 0.2):
    """Overlap boxes from a forward-output dict.

    ``source='tlbr'``: the reference's decode, ``pred_bbox1/2`` as they are.
    ``source='heatmap'``: per-axis mass quantiles of the center heatmap
    (``boxes_from_prob_map``), widened by ``pad`` of the box size per side
    and clamped to the image.
    """
    if source == "tlbr":
        return out["pred_bbox1"], out["pred_bbox2"]
    if source != "heatmap":
        raise ValueError(f"unknown box source {source!r}")

    def one(prob, hw):
        h, w = hw
        n = prob.shape[-1]
        hf = int(round((n * h / w) ** 0.5))
        wf = n // hf
        box = boxes_from_prob_map(prob, hf, wf, (h, w), q)
        bw = box[:, 2] - box[:, 0]
        bh = box[:, 3] - box[:, 1]
        return torch.stack([
            torch.clamp(box[:, 0] - pad * bw, 0.0, w),
            torch.clamp(box[:, 1] - pad * bh, 0.0, h),
            torch.clamp(box[:, 2] + pad * bw, 0.0, w),
            torch.clamp(box[:, 3] + pad * bh, 0.0, h),
        ], dim=-1)

    return one(out["prob_map1"], image_hw1), one(out["prob_map2"], image_hw2)


def build_oetr(cfg: OETRConfig | None = None, device="cuda",
               generator: torch.Generator | None = None) -> OETR:
    """Build OETR on ``device`` in eval mode (a trainer switches it to
    ``train()``).

    Parameters are drawn from ``generator`` (a CPU ``torch.Generator``;
    seed 0 when None), so a seed gives the same weights on every device.
    ``device="meta"`` returns the model with shapes only, no storage.
    """
    cfg = cfg or OETRConfig()
    with torch.device("meta"):
        model = OETR(cfg)
    return materialize(model, device, generator)
