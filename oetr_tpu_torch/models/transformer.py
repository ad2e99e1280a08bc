"""OETR query transformer (port of ``oetr_tpu/models/transformer.py``).

num_layers x (self + cross) pre-norm encoder layers over both images'
token streams [B, N, C], then a query decoder per image with one learned
query. Submodule names are the flax names.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import full_attention, linear_attention
from ..ops.attention_kernels import (flash_attention_cuda, full_attention_cuda,
                                     linear_attention_cuda)
from ..ops.linear_encoder import linear_encoder_attention
from .layers import Conv, Dense, LayerNorm

# Below this many queries or keys the attention kernels are not used, as
# in the JAX package (the decoder's single learned query).
MIN_KERNEL_TOKENS = 8

# Kernel kinds -> (wrapper, the plain op below MIN_KERNEL_TOKENS).
KERNEL_KINDS = {
    "linear:cuda": (linear_attention_cuda, linear_attention),   # K1
    "full:cuda": (full_attention_cuda, full_attention),         # K5
    "full:flash": (flash_attention_cuda, full_attention),       # K6
}


def _attend(kind: str, q, k, v, q_mask, kv_mask):
    """Dispatch the attention primitive on [B, N, H, D] tensors. ``kind``:
      'linear' | 'full' — plain torch ops (ops/attention.py);
      'linear:cuda'     — the bare linear-attention kernel (K1);
      'full:cuda'       — the whole-row softmax kernel (K5; JAX's
                          'full:pallas');
      'full:flash'      — the streaming softmax kernel (K6).
    A kernel kind takes the plain op when q or k has fewer than 8 tokens,
    as JAX does; on CPU tensors each wrapper runs its kernel's plain
    version (ops/attention_kernels.py).
    """
    if kind in KERNEL_KINDS:
        kernel, plain = KERNEL_KINDS[kind]
        if (q.shape[1] >= MIN_KERNEL_TOKENS
                and k.shape[1] >= MIN_KERNEL_TOKENS):
            return kernel(q, k, v, q_mask, kv_mask)
        return plain(q, k, v, q_mask, kv_mask)
    if kind == "linear":
        return linear_attention(q, k, v, q_mask, kv_mask)
    if kind == "full":
        return full_attention(q, k, v, q_mask, kv_mask)
    raise ValueError(f"unknown attention {kind!r}")


class EncoderLayer(nn.Module):
    """Pre-norm encoder layer. Positional encodings are added to q, k and v
    after the pre-norms. With ``attention='linear:cuda'``, positional
    encodings and at least 8 query tokens, the norms, encodings,
    projections and attention run as one kernel (K2) on the same
    parameters; every other case projects in torch and attends through
    ``_attend`` (K1, K5 or K6 for the kernel kinds)."""

    def __init__(self, d_model: int, nhead: int, attention: str, dtype):
        super().__init__()
        self.d_model, self.nhead, self.attention = d_model, nhead, attention
        self.dtype = dtype
        self.pre_norm_q = LayerNorm(d_model, dtype)
        self.pre_norm_kv = LayerNorm(d_model, dtype)
        self.q_proj = Dense(d_model, d_model, False, dtype)
        self.k_proj = Dense(d_model, d_model, False, dtype)
        self.v_proj = Dense(d_model, d_model, False, dtype)
        self.merge = Dense(d_model, d_model, False, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.Dense_0 = Dense(d_model, 2 * d_model, False, dtype)
        self.Dense_1 = Dense(2 * d_model, d_model, False, dtype)

    def forward(self, x, source, x_mask=None, source_mask=None, x_pos=None,
                s_pos=None):
        b, n, _ = x.shape
        head_dim = self.d_model // self.nhead
        if (self.attention == "linear:cuda" and x_pos is not None
                and n >= MIN_KERNEL_TOKENS):
            message = linear_encoder_attention(
                x.to(self.dtype), source.to(self.dtype), x_pos, s_pos,
                self.pre_norm_q.stacked(), self.pre_norm_kv.stacked(),
                self.q_proj.weight, self.k_proj.weight, self.v_proj.weight,
                x_mask, source_mask, nhead=self.nhead)
        else:
            query = self.pre_norm_q(x)
            key = value = self.pre_norm_kv(source)
            if x_pos is not None:
                query = query + x_pos
                key = key + s_pos
                value = value + s_pos
            q = self.q_proj(query).reshape(b, n, self.nhead, head_dim)
            k = self.k_proj(key).reshape(b, -1, self.nhead, head_dim)
            v = self.v_proj(value).reshape(b, -1, self.nhead, head_dim)
            message = _attend(self.attention, q, k, v, x_mask, source_mask)
            message = message.reshape(b, n, self.d_model)
        x = x + self.merge(message)
        y = self.Dense_0(self.norm2(x))
        y = self.Dense_1(F.gelu(y, approximate="tanh"))
        return x + y


class MultiHeadAttention(nn.Module):
    """Biased-projection attention used inside decoder layers."""

    def __init__(self, d_model: int, nhead: int, attention: str, dtype):
        super().__init__()
        self.d_model, self.nhead, self.attention = d_model, nhead, attention
        self.q_proj = Dense(d_model, d_model, True, dtype)
        self.k_proj = Dense(d_model, d_model, True, dtype)
        self.v_proj = Dense(d_model, d_model, True, dtype)
        self.merge = Dense(d_model, d_model, False, dtype)

    def forward(self, q, k, v, q_mask=None, kv_mask=None):
        b, n, _ = q.shape
        hd = self.d_model // self.nhead
        qh = self.q_proj(q).reshape(b, n, self.nhead, hd)
        kh = self.k_proj(k).reshape(b, -1, self.nhead, hd)
        vh = self.v_proj(v).reshape(b, -1, self.nhead, hd)
        out = _attend(self.attention, qh, kh, vh, q_mask, kv_mask)
        return self.merge(out.reshape(b, n, self.d_model))


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; in
    eval mode (or at rate 0) the identity. The masks are drawn from the
    ``torch.Generator`` the caller passes (on the input's device), never
    from torch's global generator, as JAX takes a dropout key per step."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode draws its masks from "
                             "a torch.Generator: pass the step's generator")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DecoderLayer(nn.Module):
    """Query decoder layer: self-attn + cross-attn + ReLU MLP, with dropout
    (rate 0.1) on the two attention residuals, not on the MLP's."""

    def __init__(self, d_model: int, nhead: int, attention: str, dtype):
        super().__init__()
        self.norm1 = LayerNorm(d_model, dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attention, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attention, dtype)
        self.norm3 = LayerNorm(d_model, dtype)
        self.Dense_0 = Dense(d_model, 2 * d_model, False, dtype)
        self.Dense_1 = Dense(2 * d_model, d_model, False, dtype)
        self.dropout = Dropout(0.1)

    def forward(self, tgt, memory, memory_mask=None, tgt_pos=None,
                m_pos=None, generator=None):
        tgt2 = self.norm1(tgt)
        qk = tgt2 if tgt_pos is None else tgt2 + tgt_pos
        tgt = tgt + self.dropout(self.self_attn(qk, qk, tgt2), generator)

        tgt2 = self.norm2(tgt)
        q = tgt2 if tgt_pos is None else tgt2 + tgt_pos
        k = memory if m_pos is None else memory + m_pos
        tgt = tgt + self.dropout(
            self.cross_attn(q, k, memory, kv_mask=memory_mask), generator)

        tgt2 = self.Dense_0(self.norm3(tgt))
        return tgt + self.Dense_1(F.relu(tgt2))


class QueryTransformer(nn.Module):
    """Joint encoder over both images + per-image query decoder (the two
    images share the decoder's weights). Returns (hs0, hs1, memory0,
    memory1): query embeddings [B, 1, C] and encoded tokens [B, N, C].
    ``generator`` draws the decoder's dropout masks in training mode."""

    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 4, num_decoder_layers: int = 2,
                 attention: str = "linear", dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.num_decoder_layers = num_decoder_layers
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"enc_self_{i}",
                            EncoderLayer(d_model, nhead, attention, dtype))
            self.add_module(f"enc_cross_{i}",
                            EncoderLayer(d_model, nhead, attention, dtype))
        for i in range(num_decoder_layers):
            self.add_module(f"dec_{i}",
                            DecoderLayer(d_model, nhead, attention, dtype))

    def forward(self, feat0, feat1, query_embed0, query_embed1, pos0, pos1,
                mask0=None, mask1=None, generator=None):
        b = feat0.shape[0]
        q0 = query_embed0[None].expand(b, *query_embed0.shape).to(self.dtype)
        q1 = query_embed1[None].expand(b, *query_embed1.shape).to(self.dtype)
        for i in range(self.num_layers):
            self_layer = getattr(self, f"enc_self_{i}")
            cross_layer = getattr(self, f"enc_cross_{i}")
            feat0 = self_layer(feat0, feat0, mask0, mask0, pos0, pos0)
            feat1 = self_layer(feat1, feat1, mask1, mask1, pos1, pos1)
            src0, src1 = feat1, feat0
            feat0 = cross_layer(feat0, src0, mask0, mask1, pos0, pos1)
            feat1 = cross_layer(feat1, src1, mask1, mask0, pos1, pos0)

        def run_decoder(tgt_pos, memory, memory_mask, m_pos):
            tgt = torch.zeros_like(tgt_pos)
            for i in range(self.num_decoder_layers):
                tgt = getattr(self, f"dec_{i}")(tgt, memory, memory_mask,
                                                tgt_pos, m_pos, generator)
            return tgt

        hs0 = run_decoder(q0, feat0, mask0, pos0)
        hs1 = run_decoder(q1, feat1, mask1, pos1)
        return hs0, hs1, feat0, feat1


class ChannelAttention(nn.Module):
    """CBAM channel gate over tokens [B, N, C]: mean and max over the
    tokens, each through one shared 2-layer MLP (``fc1``, ``fc2``, no
    biases), summed; the sigmoid taken in float32 and cast back, as JAX
    does."""

    def __init__(self, d_model: int, reduction: int = 16,
                 dtype=torch.float32):
        super().__init__()
        hidden = max(d_model // reduction, 1)
        self.fc1 = Dense(d_model, hidden, False, dtype)
        self.fc2 = Dense(hidden, d_model, False, dtype)

    def forward(self, x):
        avg = self.fc2(F.relu(self.fc1(x.mean(dim=1))))
        mx = self.fc2(F.relu(self.fc1(x.amax(dim=1))))
        gate = torch.sigmoid((avg + mx).float()).to(x.dtype)
        return x * gate[:, None, :]


class SpatialAttention(nn.Module):
    """CBAM spatial gate over an NCHW map: the mean and max over channels,
    a ``kernel_size`` conv (``conv``, no bias) of the two, and its sigmoid
    (float32, cast back) scaling every channel."""

    def __init__(self, kernel_size: int = 7, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(2, 1, kernel_size, 1, kernel_size // 2, bias=False,
                         dtype=dtype)

    def forward(self, x):
        g = self.conv(torch.cat([x.mean(dim=1, keepdim=True),
                                 x.amax(dim=1, keepdim=True)], dim=1))
        return x * torch.sigmoid(g.float()).to(x.dtype)
