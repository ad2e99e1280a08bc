"""Masked linear attention and full attention in plain torch.

Port of ``oetr_tpu/ops/attention.py``. Layout [B, N, H, D] ("NLHD"); masks
are [B, N] bool with True for a real token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1 positive feature map."""
    return F.elu(x) + 1.0


def linear_attention(q, k, v, q_mask=None, kv_mask=None, eps: float = 1e-6):
    """O(N·D²) linear attention with ``den + eps`` and values rescaled by
    1/S; padded K/V positions are zeroed.

    q: [B, L, H, D]; k, v: [B, S, H, D]. Returns [B, L, H, D].
    """
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        K = K * kv_mask[:, :, None, None].to(K.dtype)
        v = v * kv_mask[:, :, None, None].to(v.dtype)

    v_length = v.shape[1]
    v_scaled = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, v_scaled)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def full_attention(q, k, v, q_mask=None, kv_mask=None):
    """Softmax attention with temperature 1/sqrt(D); pairs outside the
    masks get -inf logits, and rows with no visible key give 0.

    q: [B, L, H, D]; k, v: [B, S, H, D]. Returns [B, L, H, D].
    """
    qk = torch.einsum("nlhd,nshd->nlsh", q, k)
    if kv_mask is not None:
        if q_mask is None:
            pair = kv_mask[:, None, :, None]
        else:
            pair = q_mask[:, :, None, None] & kv_mask[:, None, :, None]
        qk = qk.masked_fill(~pair, float("-inf"))
    temp = 1.0 / (q.shape[-1] ** 0.5)
    attn = torch.softmax(temp * qk, dim=2)
    if kv_mask is not None:
        attn = torch.nan_to_num(attn)
    return torch.einsum("nlsh,nshd->nlhd", attn, v)
