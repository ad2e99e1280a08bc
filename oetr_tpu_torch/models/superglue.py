"""SuperGlue graph matching network (port of
``oetr_tpu/models/superglue.py``).

A keypoint MLP over (x, y, score) added to the descriptors, ``gnn_layers``
rounds of self then cross multi-head attention with message-MLP residuals,
a shared final projection, partial optimal transport (log-domain Sinkhorn
with dustbins, ``ops/sinkhorn.py``; K4 with ``cuda_sinkhorn``) and
mutual-argmax matches above a threshold; each of the three runs in a
``torch.profiler.record_function`` range. Padded keypoints carry no
attention weight and no transport mass. Submodule names are the flax
names; the LayerNorms keep flax's default eps of 1e-6, and every Dense has
a bias.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.attention import full_attention
from ..ops.sinkhorn import extract_matches, log_optimal_transport
from .layers import Dense, LayerNorm, materialize

LN_EPS = 1e-6   # flax nn.LayerNorm's default, which SuperGlue keeps


def normalize_keypoints_for_encoder(kpts: torch.Tensor,
                                    image_hw: tuple[int, int]):
    """Center keypoints on the image midpoint and scale by 0.7 x the
    longer side."""
    h, w = image_hw
    center = torch.tensor([w / 2.0, h / 2.0], dtype=kpts.dtype,
                          device=kpts.device)
    return (kpts - center) / (0.7 * max(h, w))


class KeypointEncoder(nn.Module):
    """MLP over (x, y, score) -> an ``out_dim`` embedding."""

    def __init__(self, layers, out_dim: int, dtype=torch.float32):
        super().__init__()
        self.n = len(layers)
        cin = 3
        for i, c in enumerate(layers):
            self.add_module(f"fc{i}", Dense(cin, c, True, dtype))
            self.add_module(f"ln{i}", LayerNorm(c, dtype, LN_EPS))
            cin = c
        self.out = Dense(cin, out_dim, True, dtype)
        self.dtype = dtype

    def forward(self, kpts_norm, scores):
        x = torch.cat([kpts_norm, scores[..., None]], dim=-1).to(self.dtype)
        for i in range(self.n):
            x = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        return self.out(x)


class AttentionalPropagation(nn.Module):
    """One message-passing round: multi-head attention, then a residual
    MLP over [x, message]."""

    def __init__(self, d_model: int, nhead: int = 4, dtype=torch.float32):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        for name in ("q", "k", "v", "merge"):
            self.add_module(name, Dense(d_model, d_model, True, dtype))
        self.mlp1 = Dense(2 * d_model, 2 * d_model, True, dtype)
        self.mlp_ln = LayerNorm(2 * d_model, dtype, LN_EPS)
        self.mlp2 = Dense(2 * d_model, d_model, True, dtype)

    def forward(self, x, source, x_mask, source_mask):
        b, m, _ = x.shape
        hd = self.d_model // self.nhead
        q = self.q(x).reshape(b, m, self.nhead, hd)
        k = self.k(source).reshape(b, -1, self.nhead, hd)
        v = self.v(source).reshape(b, -1, self.nhead, hd)
        msg = full_attention(q, k, v, x_mask, source_mask)
        msg = self.merge(msg.reshape(b, m, self.d_model))
        y = self.mlp1(torch.cat([x, msg], dim=-1))
        y = self.mlp2(F.relu(self.mlp_ln(y)))
        return x + y


class SuperGlue(nn.Module):
    """Match two keypoint sets with descriptors. Defaults are the
    reference's outdoor configuration: 30 Sinkhorn iterations, threshold
    0.2. ``cuda_sinkhorn`` runs the iterations as the K4 kernel (the port
    of ``pallas_sinkhorn``)."""

    def __init__(self, descriptor_dim: int = 256,
                 keypoint_encoder_layers=(32, 64, 128, 256),
                 gnn_layers: int = 9, nhead: int = 4,
                 sinkhorn_iterations: int = 30, cuda_sinkhorn: bool = False,
                 match_threshold: float = 0.2, dtype=torch.float32):
        super().__init__()
        d = descriptor_dim
        self.descriptor_dim = d
        self.gnn_layers = gnn_layers
        self.sinkhorn_iterations = sinkhorn_iterations
        self.cuda_sinkhorn = cuda_sinkhorn
        self.match_threshold = match_threshold
        self.dtype = dtype
        self.kenc = KeypointEncoder(keypoint_encoder_layers, d, dtype)
        for i in range(gnn_layers):
            self.add_module(f"self_{i}", AttentionalPropagation(d, nhead, dtype))
            self.add_module(f"cross_{i}",
                            AttentionalPropagation(d, nhead, dtype))
        self.final_proj = Dense(d, d, True, dtype)   # shared by both sets
        self.bin_score = nn.Parameter(torch.empty(()))

    def forward(self, data: dict) -> dict:
        """data: keypoints0/1 [B, K, 2], scores0/1 [B, K], descriptors0/1
        [B, K, D], valid0/1 [B, K] bool, image_hw0/1 (H, W) tuples.

        Returns matches0/1, matching_scores0/1 and log_assignment
        [B, K0+1, K1+1] (float32).
        """
        with record_function("superglue_gnn"):
            scores = self._scores(data)
        m0, m1 = data.get("valid0"), data.get("valid1")
        with record_function("sinkhorn"):
            log_a = log_optimal_transport(scores, self.bin_score,
                                          self.sinkhorn_iterations, m0, m1,
                                          use_cuda=self.cuda_sinkhorn)
        with record_function("match_extraction"):
            matches0, matches1, ms0, ms1 = extract_matches(
                log_a, self.match_threshold, m0, m1)
        return {"matches0": matches0, "matches1": matches1,
                "matching_scores0": ms0, "matching_scores1": ms1,
                "log_assignment": log_a}

    def _scores(self, data: dict) -> torch.Tensor:
        """Keypoint encoder, GNN and final projection -> the [B, K0, K1]
        float32 score matrix."""
        d = self.descriptor_dim
        kn0 = normalize_keypoints_for_encoder(data["keypoints0"],
                                              data["image_hw0"])
        kn1 = normalize_keypoints_for_encoder(data["keypoints1"],
                                              data["image_hw1"])
        desc0 = (data["descriptors0"].to(self.dtype)
                 + self.kenc(kn0, data["scores0"]))
        desc1 = (data["descriptors1"].to(self.dtype)
                 + self.kenc(kn1, data["scores1"]))
        m0, m1 = data.get("valid0"), data.get("valid1")

        for i in range(self.gnn_layers):
            self_layer = getattr(self, f"self_{i}")
            cross_layer = getattr(self, f"cross_{i}")
            desc0 = self_layer(desc0, desc0, m0, m0)
            desc1 = self_layer(desc1, desc1, m1, m1)
            desc0, desc1 = (cross_layer(desc0, desc1, m0, m1),
                            cross_layer(desc1, desc0, m1, m0))

        mdesc0 = self.final_proj(desc0)
        mdesc1 = self.final_proj(desc1)
        # The product rounds to the model dtype before the f32 scaling, as
        # the JAX einsum does.
        scores = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1).float()
        return scores / (d ** 0.25)


def build_superglue(device="cuda", generator: torch.Generator | None = None,
                    **kwargs) -> SuperGlue:
    """``SuperGlue(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None) and
    ``bin_score`` 1, flax's initial value."""
    with torch.device("meta"):
        model = SuperGlue(**kwargs)
    model = materialize(model, device, generator)
    if model.bin_score.device.type != "meta":
        with torch.no_grad():
            model.bin_score.fill_(1.0)
    return model
