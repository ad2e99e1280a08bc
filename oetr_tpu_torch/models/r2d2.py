"""R2D2 keypoint network (port of ``oetr_tpu/models/r2d2.py``).

A fully convolutional L2-Net-style trunk with dilated convolutions at full
resolution (GroupNorm of min(8, c) groups at flax's eps of 1e-6, ``"SAME"``
padding, a 2x2 projection padded at the end), giving a 128-d unit
descriptor field and per-pixel repeatability and reliability maps;
keypoints are NMS on the repeatability gated by both thresholds. Images
are NHWC [B, H, W, C]; ``in_channels`` is 1 as on the pipeline's path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import sample_descriptors, simple_nms, topk_keypoints
from .d2net import l2_normalize
from .layers import Conv, GroupNorm, materialize

# (features, kernel, dilation): stride 1 everywhere.
TRUNK = ((32, 3, 1), (32, 3, 1), (64, 3, 1), (64, 3, 2), (128, 3, 2),
         (128, 3, 4))
GN_EPS = 1e-6   # flax nn.GroupNorm's default


class R2D2Trunk(nn.Module):
    def __init__(self, in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        cin = in_channels
        for i, (c, k, d) in enumerate(TRUNK):
            self.add_module(f"conv_{i}", Conv(cin, c, k, padding="SAME",
                                              dtype=dtype, dilation=d))
            self.add_module(f"GroupNorm_{i}",
                            GroupNorm(c, dtype, min(8, c), GN_EPS))
            cin = c
        self.proj = Conv(cin, 128, 2, padding="SAME", dtype=dtype)

    def forward(self, x):
        for i in range(len(TRUNK)):
            x = getattr(self, f"conv_{i}")(x)
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
        return self.proj(x)


class R2D2(nn.Module):
    """The extractor: image [B, H, W, C] -> fixed-k keypoints, scores,
    valid, 128-d descriptors, dense scores, reliability, repeatability."""

    def __init__(self, reliability_thr: float = 0.7,
                 repeatability_thr: float = 0.7, max_keypoints: int = 5000,
                 nms_radius: int = 3, in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.reliability_thr = reliability_thr
        self.repeatability_thr = repeatability_thr
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.dtype = dtype
        self.trunk = R2D2Trunk(in_channels, dtype)
        self.repeatability = Conv(128, 1, 3, 1, 1)
        self.reliability = Conv(128, 1, 3, 1, 1)

    def forward(self, image: torch.Tensor) -> dict:
        feats = self.trunk(image.to(self.dtype).permute(0, 3, 1, 2)).float()
        f_nhwc = feats.permute(0, 2, 3, 1)
        desc_map = l2_normalize(f_nhwc)
        sq = (f_nhwc ** 2).sum(dim=-1)
        rep_logits = self.repeatability(feats)[:, 0]
        rel_logits = self.reliability(feats)[:, 0]
        repeatability = torch.sigmoid(rep_logits + 0.01 * sq)
        reliability = torch.sigmoid(rel_logits)
        score = repeatability * (reliability > self.reliability_thr).float()
        nmsed = simple_nms(score, self.nms_radius)
        xy, s, valid = topk_keypoints(nmsed, self.max_keypoints,
                                      self.repeatability_thr,
                                      nms_tile=self.nms_radius + 1)
        descs = sample_descriptors(desc_map, xy, stride=1)
        return {"keypoints": xy, "scores": s, "valid": valid,
                "descriptors": descs, "dense_scores": score,
                "reliability": reliability, "repeatability": repeatability}


def build_r2d2(device="cuda", generator: torch.Generator | None = None,
               **kwargs) -> R2D2:
    """``R2D2(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = R2D2(**kwargs)
    return materialize(model, device, generator)
