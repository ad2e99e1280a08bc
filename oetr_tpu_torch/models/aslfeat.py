"""ASLFeat-style extractor (port of ``oetr_tpu/models/aslfeat.py``).

An L2-Net-like trunk at three levels (1, 1/2, 1/4; the stride-2 blocks
with XLA's ``"SAME"`` padding, the deformable convolutions of the paper as
dilated ones), a peakiness score at each level upsampled to full
resolution and fused with weights 1, 2, 3, and 128-d descriptors from
the 1/4 level. Images are NHWC [B, H, W, 1] grayscale in [0, 1].
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import sample_descriptors, simple_nms, topk_keypoints
from .d2net import l2_normalize, window_sum3
from .layers import Conv, GroupNorm, materialize
from .r2d2 import GN_EPS

# (name, features, stride, dilation), in flax's order (GroupNorm_0..5).
BLOCKS = (("c1a", 32, 1, 1), ("c1b", 32, 1, 1), ("c2a", 64, 2, 1),
          ("c2b", 64, 1, 1), ("c3a", 128, 2, 1), ("c3b", 128, 1, 2))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)`` (jax.nn.softplus; torch's
    softplus returns x itself above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def peakiness_score(f: torch.Tensor) -> torch.Tensor:
    """softplus(f - 3x3 spatial mean) * softplus(f - channel mean), the
    maximum over channels: [B, H, W, C] -> [B, H, W]."""
    spatial_avg = window_sum3(f) / 9.0
    channel_avg = f.mean(dim=-1, keepdim=True)
    return (softplus(f - spatial_avg) * softplus(f - channel_avg)).amax(-1)


class ASLFeat(nn.Module):
    """The extractor: image [B, H, W, 1] (H, W divisible by 4) -> fixed-k
    keypoints, scores, valid, descriptors and the fused dense scores."""

    def __init__(self, max_keypoints: int = 2048, nms_radius: int = 2,
                 keypoint_threshold: float = 0.0, in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.dtype = dtype
        cin = in_channels
        for i, (name, c, stride, dil) in enumerate(BLOCKS):
            self.add_module(name, Conv(cin, c, 3, stride, "SAME", dtype=dtype,
                                       dilation=dil))
            self.add_module(f"GroupNorm_{i}",
                            GroupNorm(c, dtype, min(8, c), GN_EPS))
            cin = c
        self.desc = Conv(cin, 128, 3, 1, 1, dtype=dtype)

    def forward(self, image: torch.Tensor) -> dict:
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        levels = []
        for i, (name, _, _, _) in enumerate(BLOCKS):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, name)(x)))
            if i % 2:
                levels.append(x)
        x1, x2, x3 = levels
        desc_map = l2_normalize(self.desc(x3).permute(0, 2, 3, 1).float())

        h, w = x1.shape[2:]
        scores = []
        for feat in levels:
            sc = peakiness_score(feat.permute(0, 2, 3, 1).float())
            if sc.shape[1:] != (h, w):
                sc = F.interpolate(sc[:, None], size=(h, w), mode="bilinear",
                                   align_corners=False)[:, 0]
            scores.append(sc)
        # Multi-level fusion, weights 1/2/3, summed in flax's order.
        score = (1.0 * scores[0] + 2.0 * scores[1] + 3.0 * scores[2]) / 6.0

        nmsed = simple_nms(score, self.nms_radius)
        xy, s, valid = topk_keypoints(nmsed, self.max_keypoints,
                                      self.keypoint_threshold,
                                      nms_tile=self.nms_radius + 1)
        descs = sample_descriptors(desc_map, xy, stride=4)
        return {"keypoints": xy, "scores": s, "valid": valid,
                "descriptors": descs, "dense_scores": score}


def build_aslfeat(device="cuda", generator: torch.Generator | None = None,
                  **kwargs) -> ASLFeat:
    """``ASLFeat(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = ASLFeat(**kwargs)
    return materialize(model, device, generator)
