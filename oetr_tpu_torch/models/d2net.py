"""D2-Net detect-and-describe network (port of ``oetr_tpu/models/d2net.py``).

VGG16 to conv4_3 (stride 8, 512 channels); the same feature map is the
dense descriptor field and the detector: score = soft local-max (3x3)
times the ratio to the channel maximum, the maximum over channels,
normalised per image, upsampled x8 (bilinear, half-pixel centres) and
NMS'd to fixed-k keypoints. Images are NHWC [B, H, W, C] in [0, 1];
``in_channels`` is 1 as on the pipeline's path, which feeds grayscale
crops (the JAX model infers it from its first input). Submodule names are
the flax names.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import sample_descriptors, simple_nms, topk_keypoints
from .layers import Conv, materialize

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)


class VGGConv4(nn.Module):
    """VGG16 through conv4_3 (stride 8), NCHW in and out."""

    def __init__(self, in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        cin, i = in_channels, 0
        for v in VGG16_CFG:
            if v != "M":
                self.add_module(f"conv_{i}", Conv(cin, v, 3, 1, 1,
                                                  dtype=dtype))
                cin, i = v, i + 1

    def forward(self, x):
        i = 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
        return x


def window_sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over each 3x3 window of [B, H, W, C], zero padded (XLA's
    ``reduce_window(add, "SAME")``)."""
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = p[:, :-2] + p[:, 1:-1] + p[:, 2:]
    return rows[:, :, :-2] + rows[:, :, 1:-1] + rows[:, :, 2:]


def d2net_scores(features: torch.Tensor) -> torch.Tensor:
    """Joint detection score map: features [B, Hc, Wc, C] -> [B, Hc, Wc],
    each image's map summing to 1."""
    f = F.relu(features)
    e = torch.exp(f - f.amax(dim=(1, 2, 3), keepdim=True))
    alpha = e / torch.clamp(window_sum3(e), min=1e-12)
    beta = f / torch.clamp(f.amax(dim=-1, keepdim=True), min=1e-12)
    score = (alpha * beta).amax(dim=-1)
    norm = score.sum(dim=(1, 2), keepdim=True)
    return score / torch.clamp(norm, min=1e-12)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / max(|x|, 1e-12) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class D2Net(nn.Module):
    """The extractor: image [B, H, W, C] (H, W divisible by 8) -> fixed-k
    keypoints, scores, valid, 512-d descriptors and the dense scores."""

    def __init__(self, max_keypoints: int = 2048, nms_radius: int = 2,
                 keypoint_threshold: float = 0.0, in_channels: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.dtype = dtype
        self.vgg = VGGConv4(in_channels, dtype)

    def forward(self, image: torch.Tensor) -> dict:
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        feats = self.vgg(x).permute(0, 2, 3, 1).float()
        desc_map = l2_normalize(feats)
        score_c = d2net_scores(feats)
        b, hc, wc = score_c.shape
        score = F.interpolate(score_c[:, None], size=(hc * 8, wc * 8),
                              mode="bilinear", align_corners=False)[:, 0]
        nmsed = simple_nms(score, self.nms_radius)
        xy, s, valid = topk_keypoints(nmsed, self.max_keypoints,
                                      self.keypoint_threshold,
                                      nms_tile=self.nms_radius + 1)
        descs = sample_descriptors(desc_map, xy, stride=8)
        return {"keypoints": xy, "scores": s, "valid": valid,
                "descriptors": descs, "dense_scores": score}


def build_d2net(device="cuda", generator: torch.Generator | None = None,
                **kwargs) -> D2Net:
    """``D2Net(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = D2Net(**kwargs)
    return materialize(model, device, generator)
