"""SuperPoint keypoint detector and descriptor (port of
``oetr_tpu/models/superpoint.py``).

A VGG-style encoder (64, 64 | 64, 64 | 128, 128 | 128, 128 with three 2x2
max-pools, stride 8), a detector head (a 65-way softmax per 8x8 cell in
float32, dustbin dropped, depth-to-space to full resolution) and a
descriptor head (256-d, sampled bilinearly at the keypoints). Images are
NHWC [B, H, W, 1] in [0, 1]; convolutions run NCHW in shape and
channels_last in memory. Submodule names are the flax names.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.nms import (refine_keypoints, remove_borders, sample_descriptors,
                       simple_nms, topk_keypoints)
from .layers import Conv, materialize

_VGG = (("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64),
        ("conv2b", 64, 64), ("conv3a", 64, 128), ("conv3b", 128, 128),
        ("conv4a", 128, 128), ("conv4b", 128, 128))


class SuperPointNet(nn.Module):
    """Grayscale image -> (dense scores, coarse unit-norm descriptors)."""

    def __init__(self, descriptor_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name, cin, cout in _VGG:
            self.add_module(name, Conv(cin, cout, 3, 1, 1, dtype=dtype))
        self.convPa = Conv(128, 256, 3, 1, 1, dtype=dtype)
        self.convPb = Conv(256, 65, 1, dtype=dtype)
        self.convDa = Conv(128, 256, 3, 1, 1, dtype=dtype)
        self.convDb = Conv(256, descriptor_dim, 1, dtype=dtype)

    def forward(self, image: torch.Tensor, with_logits: bool = False):
        """image [B, H, W, 1], H and W divisible by 8. Returns scores
        [B, H, W] (float32) and desc [B, H/8, W/8, D] (float32, unit norm);
        with ``with_logits`` also the raw 65-way cell logits [B, H/8, W/8,
        65] in float32 (the detector loss's input,
        ``training/superpoint.py``).
        """
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        for i, (name, _, _) in enumerate(_VGG):
            x = F.relu(getattr(self, name)(x))
            if i in (1, 3, 5):
                x = F.max_pool2d(x, 2, 2)
        logits = self.convPb(F.relu(self.convPa(x))).permute(0, 2, 3, 1)
        probs = torch.softmax(logits.float(), dim=-1)
        probs = probs[..., :-1]
        b, hc, wc, _ = probs.shape
        scores = probs.reshape(b, hc, wc, 8, 8).permute(0, 1, 3, 2, 4)
        scores = scores.reshape(b, hc * 8, wc * 8)

        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc.permute(0, 2, 3, 1).float()
        # x * rsqrt(|x|² + eps), as the JAX model (bounded gradient near 0).
        desc = desc * torch.rsqrt((desc * desc).sum(-1, keepdim=True) + 1e-8)
        if with_logits:
            return scores, desc, logits.float()
        return scores, desc


class SuperPoint(nn.Module):
    """Image -> fixed-k keypoints, scores, descriptors and validity. The
    network and the selection run in ``torch.profiler.record_function``
    ranges ``superpoint_net`` and ``nms_topk``."""

    def __init__(self, nms_radius: int = 4, keypoint_threshold: float = 0.005,
                 max_keypoints: int = 1024, border: int = 4,
                 descriptor_dim: int = 256, subpixel: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        self.max_keypoints = max_keypoints
        self.border = border
        self.descriptor_dim = descriptor_dim
        self.subpixel = subpixel
        self.net = SuperPointNet(descriptor_dim, dtype)

    def forward(self, image: torch.Tensor) -> dict:
        """image [B, H, W, 1] in [0, 1]. Returns keypoints [B, K, 2] (x, y),
        scores [B, K], valid [B, K], descriptors [B, K, D] and dense_scores
        [B, H, W]."""
        with record_function("superpoint_net"):
            scores, desc_map = self.net(image)
        with record_function("nms_topk"):
            nmsed = remove_borders(simple_nms(scores, self.nms_radius),
                                   self.border)
            xy, kp_scores, valid = topk_keypoints(
                nmsed, self.max_keypoints, self.keypoint_threshold,
                nms_tile=self.nms_radius + 1)
            if self.subpixel:
                xy = refine_keypoints(scores, xy)
            descriptors = sample_descriptors(desc_map, xy, stride=8)
        return {"keypoints": xy, "scores": kp_scores, "valid": valid,
                "descriptors": descriptors, "dense_scores": scores}


def build_superpoint_net(device="cuda",
                         generator: torch.Generator | None = None,
                         **kwargs) -> SuperPointNet:
    """``SuperPointNet(**kwargs)``, the raw network the trainers train, on
    ``device`` in eval mode, with weights drawn from ``generator`` (a CPU
    generator; seed 0 when None)."""
    with torch.device("meta"):
        model = SuperPointNet(**kwargs)
    return materialize(model, device, generator)


def build_superpoint(device="cuda", generator: torch.Generator | None = None,
                     **kwargs) -> SuperPoint:
    """``SuperPoint(**kwargs)`` on ``device`` in eval mode, with weights
    drawn from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = SuperPoint(**kwargs)
    return materialize(model, device, generator)


def grayscale(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB in [0, 1] -> [..., H, W, 1] luma."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=image.dtype,
                     device=image.device)
    return (image * w).sum(dim=-1, keepdim=True)
