"""DISK keypoint detector and descriptor (port of ``oetr_tpu/models/disk.py``).

A 4-level U-Net (down 32, 64, 64, 64 with 2x2 average pools, up with
bilinear upsampling to the skip's size and concatenation; GroupNorm of
min(8, c) groups at eps 1e-6) giving a 128-d descriptor map and a
1-channel heatmap at full resolution; keypoints are NMS and a fixed-k
top-k. Images are NHWC [B, H, W, C]; ``in_channels`` is 1 as on the
pipeline's path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nms import sample_descriptors, simple_nms, topk_keypoints
from .layers import Conv, GroupNorm, materialize
from .r2d2 import GN_EPS


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, 1, 1, dtype=dtype)
        self.GroupNorm_0 = GroupNorm(features, dtype, min(8, features),
                                     GN_EPS)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x)))


class DiskUNet(nn.Module):
    """NCHW in and out: [B, in_channels, H, W] -> [B, out_channels, H, W]."""

    def __init__(self, in_channels: int = 1,
                 down_dims: tuple[int, ...] = (32, 64, 64, 64),
                 out_channels: int = 129, dtype=torch.float32):
        super().__init__()
        self.down_dims = down_dims
        cin = in_channels
        for i, c in enumerate(down_dims):
            self.add_module(f"down_{i}a", _ConvBlock(cin, c, dtype))
            self.add_module(f"down_{i}b", _ConvBlock(c, c, dtype))
            cin = c
        for i in range(len(down_dims) - 1):
            lvl = len(down_dims) - 2 - i
            self.add_module(f"up_{i}", _ConvBlock(cin + down_dims[lvl],
                                                  down_dims[lvl], dtype))
            cin = down_dims[lvl]
        self.head = Conv(cin, out_channels, 1, dtype=dtype)

    def forward(self, x):
        skips = []
        n = len(self.down_dims)
        for i in range(n):
            x = getattr(self, f"down_{i}b")(getattr(self, f"down_{i}a")(x))
            if i < n - 1:
                skips.append(x)
                x = F.avg_pool2d(x, 2, 2)
        for i, skip in enumerate(reversed(skips)):
            x = F.interpolate(x, size=skip.shape[2:], mode="bilinear",
                              align_corners=False)
            x = getattr(self, f"up_{i}")(torch.cat([x, skip], dim=1))
        return self.head(x)


class DISK(nn.Module):
    """The extractor: image [B, H, W, C] (H, W divisible by 8) -> fixed-k
    keypoints, scores, valid, descriptors and the heatmap."""

    def __init__(self, descriptor_dim: int = 128, window: int = 5,
                 max_keypoints: int = 2048, keypoint_threshold: float = 0.0,
                 in_channels: int = 1, dtype=torch.float32):
        super().__init__()
        self.descriptor_dim = descriptor_dim
        self.window = window
        self.max_keypoints = max_keypoints
        self.keypoint_threshold = keypoint_threshold
        self.dtype = dtype
        self.unet = DiskUNet(in_channels, out_channels=descriptor_dim + 1,
                             dtype=dtype)

    def forward(self, image: torch.Tensor) -> dict:
        out = self.unet(image.to(self.dtype).permute(0, 3, 1, 2))
        out = out.permute(0, 2, 3, 1).float()
        desc_map = out[..., :self.descriptor_dim]
        heat = out[..., -1]
        nmsed = simple_nms(heat, self.window // 2)
        xy, scores, valid = topk_keypoints(nmsed, self.max_keypoints,
                                           self.keypoint_threshold,
                                           nms_tile=self.window // 2 + 1)
        descs = sample_descriptors(desc_map, xy, stride=1)
        return {"keypoints": xy, "scores": scores, "valid": valid,
                "descriptors": descs, "dense_scores": heat}


def build_disk(device="cuda", generator: torch.Generator | None = None,
               **kwargs) -> DISK:
    """``DISK(**kwargs)`` on ``device`` in eval mode, with weights drawn
    from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = DISK(**kwargs)
    return materialize(model, device, generator)
