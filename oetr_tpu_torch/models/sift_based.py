"""SIFT-based extractors (port of ``oetr_tpu/models/sift_based.py``).

  * ``sift_keypoints`` / ``landmark_extract``: SIFT keypoints (and RootSIFT
    descriptors) from cv2, fixed-k padded. Host only: cv2 is imported
    inside them and they raise ImportError where it is missing.
  * ``ContextDesc``: the augmentation network (a regional conv tower
    sampled at the keypoints, a context-normalised geometric tower, a
    residual fusion into 128-d unit descriptors and a matchability head);
    a module that runs on the card given keypoints.
  * ``ContextDescAugmenter``: the lighter MLP over (RootSIFT, normalised
    xy, score).
  * ``contextdesc_extract``: SIFT on the host, then either network on its
    weights' device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .d2net import l2_normalize
from .layers import Conv, Dense, materialize


def sift_keypoints(image_u8: np.ndarray, topk: int = 2048,
                   with_descriptors: bool = False):
    """SIFT keypoints (and RootSIFT descriptors), the ``topk`` strongest,
    padded to ``topk`` slots.

    image_u8 [H, W] uint8 grayscale. Returns xy [k, 2] float32, scores
    [k], valid [k] bool (and desc [k, 128] float32 when asked).
    """
    import cv2

    sift = cv2.SIFT_create()
    if with_descriptors:
        kpts, desc = sift.detectAndCompute(image_u8, None)
    else:
        kpts = sift.detect(image_u8, None)
        desc = None
    kpts = list(kpts or [])
    order = np.argsort([-k.response for k in kpts])[:topk]
    xy = np.zeros((topk, 2), np.float32)
    scores = np.zeros(topk, np.float32)
    valid = np.zeros(topk, bool)
    out_desc = np.zeros((topk, 128), np.float32) if with_descriptors else None
    for i, j in enumerate(order):
        xy[i] = kpts[j].pt
        scores[i] = kpts[j].response
        valid[i] = True
        if desc is not None:
            d = desc[j]
            d = d / max(d.sum(), 1e-12)         # RootSIFT
            out_desc[i] = np.sqrt(d)
    if with_descriptors:
        return xy, scores, valid, out_desc
    return xy, scores, valid


def landmark_extract(image_u8: np.ndarray, topk: int = 2048) -> dict:
    """SIFT keypoints only (numpy): keypoints, scores, valid."""
    xy, scores, valid = sift_keypoints(image_u8, topk)
    return {"keypoints": xy, "scores": scores, "valid": valid}


class ContextDescAugmenter(nn.Module):
    """(RootSIFT [..., 128], xy_norm [..., 2], score [...]) -> 128-d unit
    descriptor: a residual MLP on the raw descriptor."""

    def __init__(self, out_dim: int = 128, hidden: int = 256,
                 desc_dim: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(desc_dim + 3, hidden, True, dtype)
        self.Dense_1 = Dense(hidden, out_dim, True, dtype)

    def forward(self, desc, xy_norm, scores):
        x = torch.cat([desc, xy_norm, scores[..., None]], dim=-1)
        h = self.Dense_1(F.relu(self.Dense_0(x)))
        return l2_normalize((desc.to(self.dtype) + h).float())


def _context_norm(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Whiten each feature across an image's valid keypoints."""
    m = valid[..., None].to(x.dtype)
    cnt = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=-2, keepdim=True) / cnt
    var = (((x - mean) ** 2) * m).sum(dim=-2, keepdim=True) / cnt
    return (x - mean) * torch.rsqrt(var + 1e-5) * m


class ContextDesc(nn.Module):
    """image [B, H, W, 1] in [0, 1], desc [B, K, 128] RootSIFT, xy
    [B, K, 2] pixels, scores [B, K], valid [B, K] -> (descriptors
    [B, K, 128] unit norm, matchability [B, K])."""

    def __init__(self, out_dim: int = 128, regional_dim: int = 64,
                 hidden: int = 128, desc_dim: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, ch in enumerate((16, 32, 64, regional_dim)):
            self.add_module(f"reg_conv{i}", Conv(cin, ch, 3, 2, "SAME",
                                                 dtype=dtype))
            cin = ch
        self.vis_proj = Dense(regional_dim, hidden, True, dtype)
        self.geo_fc0 = Dense(3, hidden, True, dtype)
        self.geo_fc1 = Dense(hidden, hidden, True, dtype)
        self.geo_fc2 = Dense(hidden, hidden, True, dtype)
        self.fuse_fc1 = Dense(desc_dim + 2 * hidden, hidden, True, dtype)
        self.fuse_fc2 = Dense(hidden, out_dim, True, dtype)
        self.matchability = Dense(hidden, 1, True, dtype)

    def forward(self, image, desc, xy, scores, valid):
        b, hgt, wid, _ = image.shape
        x = image.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"reg_conv{i}")(x))
        fh, fw = x.shape[2:]
        feat = x.permute(0, 2, 3, 1).reshape(b, fh * fw, -1)

        gx = torch.clamp(xy[..., 0] / wid * fw - 0.5, 0, fw - 1)
        gy = torch.clamp(xy[..., 1] / hgt * fh - 0.5, 0, fh - 1)
        x0, y0 = torch.floor(gx), torch.floor(gy)
        x1 = torch.clamp(x0 + 1, max=fw - 1)
        y1 = torch.clamp(y0 + 1, max=fh - 1)
        wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]

        def gather(yy, xx):
            idx = (yy * fw + xx).long()[..., None]
            return torch.gather(feat, 1, idx.expand(-1, -1, feat.shape[-1]))

        vis = ((1 - wx) * (1 - wy) * gather(y0, x0)
               + wx * (1 - wy) * gather(y0, x1)
               + (1 - wx) * wy * gather(y1, x0)
               + wx * wy * gather(y1, x1))
        vis = self.vis_proj(vis)

        size = torch.tensor([wid, hgt], dtype=torch.float32, device=xy.device)
        g = torch.cat([(xy / size - 0.5).to(self.dtype),
                       scores[..., None].to(self.dtype)], -1)
        for i in range(3):
            g = F.relu(_context_norm(getattr(self, f"geo_fc{i}")(g), valid))

        fused = torch.cat([desc.to(self.dtype), vis, g], dim=-1)
        h = F.relu(self.fuse_fc1(fused))
        delta = self.fuse_fc2(h)
        out = l2_normalize((desc.to(self.dtype) + delta).float())
        out = out * valid[..., None]
        match = torch.sigmoid(self.matchability(h).float())[..., 0]
        return out, match * valid


def contextdesc_extract(image_u8: np.ndarray, augmenter=None,
                        topk: int = 2048) -> dict:
    """SIFT on the host, then ``augmenter`` (a ``ContextDesc`` or a
    ``ContextDescAugmenter``, on its weights' device) when given; without
    one the RootSIFT descriptors as they are. Returns numpy keypoints,
    scores (ContextDesc's matchability), valid and descriptors."""
    h, w = image_u8.shape[:2]
    xy, scores, valid, desc = sift_keypoints(image_u8, topk,
                                             with_descriptors=True)
    if augmenter is not None:
        dev = next(augmenter.parameters()).device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))[None].to(dev)
        with torch.no_grad():
            if isinstance(augmenter, ContextDesc):
                img = t(image_u8.astype(np.float32))[..., None] / 255.0
                d, match = augmenter(img, t(desc), t(xy), t(scores), t(valid))
                scores = match[0].cpu().numpy()
            else:
                xy_norm = xy / np.array([w, h], np.float32) - 0.5
                d = augmenter(t(desc), t(xy_norm), t(scores))
        desc = d[0].cpu().numpy()
    return {"keypoints": xy, "scores": scores, "valid": valid,
            "descriptors": desc}


def build_contextdesc(device="cuda", generator: torch.Generator | None = None,
                      **kwargs) -> ContextDesc:
    """``ContextDesc(**kwargs)`` on ``device`` in eval mode, with weights
    drawn from ``generator`` (a CPU generator; seed 0 when None)."""
    with torch.device("meta"):
        model = ContextDesc(**kwargs)
    return materialize(model, device, generator)


def build_contextdesc_augmenter(device="cuda",
                                generator: torch.Generator | None = None,
                                **kwargs) -> ContextDescAugmenter:
    """``ContextDescAugmenter(**kwargs)``, as ``build_contextdesc``."""
    with torch.device("meta"):
        model = ContextDescAugmenter(**kwargs)
    return materialize(model, device, generator)
