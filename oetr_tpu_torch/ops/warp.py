"""Batched crop/resize warps and keypoint frame transforms.

Port of ``oetr_tpu/ops/warp.py``: a predicted box is cropped from each
image and resized onto a fixed canvas with a uniform ratio, so keypoints map
back exactly as ``kpts / ratio + box[:2]``. The bilinear warp factorises
per axis into two interpolation matrices, so it runs as two matmuls. The
JAX package ``vmap``s over pairs; here the batch dimension is written out.
Images are NHWC [B, H, W, C]; boxes are xyxy in image pixels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nms import bilinear_sample


def _axis_weights(n_out: int, n_in: int, ratio: torch.Tensor,
                  origin: torch.Tensor) -> torch.Tensor:
    """[B, n_out, n_in] bilinear interpolation matrices for one axis.

    Row i of pair b holds the two taps of the clamped bilinear sample at
    source coordinate (i + 0.5) / ratio[b] + origin[b] - 0.5.
    """
    i = torch.arange(n_out, dtype=torch.float32, device=ratio.device)
    s = (i[None, :] + 0.5) / ratio[:, None] + origin[:, None] - 0.5
    s = torch.clamp(s, 0.0, n_in - 1.0)
    i0 = torch.floor(s).long()
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    w1 = (s - i0)[..., None]
    return (F.one_hot(i0, n_in).float() * (1.0 - w1)
            + F.one_hot(i1, n_in).float() * w1)


def _ratio(boxes: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    h_out, w_out = out_hw
    bw = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0)
    bh = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0)
    return torch.minimum(w_out / bw, h_out / bh)


def _valid(boxes, ratio, out_hw):
    """[B, H_out, W_out] bool: canvas pixels whose sample lies in the box."""
    h_out, w_out = out_hw
    dev = boxes.device
    xs = ((torch.arange(w_out, dtype=torch.float32, device=dev)[None] + 0.5)
          / ratio[:, None] + boxes[:, 0:1] - 0.5)
    ys = ((torch.arange(h_out, dtype=torch.float32, device=dev)[None] + 0.5)
          / ratio[:, None] + boxes[:, 1:2] - 0.5)
    return ((xs[:, None, :] <= boxes[:, 2, None, None] - 0.5)
            & (ys[:, :, None] <= boxes[:, 3, None, None] - 0.5)), xs, ys


def crop_resize_batch(images: torch.Tensor, boxes: torch.Tensor,
                      out_hw: tuple[int, int]):
    """Crop ``boxes`` [B, 4] from ``images`` [B, H, W, C] and resize each
    onto an ``out_hw`` canvas with one ratio for both axes, as
    out = Wy @ image @ Wxᵀ per channel.

    Returns canvas [B, H_out, W_out, C] in the images' dtype, ratio [B]
    (canvas px per image px) and valid [B, H_out, W_out] (canvas area the
    crop covers; the rest is 0).
    """
    h_out, w_out = out_hw
    _, h_in, w_in, _ = images.shape
    ratio = _ratio(boxes, out_hw)
    wy = _axis_weights(h_out, h_in, ratio, boxes[:, 1]).to(images.dtype)
    wx = _axis_weights(w_out, w_in, ratio, boxes[:, 0]).to(images.dtype)
    tmp = torch.einsum("boy,byxc->boxc", wy, images)
    canvas = torch.einsum("bpx,boxc->bopc", wx, tmp)
    valid, _, _ = _valid(boxes, ratio, out_hw)
    canvas = canvas * valid[..., None].to(images.dtype)
    return canvas, ratio, valid


def crop_resize(image: torch.Tensor, box: torch.Tensor,
                out_hw: tuple[int, int]):
    """``crop_resize_batch`` for one image [H, W, C] and box [4]."""
    canvas, ratio, valid = crop_resize_batch(image[None], box[None], out_hw)
    return canvas[0], ratio[0], valid[0]


def crop_resize_gather(image: torch.Tensor, box: torch.Tensor,
                       out_hw: tuple[int, int]):
    """Gather form of ``crop_resize`` (same semantics): one bilinear sample
    per canvas pixel. Kept as the oracle of the matmul path."""
    h_out, w_out = out_hw
    ratio = _ratio(box[None], out_hw)
    valid, xs, ys = _valid(box[None], ratio, out_hw)
    gy, gx = torch.meshgrid(ys[0], xs[0], indexing="ij")
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    canvas = bilinear_sample(image, coords).reshape(h_out, w_out, -1)
    canvas = canvas * valid[0][..., None]
    return canvas, ratio[0], valid[0]


def unwarp_keypoints(kpts: torch.Tensor, box: torch.Tensor,
                     ratio: torch.Tensor) -> torch.Tensor:
    """Canvas keypoints [..., N, 2] -> the original image's frame:
    kpts / ratio + box[:2]. box [..., 4]; ratio [...]."""
    return kpts / ratio[..., None, None] + box[..., None, :2]


def resize_to_canvas(image: torch.Tensor, out_hw: tuple[int, int]):
    """Aspect-preserving resize of a full image [H, W, C] onto a canvas.

    Returns canvas [H_out, W_out, C], scale (image px per canvas px) and
    valid [H_out, W_out].
    """
    h, w = image.shape[:2]
    box = torch.tensor([0.0, 0.0, float(w), float(h)], dtype=torch.float32,
                       device=image.device)
    canvas, ratio, valid = crop_resize(image, box, out_hw)
    return canvas, 1.0 / ratio, valid
