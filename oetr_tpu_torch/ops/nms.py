"""Keypoint ops: spatial NMS, fixed-k top-k selection, descriptor sampling.

Port of ``oetr_tpu/ops/nms.py``. Score maps stay dense [B, H, W], and the
selection is a fixed-k top-k with a validity mask, so no shape depends on
the data. The top-k breaks ties toward the lower index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order among equal
values, and on the card none holds): flat score regions and saturated
sigmoids tie.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _maxpool2d(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over a (2r+1)² window, stride 1, padded with -inf (SAME).
    x: [B, H, W]. Separable: a row pass, then a column pass."""
    k = 2 * radius + 1
    y = F.max_pool2d(x[:, None], (1, k), stride=1, padding=(0, radius))
    return F.max_pool2d(y, (k, 1), stride=1, padding=(radius, 0))[:, 0]


def simple_nms(scores: torch.Tensor, radius: int,
               iterations: int = 2) -> torch.Tensor:
    """SuperPoint's iterative non-maximum suppression on [B, H, W] maps:
    positions within ``radius`` of a stronger detection are zeroed."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool2d(scores, radius)
    for _ in range(iterations):
        supp_mask = _maxpool2d(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max = supp_scores == _maxpool2d(supp_scores, radius)
        max_mask = max_mask | (new_max & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def remove_borders(scores: torch.Tensor, border: int) -> torch.Tensor:
    """Zero a ``border``-pixel frame of [B, H, W] maps."""
    _, h, w = scores.shape
    ys = torch.arange(h, device=scores.device)[:, None]
    xs = torch.arange(w, device=scores.device)[None, :]
    keep = ((ys >= border) & (ys < h - border)
            & (xs >= border) & (xs < w - border))
    return torch.where(keep[None], scores, torch.zeros_like(scores))


def topk_stable(x: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, in
    descending order, equal values in index order (``jax.lax.top_k``).
    k = 2 (the matchers' ratio tests) takes the first index of the maximum
    twice, the second time with the first one masked out; any other k a
    stable descending sort."""
    if k == 2:
        i0 = torch.argmax(x, dim=-1, keepdim=True)
        i1 = torch.argmax(x.scatter(-1, i0, float("-inf")), dim=-1,
                          keepdim=True)
        idx = torch.cat([i0, i1], dim=-1)
        return torch.gather(x, -1, idx), idx
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_keypoints(scores: torch.Tensor, k: int, threshold: float = 0.0,
                   nms_tile: int = 0):
    """Fixed-k keypoints from a [B, H, W] score map.

    With ``nms_tile`` > 1 the map is known to be NMS-suppressed with radius
    >= nms_tile - 1, so a tile of nms_tile² pixels holds at most one
    positive survivor: the top-k runs on the tiles' maxima (so among equal
    scores the tile order, not the pixel order, decides, as in JAX). It
    falls back to the dense path when there are fewer tiles than k.

    Returns xy [B, k, 2] float (x, y), scores [B, k] and valid [B, k].
    """
    b, h, w = scores.shape
    if nms_tile and nms_tile > 1:
        t = nms_tile
        ht, wt = -(-h // t), -(-w // t)
        if ht * wt >= k:
            s = F.pad(scores, (0, wt * t - w, 0, ht * t - h),
                      value=float("-inf"))
            s = s.reshape(b, ht, t, wt, t).permute(0, 1, 3, 2, 4)
            s = s.reshape(b, ht * wt, t * t)
            cmax = s.amax(dim=-1)
            carg = s.argmax(dim=-1)
            vals, cidx = topk_stable(cmax, k)
            within = torch.gather(carg, 1, cidx)
            ys = (cidx // wt * t + within // t).float()
            xs = (cidx % wt * t + within % t).float()
            xy = torch.stack([xs, ys], dim=-1)
            valid = (vals > threshold) & (xs < w) & (ys < h)
            # Pad slots carry -inf scores: report them as 0, like the dense
            # path's empty cells.
            vals = torch.clamp(vals, min=0.0)
            xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
            return xy, vals, valid
    vals, idx = topk_stable(scores.reshape(b, h * w), k)
    xy = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return xy, vals, vals > threshold


def refine_keypoints(dense_scores: torch.Tensor,
                     xy: torch.Tensor) -> torch.Tensor:
    """Sub-pixel refinement: the 3x3 score-weighted centroid of the raw
    (pre-NMS) map around each integer keypoint, clamped to ±0.5 px.

    dense_scores [B, H, W]; xy [B, K, 2] integer (x, y). Returns [B, K, 2].
    """
    b, h, w = dense_scores.shape
    xi = xy[..., 0].long()
    yi = xy[..., 1].long()
    num = torch.zeros_like(xy)
    den = torch.zeros(xy.shape[:-1], dtype=dense_scores.dtype,
                      device=xy.device)
    flat = dense_scores.reshape(b, h * w)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            xs = torch.clamp(xi + dx, 0, w - 1)
            ys = torch.clamp(yi + dy, 0, h - 1)
            s = torch.clamp(torch.gather(flat, 1, ys * w + xs), min=0.0)
            num = num + s[..., None] * torch.stack(
                [torch.full_like(s, dx), torch.full_like(s, dy)], dim=-1)
            den = den + s
    offset = num / torch.clamp(den, min=1e-6)[..., None]
    return xy + torch.clamp(offset, -0.5, 0.5)


def _bilinear(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Batched clamped bilinear sample: grid [B, H, W, C] at xy [B, N, 2]
    (pixel units) -> [B, N, C]."""
    b, h, w, _ = grid.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (x - x0).to(grid.dtype)[..., None]
    wy = (y - y0).to(grid.dtype)[..., None]
    bi = torch.arange(b, device=grid.device)[:, None]
    v00 = grid[bi, y0, x0]
    v01 = grid[bi, y0, x1]
    v10 = grid[bi, y1, x0]
    v11 = grid[bi, y1, x1]
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def bilinear_sample(grid: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of [H, W, C] features at [N, 2] (x, y) pixel
    coordinates; out-of-range coordinates clamp. Returns [N, C]."""
    return _bilinear(grid[None], xy[None])[0]


def sample_descriptors(desc_map: torch.Tensor, xy: torch.Tensor,
                       stride: int = 8) -> torch.Tensor:
    """Unit-norm descriptors at keypoints.

    desc_map [B, Hc, Wc, D] at stride ``stride``; xy [B, K, 2] in
    full-resolution pixels. Returns [B, K, D], normalised as
    x * rsqrt(‖x‖² + 1e-8).
    """
    out = _bilinear(desc_map, (xy - stride / 2 + 0.5) / stride)
    return out * torch.rsqrt((out * out).sum(dim=-1, keepdim=True) + 1e-8)
