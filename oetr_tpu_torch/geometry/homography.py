"""Batched DLT homography and 2-D similarity fits with fixed-budget RANSAC
(port of ``oetr_tpu/geometry/homography.py``).

Every function takes any number of leading batch dimensions: points
[..., N, 2], weights and masks [..., N]. The null vector of the DLT system
comes from ``ops.eigh`` (the Jacobi kernel on the card, LAPACK on the
CPU), the hypotheses' samples from Gumbel noise drawn through
``draws.gumbel`` at the ``homography`` stage.
"""
from __future__ import annotations

import math

import torch

from ..ops.small_eigh import eigh
from . import draws


def _normalize(p: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor):
    """Hartley normalization of p [..., N, 2] under weights w: the centred,
    scaled points and the [..., 3, 3] transform, and the transform's
    inverse in closed form."""
    mean = torch.sum(p * w[..., None], dim=-2) / wsum[..., None]
    d = torch.sqrt(torch.sum((p - mean[..., None, :]) ** 2, dim=-1))
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1) / wsum,
                                         min=1e-9)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    mx, my = mean[..., 0], mean[..., 1]
    T = torch.stack([torch.stack([scale, zero, -scale * mx], -1),
                     torch.stack([zero, scale, -scale * my], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    inv = 1.0 / scale
    T_inv = torch.stack([torch.stack([inv, zero, mx], -1),
                         torch.stack([zero, inv, my], -1),
                         torch.stack([zero, zero, one], -1)], -2)
    return (p - mean[..., None, :]) * scale[..., None, None], T, T_inv


def homography_dlt(pts0: torch.Tensor, pts1: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted DLT homographies [..., 3, 3] (pts0 -> pts1) from >= 4
    correspondences [..., N, 2], Hartley-normalized on both sides, scaled so
    that H[2, 2] ~ 1."""
    w = torch.ones_like(pts0[..., 0]) if weights is None else weights
    w = w.expand(pts0.shape[:-1])
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    p0, T0, _ = _normalize(pts0, w, wsum)
    p1, _, T1_inv = _normalize(pts1, w, wsum)

    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_a = torch.stack([-x, -y, -ones, zeros, zeros, zeros,
                          u * x, u * y, u], dim=-1)
    rows_b = torch.stack([zeros, zeros, zeros, -x, -y, -ones,
                          v * x, v * y, v], dim=-1)
    A = torch.cat([rows_a * w[..., None], rows_b * w[..., None]], dim=-2)
    _, V = eigh(A.transpose(-1, -2) @ A)
    Hn = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    H = T1_inv @ Hn @ T0
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) > 1e-12, h22,
                           torch.full_like(h22, 1e-12))


def _similarity(a, b, tx, ty):
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([a, -b, tx], -1),
                        torch.stack([b, a, ty], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def similarity_from_2pts(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """2-D similarity [..., 3, 3] (scale, rotation, translation) from two
    point pairs [..., 2, 2]: the minimal model of
    cv2.estimateAffinePartial2D."""
    d0 = p0[..., 1, :] - p0[..., 0, :]
    d1 = p1[..., 1, :] - p1[..., 0, :]
    denom = torch.clamp(d0[..., 0] ** 2 + d0[..., 1] ** 2, min=1e-12)
    a = (d1[..., 0] * d0[..., 0] + d1[..., 1] * d0[..., 1]) / denom
    b = (d1[..., 1] * d0[..., 0] - d1[..., 0] * d0[..., 1]) / denom
    q0 = p0[..., 0, :]
    tx = p1[..., 0, 0] - (a * q0[..., 0] - b * q0[..., 1])
    ty = p1[..., 0, 1] - (b * q0[..., 0] + a * q0[..., 1])
    return _similarity(a, b, tx, ty)


def similarity_umeyama(p0: torch.Tensor, p1: torch.Tensor,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares 2-D similarity [..., 3, 3] p0 -> p1 (Umeyama), with
    optional weights [..., N] (0 leaves a pair out)."""
    w = torch.ones_like(p0[..., 0]) if weights is None else weights
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu0 = torch.sum(p0 * w[..., None], -2) / wsum[..., None]
    mu1 = torch.sum(p1 * w[..., None], -2) / wsum[..., None]
    q0 = p0 - mu0[..., None, :]
    q1 = p1 - mu1[..., None, :]
    denom = torch.clamp(torch.sum(w * torch.sum(q0 * q0, -1), -1), min=1e-12)
    a = torch.sum(w * (q0[..., 0] * q1[..., 0] + q0[..., 1] * q1[..., 1]),
                  -1) / denom
    b = torch.sum(w * (q0[..., 0] * q1[..., 1] - q0[..., 1] * q1[..., 0]),
                  -1) / denom
    tx = mu1[..., 0] - (a * mu0[..., 0] - b * mu0[..., 1])
    ty = mu1[..., 1] - (b * mu0[..., 0] + a * mu0[..., 1])
    return _similarity(a, b, tx, ty)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Warp points [..., N, 2] by H [..., 3, 3]."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = ph @ H.transpose(-1, -2)
    z = out[..., 2:]
    return out[..., :2] / torch.where(torch.abs(z) > 1e-12, z,
                                      torch.full_like(z, 1e-12))


def _transfer_error(H, pts0, pts1):
    return torch.sum((apply_homography(H, pts0) - pts1) ** 2, dim=-1)


def per_pair(value, batch, like: torch.Tensor) -> torch.Tensor:
    """A float or a tensor as a tensor of the batch shape in like's dtype,
    made on like's device (a float by a fill: no copy from the host, which
    on the card would wait for the device)."""
    if isinstance(value, torch.Tensor):
        return value.to(like.dtype).expand(batch)
    return torch.full(batch, float(value), dtype=like.dtype,
                      device=like.device)


def sample_minimal_sets(g: torch.Tensor, valid: torch.Tensor,
                        sample_size: int) -> torch.Tensor:
    """[..., H, sample_size] indices: the Gumbel top-k of g [..., H, N]
    over the validity mask [..., N], so padded slots are (almost) never
    drawn. A stable descending sort, so that ties (at the -1e9 of invalid
    slots, when a pair has fewer valid points than a sample) go to the lower
    index first, as ``lax.top_k`` gives them."""
    bias = torch.where(valid, 0.0, -1e9).to(g.dtype)
    scores = g + bias[..., None, :]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :sample_size]


def gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts [..., N, 2] at idx [..., H, k] -> [..., H, k, 2]."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    out = torch.gather(pts, -2, flat[..., None].expand(
        flat.shape + (pts.shape[-1],)))
    return out.reshape(idx.shape + (pts.shape[-1],))


def ransac_homography(pts0: torch.Tensor, pts1: torch.Tensor,
                      valid: torch.Tensor, threshold_px,
                      generator: torch.Generator,
                      num_hypotheses: int = 256, model: str = "homography"):
    """Fixed-budget RANSAC for a planar model.

    Args:
      pts0, pts1: [..., N, 2] correspondences (padded); valid: [..., N].
      threshold_px: inlier threshold on the forward transfer error, a
        float or a tensor of the batch shape.
      generator: the ``homography`` stage's draws come from it.
      model: 'homography' (4-point DLT, two refits on the inliers) or
        'similarity' (2-point, no refit).

    Returns dict: H [..., 3, 3], inliers [..., N], num_inliers, ok.
    """
    if model not in ("homography", "similarity"):
        raise ValueError(f"unknown model {model!r}")
    n = pts0.shape[-2]
    batch = pts0.shape[:-2]
    tsq = per_pair(threshold_px, batch, pts0) ** 2
    sample_size = 4 if model == "homography" else 2

    g = draws.gumbel("homography", batch + (num_hypotheses, n), generator)
    idx = sample_minimal_sets(g, valid, sample_size)
    s0 = gather_points(pts0, idx)
    s1 = gather_points(pts1, idx)
    Hs = (homography_dlt(s0, s1) if model == "homography"
          else similarity_from_2pts(s0, s1))

    errs = _transfer_error(Hs, pts0[..., None, :, :], pts1[..., None, :, :])
    inl = (errs < tsq[..., None, None]) & valid[..., None, :]
    best = torch.argmax(inl.sum(-1), dim=-1)
    H = torch.gather(Hs, -3, best[..., None, None, None].expand(
        batch + (1, 3, 3)))[..., 0, :, :]
    inliers = torch.gather(inl, -2, best[..., None, None].expand(
        batch + (1, n)))[..., 0, :]

    if model == "homography":
        for _ in range(2):
            H_new = homography_dlt(pts0, pts1, inliers.to(pts0.dtype))
            inl_new = (_transfer_error(H_new, pts0, pts1)
                       < tsq[..., None]) & valid
            better = inl_new.sum(-1) >= inliers.sum(-1)
            H = torch.where(better[..., None, None], H_new, H)
            inliers = torch.where(better[..., None], inl_new, inliers)

    count = inliers.sum(-1)
    return {"H": H, "inliers": inliers, "num_inliers": count,
            "ok": count >= sample_size}
