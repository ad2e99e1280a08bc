"""Descriptor matchers: nearest neighbour with ratio, distance and mutual
tests, and DISK's brute-force matcher (port of
``oetr_tpu/models/matchers.py``), batched and masked.

The top two of each row are taken as ``jax.lax.top_k`` takes them, on a
tie the lower index first (``ops.nms.topk_stable``): identity pairs and
masked rows (all -1e9) tie.
"""
from __future__ import annotations

import torch

from ..ops.nms import topk_stable

NEG_INF = -1e9


def find_nn(sim: torch.Tensor, ratio_thresh: float | None,
            distance_thresh: float | None,
            valid_cols: torch.Tensor | None = None):
    """Row-wise nearest neighbour with optional Lowe ratio and distance
    tests on the squared descriptor distance 2 (1 - sim).

    sim [B, M, N] cosine similarity; valid_cols [B, N] bool. Returns
    matches [B, M] (-1: none) and scores [B, M].
    """
    if valid_cols is not None:
        sim = torch.where(valid_cols[:, None, :], sim,
                          torch.full_like(sim, NEG_INF))
    sim_nn, ind_nn = topk_stable(sim, 2)
    dist_nn = 2.0 * (1.0 - sim_nn)
    mask = torch.ones(sim.shape[:2], dtype=torch.bool, device=sim.device)
    if ratio_thresh is not None:
        mask = mask & (dist_nn[..., 0] <= ratio_thresh ** 2 * dist_nn[..., 1])
    if distance_thresh is not None:
        mask = mask & (dist_nn[..., 0] <= distance_thresh ** 2)
    matches = torch.where(mask, ind_nn[..., 0], -1)
    scores = torch.where(mask, (sim_nn[..., 0] + 1) / 2,
                         torch.zeros_like(sim_nn[..., 0]))
    return matches, scores


def mutual_check(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """Keep the m0 matches whose reverse match points back."""
    inds0 = torch.arange(m0.shape[1], device=m0.device)[None, :]
    loop = torch.gather(m1, 1, torch.clamp(m0, min=0))
    return torch.where((m0 > -1) & (inds0 == loop), m0, -1)


def nearest_neighbor_match(desc0: torch.Tensor, desc1: torch.Tensor,
                           valid0: torch.Tensor | None = None,
                           valid1: torch.Tensor | None = None,
                           ratio_threshold: float | None = None,
                           distance_threshold: float | None = None,
                           do_mutual_check: bool = True) -> dict:
    """Nearest-neighbour matcher.

    desc0 [B, M, D], desc1 [B, N, D] unit-norm descriptors; valid0/valid1
    [B, M]/[B, N] keypoint validity. Returns matches0 [B, M] and
    matching_scores0 [B, M].
    """
    sim = torch.einsum("bmd,bnd->bmn", desc0, desc1)
    matches0, scores0 = find_nn(sim, ratio_threshold, distance_threshold,
                                valid1)
    if do_mutual_check:
        matches1, _ = find_nn(sim.transpose(1, 2), ratio_threshold,
                              distance_threshold, valid0)
        matches0 = mutual_check(matches0, matches1)
    if valid0 is not None:
        matches0 = torch.where(valid0, matches0, -1)
        scores0 = torch.where(valid0, scores0, torch.zeros_like(scores0))
    return {"matches0": matches0, "matching_scores0": scores0}


def disk_brute_match(desc0: torch.Tensor, desc1: torch.Tensor,
                     valid0: torch.Tensor | None = None,
                     valid1: torch.Tensor | None = None,
                     rt: float = 0.1) -> dict:
    """DISK's brute-force matcher: L2 nearest neighbours over unit-norm
    descriptors, mutual, kept where the best distance is at least ``rt``
    relatively better than the runner-up (d_best <= (1 - rt) d_second).
    Kept matches score 1.
    """
    sim = torch.einsum("bmd,bnd->bmn", desc0, desc1)

    def side(s, vcols):
        if vcols is not None:
            s = torch.where(vcols[:, None, :], s, torch.full_like(s, NEG_INF))
        sim_nn, ind_nn = topk_stable(s, 2)
        dist_nn = torch.clamp(2.0 * (1.0 - sim_nn), min=0.0)
        keep = dist_nn[..., 0] <= (1.0 - rt) * dist_nn[..., 1]
        return torch.where(keep, ind_nn[..., 0], -1)

    m0 = side(sim, valid1)
    m1 = side(sim.transpose(1, 2), valid0)
    matches0 = mutual_check(m0, m1)
    if valid0 is not None:
        matches0 = torch.where(valid0, matches0, -1)
    return {"matches0": matches0,
            "matching_scores0": (matches0 > -1).to(torch.float32)}
