"""SuperGlue training (port of ``oetr_tpu/training/superglue.py``).

The loss is the negative log-likelihood of the ground-truth partial
assignment under the Sinkhorn transport plan (the SuperGlue paper):
matched pairs at Z[i, j], unmatched keypoints at their dustbin entries.
Ground truth rides as ``gt_matches0`` [B, M] (the image-1 index, -1 for
the dustbin) with the validity masks; every shape is static.

The step differentiates through the plain Sinkhorn
(``ops/sinkhorn.log_sinkhorn``): the K4 kernel has no backward, as JAX's
Pallas Sinkhorn has none, so a model whose ``cuda_sinkhorn`` switch is on
raises K4's error instead of training.
"""
from __future__ import annotations

import torch

from ..ops.sinkhorn import NO_BACKWARD
from ..parallel.data import global_batch, global_mean, sum_metrics, sync_params
from .losses import interpolate_depth
from .optim import apply_update


def superglue_nll_loss(log_assignment: torch.Tensor,
                       gt_matches0: torch.Tensor, valid0: torch.Tensor,
                       valid1: torch.Tensor) -> torch.Tensor:
    """Mean NLL of the GT assignment under the [B, M+1, N+1] log plan.

    gt_matches0 [B, M], -1 for unmatched. Each valid image-0 keypoint
    counts at its match or at the dustbin column; each valid image-1
    keypoint that no match points at counts at the dustbin row.
    """
    b, m1, n1 = log_assignment.shape
    m, n = m1 - 1, n1 - 1
    gt = gt_matches0.long()
    col = torch.where(gt >= 0, gt, n)
    row_ll = torch.gather(log_assignment[:, :m, :], 2, col[..., None])[..., 0]
    row_ll = torch.where(valid0, row_ll, 0.0)

    idx = torch.clamp(gt, 0, n - 1)
    hit = ((gt >= 0) & valid0).float()
    matched1 = torch.zeros((b, n), dtype=torch.float32,
                           device=gt.device).scatter_add_(1, idx, hit) > 0
    unmatched1 = valid1 & ~matched1
    col_ll = torch.where(unmatched1, log_assignment[:, m, :n], 0.0)

    denom = valid0.sum(dim=1) + unmatched1.sum(dim=1)
    per_b = -(row_ll.sum(dim=1) + col_ll.sum(dim=1)) / torch.clamp(
        denom.float(), min=1.0)
    return global_mean(per_b)


def gt_matches_batch(xy0: torch.Tensor, v0: torch.Tensor, xy1: torch.Tensor,
                     v1: torch.Tensor, depth0: torch.Tensor, K0: torch.Tensor,
                     T_0to1: torch.Tensor, K1: torch.Tensor,
                     depth1: torch.Tensor | None = None, radius: float = 3.0,
                     occlusion_thresh: float = 0.5) -> torch.Tensor:
    """GT partial assignment from known geometry, batched on the device:
    image-0 keypoints warped through depth0 and the pose, mutual nearest
    neighbours among the image-1 keypoints under the Euclidean distance,
    accepted within ``radius`` px; with ``depth1`` also an occlusion check
    (|z in camera 1 - depth1 there| < ``occlusion_thresh``).

    xy0, xy1 [B, K, 2]; v0, v1 [B, K] validity; depth0, depth1 [B, H, W];
    K0, K1 [B, 3, 3]; T_0to1 [B, 4, 4]. Returns gt_matches0 [B, K] int32
    (-1 unmatched).
    """
    z, ok = interpolate_depth(depth0, xy0)
    fx, fy = K0[:, 0, 0, None], K0[:, 1, 1, None]
    cx, cy = K0[:, 0, 2, None], K0[:, 1, 2, None]
    P = torch.stack([(xy0[..., 0] - cx) * z / fx,
                     (xy0[..., 1] - cy) * z / fy, z], dim=-1)
    Pc2 = P @ T_0to1[:, :3, :3].transpose(1, 2) + T_0to1[:, None, :3, 3]
    uv = Pc2 @ K1.transpose(1, 2)
    w = uv[..., 2:]
    xy2 = uv[..., :2] / torch.where(w.abs() > 1e-9, w,
                                    torch.full_like(w, 1e-9))
    ok = ok & (Pc2[..., 2] > 1e-6) & v0
    if depth1 is not None:
        z2, ok2 = interpolate_depth(depth1, xy2)
        ok = ok & ok2 & ((Pc2[..., 2] - z2).abs() < occlusion_thresh)
    d = torch.linalg.vector_norm(xy2[:, :, None] - xy1[:, None], dim=-1)
    d = torch.where(ok[:, :, None] & v1[:, None, :], d,
                    torch.full_like(d, 1e9))
    best, nn1 = d.min(dim=2)
    nn0 = d.argmin(dim=1)
    ar = torch.arange(xy0.shape[1], device=xy0.device)
    mutual = torch.gather(nn0, 1, nn1) == ar
    return torch.where((best < radius) & mutual, nn1,
                       torch.full_like(nn1, -1)).to(torch.int32)


def make_superglue_train_step(model, optimizer, scheduler=None,
                              clip_norm: float | None = None, group=None):
    """``step(batch) -> {"loss", "match_acc"}``: ``model`` (a ``SuperGlue``)
    on the batch (its input dict plus ``gt_matches0`` [B, M]), the NLL loss,
    the backward through the plain Sinkhorn and the update.
    ``match_acc`` is the share of keypoint slots whose ``matches0`` equals
    the GT and is valid. With the model's ``cuda_sinkhorn`` switch on the
    step raises K4's error: the kernel has no backward. ``group``: data
    parallelism over its ranks, each with its rows of the global batch."""
    sync_params(model, group)

    def step(batch: dict):
        if model.cuda_sinkhorn:
            raise RuntimeError(NO_BACKWARD)
        optimizer.zero_grad(set_to_none=True)
        with global_batch(group):
            out = model(batch)
            loss = superglue_nll_loss(out["log_assignment"],
                                      batch["gt_matches0"], batch["valid0"],
                                      batch["valid1"])
            hit = ((out["matches0"] == batch["gt_matches0"].long())
                   & batch["valid0"])
            acc = global_mean(hit.float())
        loss.backward()
        apply_update(model.parameters(), optimizer, scheduler, clip_norm,
                     group)
        return sum_metrics({"loss": loss.detach(), "match_acc": acc}, group)

    return step
