"""LoFTR training (port of ``oetr_tpu/training/loftr.py``).

The coarse loss is the negative log of the dual-softmax confidence at the
ground-truth coarse cell correspondences (LoFTR eq. 5); GT rides as
``gt_matches0`` [B, N], the matching image-1 cell of each image-0 cell or
-1. The fine loss (``fine_weight`` > 0) regresses the refined ``mkpts1``
to the continuous warp of the cell centres.

Two quirks of JAX's trainer are copied: the fine supervision keeps targets
at exactly ``reach_px`` (``<=``), which the soft-argmax can only approach,
and a step built with ``fine_weight`` > 0 does not check that ``gt_xy1``
was given (without it the fine loss fails inside).
"""
from __future__ import annotations

import torch

from .losses import interpolate_depth
from .optim import apply_update


def loftr_coarse_loss(coarse_conf: torch.Tensor, gt_matches0: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Mean -log(conf[i, gt(i)]) over the cells with a GT match.

    coarse_conf [B, N, N] dual-softmax probabilities; gt_matches0 [B, N].
    """
    gt = gt_matches0.long()
    has_gt = gt >= 0
    col = torch.clamp(gt, 0, coarse_conf.shape[-1] - 1)
    p = torch.gather(coarse_conf, 2, col[..., None])[..., 0]
    ll = torch.where(has_gt, torch.log(torch.clamp(p, min=eps)), 0.0)
    return -ll.sum() / torch.clamp(has_gt.sum(), min=1)


def warp_cell_centers_batch(xy0: torch.Tensor, depth0: torch.Tensor,
                            K0: torch.Tensor, T_0to1: torch.Tensor,
                            K1: torch.Tensor,
                            depth1: torch.Tensor | None = None,
                            occlusion_thresh: float = 0.5):
    """The continuous warp of image-0 points into image 1 through depth0
    and the pose (the fine loss's target).

    xy0 [B, N, 2]; depth0 [B, H, W]; K0, K1 [B, 3, 3]; T_0to1 [B, 4, 4];
    depth1 optional [B, H, W] for the occlusion check. Returns (xy1
    [B, N, 2], valid [B, N]).
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
    ok = ok & (Pc2[..., 2] > 1e-6)
    if depth1 is not None:
        z2, ok2 = interpolate_depth(depth1, xy2)
        ok = ok & ok2 & ((Pc2[..., 2] - z2).abs() < occlusion_thresh)
    return xy2, ok


def loftr_fine_loss(out: dict, gt_matches0: torch.Tensor,
                    gt_xy1: torch.Tensor, gt_valid1: torch.Tensor,
                    reach_px: float = 4.0):
    """The squared error of the refined ``mkpts1`` against the continuous
    GT warp, in units of ``reach_px``, over the supervised proposals: valid,
    with a valid warp, whose image-1 cell is the GT one, and whose target
    lies within ``reach_px`` (the 5-window at stride 2: 4 px) of the coarse
    position. Returns (loss, the supervised share of the proposals)."""
    cells0, cells1 = out["cells0"], out["cells1"]
    gt_col = torch.gather(gt_matches0.long(), 1, cells0)
    tgt = torch.gather(gt_xy1, 1, cells0[..., None].expand(-1, -1, 2))
    okv = torch.gather(gt_valid1, 1, cells0)
    inreach = (tgt - out["mkpts1_coarse"]).abs().amax(dim=-1) <= reach_px
    sup = out["valid"] & okv & (gt_col >= 0) & (cells1 == gt_col) & inreach
    err = (out["mkpts1"] - tgt) / reach_px
    l2 = (err * err).sum(dim=-1)
    n = torch.clamp(sup.sum(), min=1)
    loss = torch.where(sup, l2, 0.0).sum() / n
    return loss, sup.sum() / sup.numel()


def make_loftr_train_step(model, optimizer, fine_weight: float = 0.0,
                          scheduler=None, clip_norm: float | None = None):
    """``step(image0, image1, gt_matches0) -> {"loss", "coarse_acc"}``: the
    coarse loss, its backward and the update. ``coarse_acc`` is the share
    of cells with a GT match whose coarse_conf row argmax is that match.

    With ``fine_weight`` > 0 the step takes ``gt_xy1`` [B, N, 2] and
    ``gt_valid1`` [B, N] too (``warp_cell_centers_batch`` of the cell
    centres), adds ``fine_weight`` times the fine loss and reports
    ``fine_loss`` and ``fine_frac``.
    """
    def step(image0, image1, gt_matches0, gt_xy1=None, gt_valid1=None):
        optimizer.zero_grad(set_to_none=True)
        out = model(image0, image1)
        loss = loftr_coarse_loss(out["coarse_conf"], gt_matches0)
        metrics = {}
        if fine_weight:
            fine, frac = loftr_fine_loss(out, gt_matches0, gt_xy1, gt_valid1)
            loss = loss + fine_weight * fine
            metrics = {"fine_loss": fine.detach(), "fine_frac": frac}
        loss.backward()
        apply_update(model.parameters(), optimizer, scheduler, clip_norm)
        gt = gt_matches0.long()
        has_gt = gt >= 0
        pred = out["coarse_conf"].detach().argmax(dim=2)
        acc = (has_gt & (pred == gt)).sum() / torch.clamp(has_gt.sum(), min=1)
        return {"loss": loss.detach(), "coarse_acc": acc, **metrics}

    if fine_weight:
        return step

    def step5(image0, image1, gt_matches0):
        return step(image0, image1, gt_matches0)

    return step5


def shift_pair_gt(hw: tuple[int, int], shift_xy: tuple[int, int],
                  device=None) -> torch.Tensor:
    """GT coarse matches [1, N] for image1 = image0 shifted by (dx, dy)
    pixels, multiples of 8: cell (r, c) maps to (r + dy/8, c + dx/8), -1
    where that leaves the grid."""
    h, w = hw
    hc, wc = h // 8, w // 8
    dx, dy = shift_xy
    assert dx % 8 == 0 and dy % 8 == 0
    rr, cc = torch.meshgrid(torch.arange(hc, device=device),
                            torch.arange(wc, device=device), indexing="ij")
    r2 = rr + dy // 8
    c2 = cc + dx // 8
    ok = (r2 >= 0) & (r2 < hc) & (c2 >= 0) & (c2 < wc)
    gt = torch.where(ok, r2 * wc + c2, -1)
    return gt.reshape(1, hc * wc)
