"""OETR training losses as functions of (model outputs, ground truth)
(port of ``oetr_tpu/training/losses.py``).

Centre and size L1 losses on normalized cxywh, the symmetric GIoU (or
OIoU) pair loss, IoU / OIoU metrics, the swapped-query cycle loss, the
depth-warped cycle GIoU loss, the token InfoNCE of coarse correspondences,
the dense heat-map cross-entropy, the tlbr size loss and the per-pair
difficulty weights. Invalid pairs are masked by ``overlap_valid``, not
dropped, so shapes stay fixed. The functions that JAX vmaps over pairs take
the pairs as a leading batch dimension here. Inside
``parallel.global_batch(group)`` every mean divides by the global batch's
count (the valid pairs, the matched tokens, the difficulty weights' mean),
as JAX's loss over a sharded batch does.
"""
from __future__ import annotations

import torch

from ..geometry.boxes import (bbox_oiou, bbox_overlaps_aligned,
                              box_xyxy_to_cxywh, giou_loss,
                              pair_overlap_loss)
from ..geometry.overlap import warp_grid_via_depth
from ..parallel.data import batch_shard, global_count, global_numel


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the valid rows; 0 when none is valid. Inside
    ``parallel.global_batch`` the valid rows of every rank count: this
    rank's share of the global batch's mean."""
    w = valid.to(x.dtype)
    return torch.sum(x * w) / torch.clamp(global_count(torch.sum(w)),
                                          min=1.0)


def _pair(a: float, b: float, like: torch.Tensor) -> torch.Tensor:
    """[a, b] in like's dtype, made on like's device by fills (a tensor
    from a list would be copied from the host and wait for the device)."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype,
                                   device=like.device) for v in (a, b)])


def oetr_losses(outputs: dict, gt_bbox1: torch.Tensor,
                gt_bbox2: torch.Tensor, valid: torch.Tensor,
                image_hw1: tuple[int, int], image_hw2: tuple[int, int],
                oiou: bool = False,
                weights: torch.Tensor | None = None) -> dict:
    """The loss and metric dict of a forward.

    outputs: the OETR forward dict (pred_bbox1/2 xyxy, cycle_center1/2
    where the forward ran ``with_cycle``); gt_bbox1/2 [B, 4] ground-truth
    overlap boxes (xyxy pixels); valid [B] bool; weights optional [B]
    per-pair loss weights (``difficulty_weights``). Keys holding "loss" are
    the terms ``total_loss`` sums; iou1/2 and oiou1/2 are metrics.
    """
    h1, w1 = image_hw1
    h2, w2 = image_hw2
    pred1, pred2 = outputs["pred_bbox1"], outputs["pred_bbox2"]
    wts = (torch.ones(valid.shape, dtype=torch.float32, device=valid.device)
           if weights is None else weights)

    pred_c1 = box_xyxy_to_cxywh(pred1, h1, w1)
    pred_c2 = box_xyxy_to_cxywh(pred2, h2, w2)
    gt_c1 = box_xyxy_to_cxywh(gt_bbox1, h1, w1)
    gt_c2 = box_xyxy_to_cxywh(gt_bbox2, h2, w2)
    scale1 = _pair(w1, h1, pred1)
    scale2 = _pair(w2, h2, pred2)

    def l1(a, b, scale):
        return torch.mean(torch.abs(a / scale - b / scale), dim=-1)

    loc_loss = (_masked_mean(wts * l1(pred_c1[:, :2], gt_c1[:, :2], scale1),
                             valid)
                + _masked_mean(wts * l1(pred_c2[:, :2], gt_c2[:, :2], scale2),
                               valid))
    wh_loss = (_masked_mean(wts * l1(pred_c1[:, 2:], gt_c1[:, 2:], scale1),
                            valid)
               + _masked_mean(wts * l1(pred_c2[:, 2:], gt_c2[:, 2:], scale2),
                              valid)) / 2.0
    iou_loss_val = _masked_mean(
        wts * pair_overlap_loss(pred1, gt_bbox1, pred2, gt_bbox2, oiou=oiou),
        valid)
    out = {
        "iouloss": iou_loss_val,
        "wh_loss": wh_loss,
        "loc_loss": loc_loss,
        "iou1": _masked_mean(bbox_overlaps_aligned(pred1, gt_bbox1), valid),
        "iou2": _masked_mean(bbox_overlaps_aligned(pred2, gt_bbox2), valid),
        "oiou1": _masked_mean(bbox_oiou(gt_bbox1, pred1), valid),
        "oiou2": _masked_mean(bbox_oiou(gt_bbox2, pred2), valid),
    }
    if "cycle_center1" in outputs:
        # The swapped-query centres against the ground-truth centres.
        def center_l1(center, gt_c, scale):
            return torch.mean(torch.abs(center / scale - gt_c[:, :2] / scale),
                              dim=-1)

        out["cycle_loss"] = (
            _masked_mean(center_l1(outputs["cycle_center1"], gt_c1, scale1),
                         valid)
            + _masked_mean(center_l1(outputs["cycle_center2"], gt_c2, scale2),
                           valid))
    return out


def total_loss(loss_dict: dict) -> torch.Tensor:
    """The sum of every entry whose key contains "loss"."""
    return sum(v for k, v in loss_dict.items() if "loss" in k)


# ------------------------------------------- depth-warped cycle overlap --

def _gather_hw(depth: torch.Tensor, yi: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """depth [B, H, W] at integer pixels (yi, xi) [B, ...]: [B, ...]."""
    b, _, w = depth.shape
    idx = (yi.long() * w + xi.long()).reshape(b, -1)
    return torch.gather(depth.reshape(b, -1), 1, idx).reshape(yi.shape)


def interpolate_depth(depth: torch.Tensor, uv: torch.Tensor):
    """Bilinear depth at (x, y) samples uv [B, ..., 2] of depth [B, H, W]:
    (z [B, ...], valid [B, ...]); a sample is valid where it lies in the
    image and all four surrounding depths are > 0."""
    h, w = depth.shape[-2:]
    x, y = uv[..., 0], uv[..., 1]
    in_bounds = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    d00 = _gather_hw(depth, y0, x0)
    d01 = _gather_hw(depth, y0, x1)
    d10 = _gather_hw(depth, y1, x0)
    d11 = _gather_hw(depth, y1, x1)
    valid = in_bounds & (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
    wx = x - x0
    wy = y - y0
    z = ((1 - wy) * ((1 - wx) * d00 + wx * d01)
         + wy * ((1 - wx) * d10 + wx * d11))
    return z, valid


def warped_box_via_depth(box1, K1, depth1, T1, crop1, ratio1, K2, depth2,
                         T2, crop2, ratio2, occlusion_thresh: float = 1.0):
    """The pixels of depth1 inside box1 [B, 4] that have depth, land in
    image 2, have a valid bilinear depth there and agree with it within
    ``occlusion_thresh``, bounded in image 2: (box2 [B, 4] xyxy, valid
    [B]); a zero box where no pixel survives."""
    h1, w1 = depth1.shape[-2:]
    h2, w2 = depth2.shape[-2:]
    uv2, z2_est, has_depth = warp_grid_via_depth(
        K1, depth1, T1, crop1, ratio1, K2, T2, crop2, ratio2)
    dev = depth1.device
    v1 = torch.arange(h1, dtype=torch.float32, device=dev)[:, None]
    u1 = torch.arange(w1, dtype=torch.float32, device=dev)[None, :]
    bx = box1[:, :, None, None]
    inside = ((u1 >= bx[:, 0]) & (u1 <= bx[:, 2])
              & (v1 >= bx[:, 1]) & (v1 <= bx[:, 3]))
    z2_interp, interp_valid = interpolate_depth(depth2, uv2)
    not_occluded = torch.abs(z2_est - z2_interp) < occlusion_thresh
    in_bounds = ((uv2[..., 0] >= 0) & (uv2[..., 0] <= w2 - 1)
                 & (uv2[..., 1] >= 0) & (uv2[..., 1] <= h2 - 1))
    m = (inside & has_depth & interp_valid & in_bounds
         & not_occluded).flatten(1)
    any_valid = m.any(dim=1)
    us, vs = uv2[..., 0].flatten(1), uv2[..., 1].flatten(1)
    big = 1e9
    box = torch.stack([torch.where(m, us, big).amin(1),
                       torch.where(m, vs, big).amin(1),
                       torch.where(m, us, -big).amax(1),
                       torch.where(m, vs, -big).amax(1)], dim=-1)
    return torch.where(any_valid[:, None], box, torch.zeros_like(box)), \
        any_valid


def cycle_overlap_loss(pred_bbox1, pred_bbox2, K1, depth1, T1, crop1, ratio1,
                       K2, depth2, T2, crop2, ratio2, valid,
                       occlusion_thresh: float = 1.0) -> torch.Tensor:
    """Symmetric depth-warped cycle GIoU loss: each predicted box's
    co-visible cloud warped into the other image, GIoU of the other
    prediction against that warped box, both ways averaged, over the pairs
    that are valid and warp to a box both ways. The warped box is a
    constant for the gradient; so is the box it is warped from."""
    def one_way(box_a, Ka, da, Ta, ca, ra, box_b, Kb, db, Tb, cb, rb):
        wbox, ok = warped_box_via_depth(box_a.detach(), Ka, da, Ta, ca, ra,
                                        Kb, db, Tb, cb, rb, occlusion_thresh)
        return giou_loss(box_b, wbox.detach()), ok

    l12, ok12 = one_way(pred_bbox1, K1, depth1, T1, crop1, ratio1,
                        pred_bbox2, K2, depth2, T2, crop2, ratio2)
    l21, ok21 = one_way(pred_bbox2, K2, depth2, T2, crop2, ratio2,
                        pred_bbox1, K1, depth1, T1, crop1, ratio1)
    return _masked_mean((l12 + l21) / 2.0, valid & ok12 & ok21)


# ------------------------------------ coarse-correspondence supervision --

def token_matches_from_geometry(K1, depth1, T1, crop1, ratio1, K2, T2, crop2,
                                ratio2, hw2: tuple[int, int], stride: int,
                                depth2=None, occlusion_thresh: float = 0.5):
    """Ground-truth coarse correspondences of pairs: for each token of
    image 1's stride-``stride`` grid, the index of image 2's token its
    centre warps into, or -1. A token is matched where its centre has
    depth, lands in image 2 and, with ``depth2``, agrees with image 2's
    depth within ``occlusion_thresh``. Returns (gt [B, N] int32, valid
    [B, N] bool), N = (H1 / stride) * (W1 / stride)."""
    h1, w1 = depth1.shape[-2:]
    h2, w2 = hw2
    b = depth1.shape[0]
    uv2, z2_est, has_depth = warp_grid_via_depth(
        K1, depth1, T1, crop1, ratio1, K2, T2, crop2, ratio2)
    hf1, wf1 = h1 // stride, w1 // stride
    hf2, wf2 = h2 // stride, w2 // stride
    dev = depth1.device
    cy = torch.arange(hf1, device=dev) * stride + stride // 2
    cx = torch.arange(wf1, device=dev) * stride + stride // 2
    centers_uv = uv2[:, cy][:, :, cx]                   # [B, hf1, wf1, 2]
    centers_ok = has_depth[:, cy][:, :, cx]
    tx = torch.floor(centers_uv[..., 0] / stride).to(torch.int32)
    ty = torch.floor(centers_uv[..., 1] / stride).to(torch.int32)
    ok = centers_ok & (tx >= 0) & (tx < wf2) & (ty >= 0) & (ty < hf2)
    if depth2 is not None:
        ix = torch.clamp(centers_uv[..., 0].to(torch.int32), 0, w2 - 1)
        iy = torch.clamp(centers_uv[..., 1].to(torch.int32), 0, h2 - 1)
        z2 = _gather_hw(depth2, iy, ix)
        z_est = z2_est[:, cy][:, :, cx]
        ok = ok & (z2 > 0) & (torch.abs(z_est - z2) < occlusion_thresh)
    idx = torch.where(ok, ty * wf2 + tx, -1)
    return idx.reshape(b, -1), ok.reshape(b, -1)


def token_infonce_loss(mem1: torch.Tensor, mem2: torch.Tensor,
                       gt1: torch.Tensor, valid1: torch.Tensor,
                       temp: float = 0.1) -> torch.Tensor:
    """InfoNCE over the encoder's tokens: each matched token of image 1
    [B, N, d] must retrieve its counterpart among image 2's [B, M, d] by
    cosine similarity / temp. gt1 [B, N] (-1 unmatched), valid1 [B, N]."""
    n1 = mem1 / torch.clamp(torch.linalg.norm(mem1, dim=-1, keepdim=True),
                            min=1e-6)
    n2 = mem2 / torch.clamp(torch.linalg.norm(mem2, dim=-1, keepdim=True),
                            min=1e-6)
    sim = torch.einsum("bnd,bmd->bnm", n1, n2) / temp
    logp = torch.log_softmax(sim, dim=-1)
    tgt = torch.clamp(gt1, min=0).long()
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    has = (gt1 >= 0) & valid1
    return -torch.sum(torch.where(has, ll, 0.0)) / torch.clamp(
        global_count(has.sum().to(ll.dtype)), min=1.0)


def aux_match_loss(outputs: dict, batch: dict, stride: int,
                   temp: float = 0.1) -> torch.Tensor:
    """Token InfoNCE both ways from the batch's geometry (K1/2, depth1/2,
    pose1/2, crop1/2, ratio1/2), over the valid pairs."""
    h1w1 = tuple(batch["image1"].shape[1:3])
    h2w2 = tuple(batch["image2"].shape[1:3])
    gt12, ok12 = token_matches_from_geometry(
        batch["K1"], batch["depth1"], batch["pose1"], batch["crop1"],
        batch["ratio1"], batch["K2"], batch["pose2"], batch["crop2"],
        batch["ratio2"], h2w2, stride, depth2=batch["depth2"])
    gt21, ok21 = token_matches_from_geometry(
        batch["K2"], batch["depth2"], batch["pose2"], batch["crop2"],
        batch["ratio2"], batch["K1"], batch["pose1"], batch["crop1"],
        batch["ratio1"], h1w1, stride, depth2=batch["depth1"])
    v = batch["overlap_valid"][:, None]
    l12 = token_infonce_loss(outputs["mem1"], outputs["mem2"], gt12,
                             ok12 & v, temp)
    l21 = token_infonce_loss(outputs["mem2"], outputs["mem1"], gt21,
                             ok21 & v, temp)
    return (l12 + l21) / 2.0


def heatmap_ce_loss(prob_map: torch.Tensor, gt_box: torch.Tensor,
                    valid: torch.Tensor, image_hw: tuple[int, int],
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy of the centre heat map prob_map [B, N] (a softmax over
    an hf x wf token grid of ``image_hw``) against the uniform target on
    the tokens whose centres lie in the ground-truth box [B, 4]; where no
    centre does, a one-hot target on the token nearest the box centre."""
    b, n = prob_map.shape
    h, w = image_hw
    hf = int(round((n * h / w) ** 0.5))
    wf = n // hf
    dev = prob_map.device
    cy = (torch.arange(hf, dtype=torch.float32, device=dev) + 0.5) * (h / hf)
    cx = (torch.arange(wf, dtype=torch.float32, device=dev) + 0.5) * (w / wf)
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    cxy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)     # [N, 2]
    inside = ((cxy[None, :, 0] >= gt_box[:, None, 0])
              & (cxy[None, :, 0] <= gt_box[:, None, 2])
              & (cxy[None, :, 1] >= gt_box[:, None, 1])
              & (cxy[None, :, 1] <= gt_box[:, None, 3]))        # [B, N]
    tgt = inside.to(torch.float32)
    n_inside = tgt.sum(dim=1, keepdim=True)
    box_c = (gt_box[:, None, :2] + gt_box[:, None, 2:]) / 2.0
    d2 = torch.sum((cxy[None] - box_c) ** 2, dim=-1)            # [B, N]
    onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1),
                                         n).to(torch.float32)
    tgt = torch.where(n_inside > 0, tgt / torch.clamp(n_inside, min=1.0),
                      onehot)
    ce = -torch.sum(tgt * torch.log(torch.clamp(prob_map, min=1e-9)), dim=1)
    if weights is not None:
        ce = ce * weights
    return _masked_mean(ce, valid)


def size_loss(outputs: dict, gt_bbox1: torch.Tensor, gt_bbox2: torch.Tensor,
              valid: torch.Tensor, image_hw1: tuple[int, int],
              image_hw2: tuple[int, int],
              weights: torch.Tensor | None = None) -> torch.Tensor:
    """L1 of the tlbr head (t, l, b, r, normalized) against the distances
    from the predicted centre (a constant for the gradient) to the
    ground-truth box's edges, clamped to [0, 1]; both images averaged."""
    def one_side(center, tlbr, gt, hw):
        h, w = hw
        c = center.detach()
        tgt = torch.stack([(c[:, 1] - gt[:, 1]) / h, (c[:, 0] - gt[:, 0]) / w,
                           (gt[:, 3] - c[:, 1]) / h, (gt[:, 2] - c[:, 0]) / w],
                          dim=-1)
        return torch.mean(torch.abs(tlbr - torch.clamp(tgt, 0.0, 1.0)),
                          dim=-1)

    per = (one_side(outputs["center1"], outputs["tlbr1"], gt_bbox1, image_hw1)
           + one_side(outputs["center2"], outputs["tlbr2"], gt_bbox2,
                      image_hw2)) / 2.0
    if weights is not None:
        per = per * weights
    return _masked_mean(per, valid)


def difficulty_weights(gt_bbox1: torch.Tensor, gt_bbox2: torch.Tensor,
                       image_hw1: tuple[int, int],
                       image_hw2: tuple[int, int],
                       power: float = 1.0) -> torch.Tensor:
    """Per-pair weights s**power, normalized to mean 1 over the batch, s =
    sqrt(max(a1, a2) / min(a1, a2)) with a the ground-truth box's share of
    its image (clamped to [1e-4, 1])."""
    def area_frac(box, hw):
        h, w = hw
        a = (torch.clamp(box[:, 2] - box[:, 0], min=0.0)
             * torch.clamp(box[:, 3] - box[:, 1], min=0.0))
        return torch.clamp(a / (h * w), 1e-4, 1.0)

    a1 = area_frac(gt_bbox1, image_hw1)
    a2 = area_frac(gt_bbox2, image_hw2)
    wgt = torch.sqrt(torch.maximum(a1, a2) / torch.minimum(a1, a2)) ** power
    mean = (torch.mean(wgt) if batch_shard() is None
            else global_count(wgt.sum()) / global_numel(wgt.numel()))
    return wgt / torch.clamp(mean, min=1e-6)
