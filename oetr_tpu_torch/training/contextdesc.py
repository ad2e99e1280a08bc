"""ContextDesc training (port of ``oetr_tpu/training/contextdesc.py``).

Two losses on homography pairs of SIFT keypoints:
  * InfoNCE over the GT correspondences: the augmented descriptor of a
    matched image-0 keypoint must retrieve its counterpart among all
    image-1 keypoints (temperature-scaled softmax cross-entropy);
  * matchability BCE: the matchability head predicts whether a keypoint
    has a counterpart at all.

GT rides as ``gt_matches0`` [B, K] (-1 for none), SuperGlue's convention.
The step calls the network itself, with grad; ``contextdesc_extract``
runs it under ``torch.no_grad``. ``contextdesc_pairs_batch`` is host numpy
and imports cv2 where it is called.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .optim import apply_update


def contextdesc_info_nce(desc0: torch.Tensor, desc1: torch.Tensor,
                         gt_matches0: torch.Tensor, valid1: torch.Tensor,
                         temp: float = 0.07) -> torch.Tensor:
    """Mean cross-entropy of each matched keypoint retrieving its
    counterpart. desc0, desc1 [B, K, D] unit descriptors; gt_matches0
    [B, K] (-1 excluded); valid1 masks the candidates."""
    sim = torch.einsum("bkd,bnd->bkn", desc0, desc1) / temp
    sim = torch.where(valid1[:, None, :], sim, -1e9)
    logp = F.log_softmax(sim, dim=-1)
    gt = gt_matches0.long()
    tgt = torch.clamp(gt, min=0)
    ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
    has = gt >= 0
    return -torch.where(has, ll, 0.0).sum() / torch.clamp(
        has.sum().float(), min=1.0)


def matchability_bce(matchability: torch.Tensor, gt_matches0: torch.Tensor,
                     valid0: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of the matchability head against "has a GT
    counterpart", over the valid keypoints."""
    y = (gt_matches0 >= 0).float()
    p = torch.clamp(matchability, 1e-6, 1.0 - 1e-6)
    bce = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
    return torch.where(valid0, bce, 0.0).sum() / torch.clamp(
        valid0.sum().float(), min=1.0)


def make_contextdesc_train_step(net, optimizer, w_match: float = 0.5,
                                scheduler=None,
                                clip_norm: float | None = None):
    """``step(batch) -> {"loss", "nce", "match_bce"}`` over batches of
    ``contextdesc_pairs_batch``'s keys as tensors: image0/1 [B, H, W, 1],
    desc0/1 [B, K, 128] RootSIFT, xy0/1 [B, K, 2], scores0/1 [B, K],
    valid0/1 [B, K], gt_matches0 [B, K]. ``net`` is a ``ContextDesc``."""
    def step(batch: dict):
        optimizer.zero_grad(set_to_none=True)
        a0, m0 = net(batch["image0"], batch["desc0"], batch["xy0"],
                     batch["scores0"], batch["valid0"])
        a1, _ = net(batch["image1"], batch["desc1"], batch["xy1"],
                    batch["scores1"], batch["valid1"])
        nce = contextdesc_info_nce(a0, a1, batch["gt_matches0"],
                                   batch["valid1"])
        mbce = matchability_bce(m0, batch["gt_matches0"], batch["valid0"])
        loss = nce + w_match * mbce
        loss.backward()
        apply_update(net.parameters(), optimizer, scheduler, clip_norm)
        return {"loss": loss.detach(), "nce": nce.detach(),
                "match_bce": mbce.detach()}

    return step


def homography_gt_matches(xy0: np.ndarray, v0: np.ndarray, xy1: np.ndarray,
                          v1: np.ndarray, H: np.ndarray,
                          match_radius: float = 3.0) -> np.ndarray:
    """GT matches [K] int32 of one pair under the exact homography H
    (image 0 -> image 1): mutual nearest neighbours of the warped image-0
    keypoints among the image-1 keypoints within ``match_radius`` px,
    invalid keypoints on either side excluded."""
    k = xy0.shape[0]
    pts = np.concatenate([xy0, np.ones((k, 1), np.float32)], -1)
    w = (H @ pts.T).T
    w = w[:, :2] / np.where(np.abs(w[:, 2:]) > 1e-12, w[:, 2:], 1e-12)
    dist = np.linalg.norm(w[:, None] - xy1[None], axis=-1)
    dist[~v0] = 1e9
    dist[:, ~v1] = 1e9
    nn1 = dist.argmin(1)
    best = dist[np.arange(k), nn1]
    nn0 = dist.argmin(0)
    mutual = nn0[nn1] == np.arange(k)
    return np.where((best < match_radius) & mutual, nn1, -1).astype(np.int32)


def contextdesc_pairs_batch(rng: np.random.Generator, b: int, hw: int = 128,
                            topk: int = 128, match_radius: float = 3.0,
                            **h_kwargs) -> dict:
    """Homography pairs of SIFT keypoints with GT correspondences, numpy:
    textures from ``data/synthetic._texture``, homographies from
    ``training/superpoint.random_homography``, GT from
    ``homography_gt_matches``. Host side; needs cv2."""
    import cv2

    from ..data.synthetic import _texture
    from ..models.sift_based import sift_keypoints
    from .superpoint import random_homography

    out = {k: [] for k in ("image0", "image1", "desc0", "desc1", "xy0",
                           "xy1", "scores0", "scores1", "valid0", "valid1",
                           "gt_matches0")}
    for _ in range(b):
        tex = _texture(rng, hw, hw)
        g0 = cv2.cvtColor(tex, cv2.COLOR_RGB2GRAY)
        H = random_homography(rng, (hw, hw), **h_kwargs)
        g1 = cv2.warpPerspective(g0, H, (hw, hw), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=0)
        xy0, s0, v0, d0 = sift_keypoints(g0, topk, with_descriptors=True)
        xy1, s1, v1, d1 = sift_keypoints(g1, topk, with_descriptors=True)
        out["image0"].append(g0[..., None].astype(np.float32) / 255.0)
        out["image1"].append(g1[..., None].astype(np.float32) / 255.0)
        out["desc0"].append(d0)
        out["desc1"].append(d1)
        out["xy0"].append(xy0)
        out["xy1"].append(xy1)
        out["scores0"].append(s0)
        out["scores1"].append(s1)
        out["valid0"].append(v0)
        out["valid1"].append(v1)
        out["gt_matches0"].append(homography_gt_matches(
            xy0, v0, xy1, v1, H, match_radius))
    return {k: np.stack(v) for k, v in out.items()}
