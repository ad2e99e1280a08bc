"""Two-view epipolar geometry (port of ``oetr_tpu/geometry/epipolar.py``).

The reference's numpy/OpenCV helpers as batched torch functions: every
function takes any number of leading batch dimensions.
"""
from __future__ import annotations

import math

import torch


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """[..., N, d] -> [..., N, d+1] by appending ones."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def _center_focal(K: torch.Tensor):
    center = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    focal = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    return center[..., None, :], focal[..., None, :]


def normalize_keypoints(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel keypoints [..., N, 2] -> normalized camera coordinates:
    (kpts - (cx, cy)) / (fx, fy), with K [..., 3, 3]."""
    center, focal = _center_focal(K)
    return (kpts - center) / focal


def unnormalize_keypoints(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`normalize_keypoints`."""
    center, focal = _center_focal(K)
    return kpts * focal + center


def skew(t: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [t]_x [..., 3, 3] of [..., 3] vectors:
    [[0, -t2, t1], [t2, 0, -t0], [-t1, t0, 0]]."""
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    z = torch.zeros_like(t0)
    rows = [torch.stack([z, -t2, t1], dim=-1),
            torch.stack([t2, z, -t0], dim=-1),
            torch.stack([-t1, t0, z], dim=-1)]
    return torch.stack(rows, dim=-2)


def essential_from_pose(T_0to1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R from [..., 4, 4] relative poses."""
    return skew(T_0to1[..., :3, 3]) @ T_0to1[..., :3, :3]


def symmetric_epipolar_error(kpts0, kpts1, T_0to1, K0, K1) -> torch.Tensor:
    """Squared symmetric epipolar distance per correspondence [..., N],
    with the reference's normalizer ``1/(Ep0_x + Ep0_y) + 1/(Etp1_x +
    Etp1_y)`` (no squares), which its precision metric thresholds."""
    k0 = to_homogeneous(normalize_keypoints(kpts0, K0))
    k1 = to_homogeneous(normalize_keypoints(kpts1, K1))
    E = essential_from_pose(T_0to1)
    Ep0 = k0 @ E.transpose(-1, -2)
    p1Ep0 = torch.sum(k1 * Ep0, dim=-1)
    Etp1 = k1 @ E
    return p1Ep0 ** 2 * (1.0 / (Ep0[..., 0] + Ep0[..., 1])
                         + 1.0 / (Etp1[..., 0] + Etp1[..., 1]))


def sampson_error(kpts0: torch.Tensor, kpts1: torch.Tensor,
                  E: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance [..., N] of normalized correspondences
    [..., N, 2] under E [..., 3, 3]."""
    k0 = to_homogeneous(kpts0)
    k1 = to_homogeneous(kpts1)
    Ep0 = k0 @ E.transpose(-1, -2)
    Etp1 = k1 @ E
    p1Ep0 = torch.sum(k1 * Ep0, dim=-1)
    denom = (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2
             + Etp1[..., 1] ** 2)
    return p1Ep0 ** 2 / torch.clamp(denom, min=1e-12)


def angle_error_mat(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between rotations [..., 3, 3]."""
    prod = R1.transpose(-1, -2) @ R2
    cos = (prod.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    cos = torch.clamp(cos, -1.0, 1.0)
    return torch.abs(torch.arccos(cos)) * (180.0 / math.pi)


def angle_error_vec(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between vectors [..., 3]."""
    n = torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)
    cos = torch.sum(v1 * v2, dim=-1) / torch.clamp(n, min=1e-15)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0)) * (180.0 / math.pi)


def pose_error(T_0to1: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """(error_t, error_R) in degrees against the ground-truth relative pose,
    the translation's sign ambiguity folded by min(err, 180 - err)."""
    R_gt = T_0to1[..., :3, :3]
    t_gt = T_0to1[..., :3, 3]
    error_t = angle_error_vec(t, t_gt)
    error_t = torch.minimum(error_t, 180.0 - error_t)
    error_R = angle_error_mat(R, R_gt)
    return error_t, error_R


def project_points(xyz: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points [..., N, 3] to pixels [..., N, 2]."""
    uv = xyz @ K.transpose(-1, -2)
    return uv[..., :2] / torch.clamp(uv[..., 2:3], min=1e-12)


def transform_points(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] rigid transforms to [..., N, 3] points."""
    return xyz @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
