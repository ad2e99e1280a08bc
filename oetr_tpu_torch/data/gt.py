"""Ground-truth overlap boxes on the host, in numpy (port of
``oetr_tpu/data/gt.py``, an own copy): the data loader's twin of
``geometry/overlap.py``, the same warp and conventions.

crop offsets are (row, col) of the crop in the resized image; ratio is
(ratio_y, ratio_x), resized over original.
"""
from __future__ import annotations

import numpy as np


def overlap_bbox_np(K1, depth1, pose1, crop1, ratio1, K2, depth2, pose2,
                    crop2, ratio2, occlusion_thresh: float = 0.5):
    """(box1 [4], mask1 [H, W], box2 [4], mask2 [H, W], valid): the pixels
    of depth1 that have depth, warp into image 2's crop (floor to a pixel
    inside it) and agree with depth2 there within ``occlusion_thresh``;
    the boxes bound them in each image (zero boxes and masks, valid False,
    where none does)."""
    v1, u1 = np.nonzero(depth1 > 0)
    Z1 = depth1[v1, u1]
    h2, w2 = depth2.shape

    x1 = (u1 + crop1[1] + 0.5) / ratio1[1]
    y1 = (v1 + crop1[0] + 0.5) / ratio1[0]
    X1 = (x1 - K1[0, 2]) * (Z1 / K1[0, 0])
    Y1 = (y1 - K1[1, 2]) * (Z1 / K1[1, 1])
    xyz1 = np.stack([X1, Y1, Z1, np.ones_like(Z1)], axis=0)

    T12 = pose2 @ np.linalg.inv(pose1)
    xyz2 = T12 @ xyz1
    xyz2 = xyz2[:3] / xyz2[3:]
    uv2 = K2 @ xyz2
    uv2 = uv2[:2] / uv2[2:]
    u2 = uv2[0] * ratio2[1] - crop2[1] - 0.5
    v2 = uv2[1] * ratio2[0] - crop2[0] - 0.5

    i2 = np.floor(u2).astype(int)
    j2 = np.floor(v2).astype(int)
    valid = (i2 >= 0) & (j2 >= 0) & (i2 < w2) & (j2 < h2)

    vu1 = np.stack([u1[valid], v1[valid]])
    vi2 = i2[valid]
    vj2 = j2[valid]
    Z2 = depth2[vj2, vi2]
    inlier = np.abs(xyz2[2][valid] - Z2) < occlusion_thresh
    vu1 = vu1[:, inlier]
    vi2 = vi2[inlier]
    vj2 = vj2[inlier]

    h1, w1 = depth1.shape
    if vu1.shape[1] == 0:
        return (np.zeros(4), np.zeros((h1, w1)), np.zeros(4),
                np.zeros((h2, w2)), False)
    box1 = np.array([vu1[0].min(), vu1[1].min(), vu1[0].max(), vu1[1].max()],
                    dtype=float)
    box2 = np.array([vi2.min(), vj2.min(), vi2.max(), vj2.max()], dtype=float)
    mask1 = np.zeros((h1, w1))
    mask1[vu1[1], vu1[0]] = 1
    mask2 = np.zeros((h2, w2))
    mask2[vj2, vi2] = 1
    return box1, mask1, box2, mask2, True
