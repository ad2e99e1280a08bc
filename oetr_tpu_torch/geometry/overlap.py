"""Co-visible overlap boxes through depth warping (port of
``oetr_tpu/geometry/overlap.py``).

Every pixel of image 1 is back-projected with its depth, moved into camera
2 and projected into image 2's crop frame; a pixel survives where it has
depth, lands inside image 2 and agrees with image 2's depth map to within
the occlusion threshold. The boxes are [min_x, min_y, max_x, max_y] over
the survivors, as integer pixels in float32 (all zero, and ``valid``
False, where none survives).

Conventions (the reference's): ``crop`` offsets are (row, col) of the crop
in the resized image, ``ratio`` is (ratio_y, ratio_x), resized over
original, and an original-frame pixel is (crop_pixel + crop_offset + 0.5)
/ ratio. The in-bounds check is x < w, y < h (the reference swaps them, a
no-op for its square crops).

Every function takes any number of leading batch dimensions: K [..., 3,
3], poses [..., 4, 4], depth [..., H, W], crop and ratio [..., 2].
"""
from __future__ import annotations

import torch


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 4, 4] rigid transforms: (Rᵀ, -Rᵀt)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _at(v: torch.Tensor, i: int) -> torch.Tensor:
    """Component i of [..., n] as [..., 1, 1], to broadcast over a grid."""
    return v[..., i, None, None]


def warp_grid_via_depth(K1, depth1, T1, crop1, ratio1, K2, T2, crop2,
                        ratio2):
    """Warp every pixel of image 1 into image 2's crop frame.

    Returns (uv2 [..., H, W, 2] (x, y) in image 2's crop frame, z2
    [..., H, W] the depth in camera 2, has_depth [..., H, W] bool)."""
    h, w = depth1.shape[-2:]
    dev = depth1.device
    v1 = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    u1 = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    z1 = depth1
    has_depth = z1 > 0

    # Crop frame -> original frame, then back-project.
    x1 = (u1 + _at(crop1, 1) + 0.5) / _at(ratio1, 1)
    y1 = (v1 + _at(crop1, 0) + 0.5) / _at(ratio1, 0)
    X1 = (x1 - K1[..., 0, 2, None, None]) * (z1 / K1[..., 0, 0, None, None])
    Y1 = (y1 - K1[..., 1, 2, None, None]) * (z1 / K1[..., 1, 1, None, None])
    xyz1 = torch.stack([X1, Y1, z1], dim=-1)                   # [..., H, W, 3]

    T12 = T2 @ rigid_inverse(T1)
    xyz2 = (xyz1 @ T12[..., None, :3, :3].transpose(-1, -2)
            + T12[..., None, None, :3, 3])
    uv2 = xyz2 @ K2[..., None, :, :].transpose(-1, -2)
    zc = uv2[..., 2:3]
    uv2 = uv2[..., :2] / torch.where(zc.abs() > 1e-12, zc,
                                     torch.full_like(zc, 1e-12))
    # Original frame -> image 2's crop frame.
    u2 = uv2[..., 0] * _at(ratio2, 1) - _at(crop2, 1) - 0.5
    v2 = uv2[..., 1] * _at(ratio2, 0) - _at(crop2, 0) - 0.5
    return torch.stack([u2, v2], dim=-1), xyz2[..., 2], has_depth


def _masked_box(us, vs, m):
    """[..., 4] float32 [min u, min v, max u, max v] over m [..., H, W]."""
    big = 1 << 30
    flat = lambda t: t.flatten(-2)
    m = flat(m)
    lo = lambda t: torch.where(m, flat(t), big).amin(dim=-1)
    hi = lambda t: torch.where(m, flat(t), -big).amax(dim=-1)
    return torch.stack([lo(us), lo(vs), hi(us), hi(vs)], dim=-1).float()


def overlap_bbox(K1, depth1, T1, crop1, ratio1, K2, depth2, T2, crop2,
                 ratio2, occlusion_thresh: float = 0.5):
    """Co-visible boxes and masks of image pairs.

    Returns box1 [..., 4], mask1 [..., H, W] float32, box2 [..., 4], mask2
    [..., H2, W2] float32 (the image-2 pixels some survivor lands on) and
    valid [...] bool.
    """
    h2, w2 = depth2.shape[-2:]
    uv2, z2_est, has_depth = warp_grid_via_depth(
        K1, depth1, T1, crop1, ratio1, K2, T2, crop2, ratio2)

    # Integer pixels of image 2 (floor; negatives fail the bounds check).
    i2 = torch.floor(uv2[..., 0]).to(torch.int32)
    j2 = torch.floor(uv2[..., 1]).to(torch.int32)
    in_bounds = (i2 >= 0) & (j2 >= 0) & (i2 < w2) & (j2 < h2)
    i2c = i2.clamp(0, w2 - 1).long()
    j2c = j2.clamp(0, h2 - 1).long()
    flat_idx = (j2c * w2 + i2c).flatten(-2)
    z2 = torch.gather(depth2.flatten(-2), -1, flat_idx).view_as(z2_est)
    valid_pix = has_depth & in_bounds & ((z2_est - z2).abs()
                                         < occlusion_thresh)
    any_valid = valid_pix.flatten(-2).any(dim=-1)

    h1, w1 = depth1.shape[-2:]
    dev = depth1.device
    rows = torch.arange(h1, dtype=torch.int32, device=dev)
    cols = torch.arange(w1, dtype=torch.int32, device=dev)
    v1, u1 = torch.meshgrid(rows, cols, indexing="ij")
    keep = any_valid[..., None]
    box1 = torch.where(keep, _masked_box(u1, v1, valid_pix), 0.0)
    box2 = torch.where(keep, _masked_box(i2c, j2c, valid_pix), 0.0)

    mask1 = valid_pix.float()
    # The survivors' landing pixels: a scatter-max of 0/1 into zeros.
    mask2 = torch.zeros(valid_pix.shape[:-2] + (h2 * w2,), dtype=torch.float32,
                        device=dev)
    mask2.scatter_reduce_(-1, flat_idx, mask1.flatten(-2), reduce="amax")
    return box1, mask1, box2, mask2.view(valid_pix.shape[:-2] + (h2, w2)), \
        any_valid


def overlap_bbox_pair(K1, depth1, T1, crop1, ratio1, K2, depth2, T2, crop2,
                      ratio2, occlusion_thresh: float = 0.5):
    """The ground-truth boxes of image pairs from the 1 -> 2 warp (the
    datasets' convention): (box1, mask1, box2, mask2, valid), as
    ``overlap_bbox``."""
    return overlap_bbox(K1, depth1, T1, crop1, ratio1, K2, depth2, T2,
                        crop2, ratio2, occlusion_thresh)
