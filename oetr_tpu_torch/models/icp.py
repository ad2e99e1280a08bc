"""Contour ICP matcher (port of ``oetr_tpu/models/icp.py``): foreground
contours (cv2), then nearest-neighbour association and a trimmed Umeyama
similarity per iteration until the error settles.

Host only: cv2 and scipy are imported inside the functions, which raise
ImportError where they are missing. The similarity fits run in float32
through the port's ``geometry/homography.py``, as JAX's do through its.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.homography import apply_homography, similarity_umeyama


def foreground_mask(image_u8: np.ndarray, min_area: float = 20000.0,
                    connectivity: int = 4) -> np.ndarray:
    """Binary foreground mask: Otsu threshold, components of at least
    ``min_area`` pixels kept."""
    import cv2

    gray = (cv2.cvtColor(image_u8, cv2.COLOR_BGR2GRAY)
            if image_u8.ndim == 3 else image_u8)
    _, mask = cv2.threshold(gray, 0, 255,
                            cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(
        mask, connectivity=connectivity)
    keep = np.zeros_like(mask)
    for i in range(1, n):
        if stats[i, cv2.CC_STAT_AREA] >= min_area:
            keep[labels == i] = 255
    return keep


def contour_points(mask: np.ndarray, max_points: int = 2048) -> np.ndarray:
    """The outer contours' points [N, 2] (x, y) float32, subsampled evenly
    to at most ``max_points``."""
    import cv2

    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
    if not contours:
        return np.zeros((0, 2), np.float32)
    pts = np.concatenate([c.reshape(-1, 2) for c in contours]).astype(
        np.float32)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    return pts


def icp_register(pts0: np.ndarray, pts1: np.ndarray, iters: int = 20,
                 threshold_px: float = 20.0, rng_seed: int = 0) -> dict:
    """ICP with a trimmed similarity refit per iteration: T [3, 3] mapping
    pts0 onto pts1, rmse (the last mean kept distance) and converged."""
    if len(pts0) < 2 or len(pts1) < 2:
        return {"T": np.eye(3), "rmse": np.inf, "converged": False}
    from scipy.spatial import cKDTree

    T = np.eye(3)
    cur = pts0.copy()
    prev_err = np.inf
    tree = cKDTree(pts1)
    for _ in range(iters):
        dist, idx = tree.query(cur)
        tgt = pts1[idx]
        # Keep associations within 3x the median distance (and the hard
        # threshold), then the closed-form similarity on them.
        med = np.median(dist) if len(dist) else 0.0
        keep = (dist <= max(3.0 * med, 1e-6)) & (dist <= threshold_px * 3)
        if keep.sum() < 2:
            break
        dT = similarity_umeyama(
            torch.from_numpy(cur.astype(np.float32)),
            torch.from_numpy(tgt.astype(np.float32)),
            torch.from_numpy(keep.astype(np.float32))).numpy()
        cur = apply_homography(torch.from_numpy(dT),
                               torch.from_numpy(cur)).numpy()
        T = dT @ T
        err = float(np.mean(dist[keep]))
        if abs(prev_err - err) < 1e-3:
            prev_err = err
            break
        prev_err = err
    return {"T": T, "rmse": prev_err, "converged": np.isfinite(prev_err)}


def icp_match(image0_u8: np.ndarray, image1_u8: np.ndarray,
              min_area: float = 20000.0) -> dict:
    """Contours of both images' foregrounds, then ICP: T_0to1 [3, 3] (as
    ``T``), rmse, converged and the two contour point sets."""
    c0 = contour_points(foreground_mask(image0_u8, min_area))
    c1 = contour_points(foreground_mask(image1_u8, min_area))
    out = icp_register(c0, c1)
    out["contours0"] = c0
    out["contours1"] = c1
    return out
