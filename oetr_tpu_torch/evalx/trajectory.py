"""Trajectory metrics for reconstructed models: ATE and alignment (port
of ``oetr_tpu/evalx/trajectory.py``, an own copy of its numpy code).

The SLAM/SfM protocol: similarity-align the estimated camera centres to
ground truth (3-D Umeyama), report the RMSE of the residuals (absolute
trajectory error) and per-camera rotation errors.
"""
from __future__ import annotations

import numpy as np


def so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Rodrigues: [3] axis-angle -> [3, 3] rotation (numpy, host-side)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def camera_centers(cams6: np.ndarray) -> np.ndarray:
    """[C, 6] world->camera (so3, t) -> [C, 3] camera centers -R^T t."""
    out = np.zeros((len(cams6), 3))
    for i, c in enumerate(np.asarray(cams6)):
        R = so3_exp_np(c[:3])
        out[i] = -R.T @ c[3:]
    return out


def umeyama_3d(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity src -> dst (Umeyama 1991).

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float((D * np.diag(S)).sum() / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(est_cams6: np.ndarray, gt_cams6: np.ndarray,
                              align: bool = True) -> dict:
    """ATE between two [C, 6] (so3, t) world->camera trajectories.

    Similarity-aligns estimated camera centers to GT (SfM reconstructions
    are gauge-free: scale/rotation/translation are unobservable), then:
      ate_rmse / ate_mean: center residual stats (GT units);
      rot_err_deg: per-camera angular error after rotational alignment.
    """
    c_est = camera_centers(est_cams6)
    c_gt = camera_centers(gt_cams6)
    if align:
        s, R, t = umeyama_3d(c_est, c_gt)
        c_al = (s * (R @ c_est.T)).T + t
    else:
        R = np.eye(3)
        c_al = c_est
    res = np.linalg.norm(c_al - c_gt, axis=-1)

    # Rotation alignment via its own Procrustes (chordal mean): the
    # center-cloud Umeyama rotation is ill-conditioned for short or
    # near-collinear rigs and would dominate the rotation metric.
    Re_all = [so3_exp_np(e[:3]) for e in np.asarray(est_cams6)]
    Rg_all = [so3_exp_np(g[:3]) for g in np.asarray(gt_cams6)]
    if align:
        M = sum(Rg.T @ Re for Re, Rg in zip(Re_all, Rg_all))
        U, _, Vt = np.linalg.svd(M)
        S = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        A = (U @ S @ Vt).T    # argmin_A sum ||Re_i A - Rg_i||_F
    else:
        A = np.eye(3)
    rot = []
    for Re, Rg in zip(Re_all, Rg_all):
        cos = (np.trace((Re @ A) @ Rg.T) - 1) / 2
        rot.append(np.degrees(np.arccos(np.clip(cos, -1, 1))))

    return {
        "ate_rmse": float(np.sqrt((res ** 2).mean())),
        "ate_mean": float(res.mean()),
        "rot_err_deg": np.asarray(rot),
        "rot_err_mean_deg": float(np.mean(rot)),
    }
