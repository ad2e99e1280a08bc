"""IMC-protocol metric math (port of ``oetr_tpu/evalx/imc_math.py``, an
own copy of its numpy code).

Quaternion-based R/t angular errors, essential-matrix evaluation (with the
port's ``recover_pose`` in float64 on the CPU, where the reference calls
cv2.recoverPose), depth-based keypoint projection, repeatability, and the
symmetric epipolar distance of the IMC matching score. Host-side numpy:
these run per pair on scalar-sized data.
"""
from __future__ import annotations

import numpy as np
import torch


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP (w, x, y, z) quaternion (an own copy of
    ``oetr_tpu/sfm/colmap_model.py::rotmat2qvec``)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def evaluate_R_t(R_gt, t_gt, R, t):
    """Quaternion/vector angular errors in radians."""
    eps = 1e-15
    t = np.asarray(t).flatten()
    t_gt = np.asarray(t_gt).flatten()
    q = rotmat2qvec(np.asarray(R))
    q_gt = rotmat2qvec(np.asarray(R_gt))
    q = q / (np.linalg.norm(q) + eps)
    q_gt = q_gt / (np.linalg.norm(q_gt) + eps)
    loss_q = np.maximum(eps, 1.0 - np.sum(q * q_gt) ** 2)
    err_q = np.arccos(1 - 2 * loss_q)

    t = t / (np.linalg.norm(t) + eps)
    t_gt = t_gt / (np.linalg.norm(t_gt) + eps)
    loss_t = np.maximum(eps, 1.0 - np.sum(t * t_gt) ** 2)
    err_t = np.arccos(np.sqrt(1 - loss_t))
    return float(err_q), float(err_t)


def eval_essential_matrix(p1n, p2n, E, dR, dt):
    """(err_q, err_t) radians from an E matrix and normalized
    correspondences; failure -> (pi, pi/2). The pose comes from the port's
    ``recover_pose`` in float64 on the CPU."""
    from ..geometry.ransac import recover_pose

    if len(p1n) != len(p2n):
        raise RuntimeError("Size mismatch in the keypoint lists")
    if p1n.shape[0] < 5 or E is None or np.size(E) == 0:
        return np.pi, np.pi / 2
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    res = recover_pose(f64(E), f64(p1n), f64(p2n),
                       torch.ones(len(p1n), dtype=torch.bool))
    return evaluate_R_t(dR, dt, res["R"].numpy(), res["t"].numpy())


def get_projected_kp(x1, x2, d1, d2, dR, dT):
    """Depth-project normalized keypoints into the other view."""
    y1 = np.concatenate([x1 * d1, d1], axis=1)
    y2 = np.concatenate([x2 * d2, d2], axis=1)
    dT = np.asarray(dT).reshape(3, 1)
    y1p = np.matmul(dR[None], y1[..., None]) + dT[None]
    y2p = (np.matmul(np.transpose(dR)[None], y2[..., None])
           - np.matmul(np.transpose(dR), dT)[None])
    x1p = np.squeeze(y1p[:, 0:2] / y1p[:, [2]], axis=-1)
    x2p = np.squeeze(y2p[:, 0:2] / y2p[:, [2]], axis=-1)
    return x1p, x2p


def get_repeatability(kp1n_p, kp2n, th_list):
    """Fraction of projected keypoints with a neighbor within each
    threshold."""
    if np.ndim(th_list) == 0:
        th_list = [th_list]
    if kp1n_p.shape[0] == 0 or kp2n.shape[0] == 0:
        return [0] * len(th_list)
    from scipy.spatial import distance
    dis = distance.cdist(kp1n_p, kp2n, metric="sqeuclidean")
    min_d = np.amin(dis, 1)
    return [float((min_d < th * th).sum() / kp1n_p.shape[0])
            for th in th_list]


def get_episym(x1n, x2n, dR, dt):
    """Symmetric epipolar distance for normalized coords under (R, t)."""
    if x1n.ndim == 1:
        x1n = x1n[None]
        x2n = x2n[None]
    n = len(x1n)
    x1h = np.concatenate([x1n, np.ones((n, 1))], axis=1)
    x2h = np.concatenate([x2n, np.ones((n, 1))], axis=1)
    dt = np.asarray(dt).flatten()
    t_skew = np.array([[0, -dt[2], dt[1]], [dt[2], 0, -dt[0]],
                       [-dt[1], dt[0], 0]])
    E = t_skew @ dR
    Ex1 = x1h @ E.T
    Etx2 = x2h @ E
    x2tEx1 = np.sum(x2h * Ex1, axis=1)
    return x2tEx1 ** 2 * (
        1.0 / np.maximum(Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2, 1e-15)
        + 1.0 / np.maximum(Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2, 1e-15))


def eval_match_score(x1n, x2n, x1p, x2p, dR, dt, epi_thresh: float = 1e-4,
                     dist_thresh: float = 4e-3):
    """IMC matching score: matches consistent with both the epipolar
    geometry (geod_d from get_episym) and the depth reprojection (true_d,
    the projected keypoints' distance).

    Returns (geod_d [N], true_d [N], correct_mask [N]).
    """
    geod = get_episym(x1n, x2n, dR, dt)
    d1 = np.linalg.norm(x1p - x2n, axis=1)
    d2 = np.linalg.norm(x2p - x1n, axis=1)
    true_d = (d1 + d2) / 2
    correct = (geod < epi_thresh) & (true_d < dist_thresh)
    return geod, true_d, correct
