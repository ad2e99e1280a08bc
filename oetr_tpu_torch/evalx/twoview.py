"""Per-pair two-view evaluation (port of ``oetr_tpu/evalx/twoview.py``):
the reference's validation_error.

Precision (symmetric epipolar error < 5e-4), matching score, and the
angular pose errors of the batched estimator (``geometry.estimate_pose``
with its host 5-point stage, as JAX passes ``use_5pt=True``), including
OETR's crop-intrinsics correction. JAX pins its estimator to the CPU,
where its host callback can run; the port runs it on the card by default
(``device``), its 5-point samples solved on the host in one round trip.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.epipolar import pose_error as pose_error_fn
from ..geometry.ransac import estimate_pose

EPI_THRESH = 5e-4      # the reference's precision threshold


def correct_intrinsics(K: np.ndarray, inparams: np.ndarray) -> np.ndarray:
    """Adjust K for the crop/resize chain recorded in ``inparams``
    (sx, sy, tx, ty, rx, ry)."""
    sx, sy, tx, ty, rx, ry = inparams
    K_nto = np.array([[sx / rx, 0, sx * tx], [0, sy / ry, sy * ty],
                      [0, 0, 1.0]])
    K_inv = np.linalg.inv(K) @ K_nto
    return np.linalg.inv(K_inv)


def _pad_pow2(a: np.ndarray, min_n: int = 64):
    n = len(a)
    pad = max(min_n, int(2 ** np.ceil(np.log2(max(n, 1)))))
    out = np.zeros((pad,) + a.shape[1:], a.dtype)
    out[:n] = a
    valid = np.zeros(pad, bool)
    valid[:n] = True
    return out, valid


def _symmetric_epipolar_np(mk0: np.ndarray, mk1: np.ndarray,
                           T_0to1: np.ndarray, K0: np.ndarray,
                           K1: np.ndarray) -> np.ndarray:
    """Float64 replica of the reference's compute_epipolar_error, with its
    normalizer ``1/(Ep0_x + Ep0_y) + 1/(Etp1_x + Etp1_y)`` (no squares),
    which the precision metric thresholds at 5e-4."""
    p0 = np.concatenate([(mk0 - K0[[0, 1], [2, 2]]) / K0[[0, 1], [0, 1]],
                         np.ones((len(mk0), 1))], axis=1)
    p1 = np.concatenate([(mk1 - K1[[0, 1], [2, 2]]) / K1[[0, 1], [0, 1]],
                         np.ones((len(mk1), 1))], axis=1)
    t0, t1, t2 = T_0to1[:3, 3]
    t_skew = np.array([[0, -t2, t1], [t2, 0, -t0], [-t1, t0, 0.0]])
    E = t_skew @ T_0to1[:3, :3]
    Ep0 = p0 @ E.T
    p1Ep0 = np.sum(p1 * Ep0, axis=-1)
    Etp1 = p1 @ E
    return p1Ep0 ** 2 * (1.0 / (Ep0[:, 0] + Ep0[:, 1])
                         + 1.0 / (Etp1[:, 0] + Etp1[:, 1]))


def validation_error(kpts0: np.ndarray, kpts1: np.ndarray,
                     matches: np.ndarray, K0: np.ndarray, K1: np.ndarray,
                     T_0to1: np.ndarray,
                     inparams0: np.ndarray | None = None,
                     inparams1: np.ndarray | None = None,
                     thresh_px: float = 1.0, rng_seed: int = 0,
                     num_hypotheses: int = 512,
                     lo_candidates: int = 8, device="cuda") -> dict:
    """One pair's metrics.

    Args:
      kpts0/kpts1: [N0/N1, 2]; matches: [2, M] index pairs.
      rng_seed: seeds the ``torch.Generator`` of the estimator's draws.
      device: where the estimator runs (the card unless the caller asks
        for the CPU).
    Returns dict: error_t, error_R, precision, matching_score,
    num_correct, epipolar_errors, inliers.
    """
    if inparams0 is not None:
        K0 = correct_intrinsics(K0, np.asarray(inparams0).reshape(-1))
    if inparams1 is not None:
        K1 = correct_intrinsics(K1, np.asarray(inparams1).reshape(-1))

    mk0 = kpts0[matches[0]][:, :2].astype(np.float64)
    mk1 = kpts1[matches[1]][:, :2].astype(np.float64)

    if len(mk0) == 0:
        return {"error_t": np.inf, "error_R": np.inf, "precision": 0.0,
                "matching_score": 0.0, "num_correct": 0,
                "epipolar_errors": np.array([]), "inliers": np.array([])}

    # float64 numpy on the host: float32 loses precision right at the 5e-4
    # threshold.
    epi = _symmetric_epipolar_np(mk0, mk1, np.asarray(T_0to1, np.float64),
                                 np.asarray(K0, np.float64),
                                 np.asarray(K1, np.float64))
    correct = epi < EPI_THRESH
    num_correct = int(correct.sum())
    precision = float(correct.mean()) if len(correct) else 0.0
    matching_score = num_correct / len(kpts0) if len(kpts0) else 0.0

    if len(mk0) < 5:
        err_t = err_R = np.inf
        inliers = np.zeros(len(mk0), bool)
    else:
        p0, valid = _pad_pow2(mk0.astype(np.float32))
        p1, _ = _pad_pow2(mk1.astype(np.float32))
        dev = torch.device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        res = estimate_pose(f32(p0), f32(p1), torch.as_tensor(valid,
                                                              device=dev),
                            f32(K0), f32(K1),
                            torch.Generator(device=dev).manual_seed(rng_seed),
                            thresh_px=thresh_px,
                            num_hypotheses=num_hypotheses,
                            lo_candidates=lo_candidates, use_5pt=True)
        if bool(res["ok"]):
            et, eR = pose_error_fn(f32(T_0to1), res["R"], res["t"])
            err_t, err_R = float(et), float(eR)
            inliers = res["inliers"].cpu().numpy()[:len(mk0)]
        else:
            err_t = err_R = np.inf
            inliers = np.zeros(len(mk0), bool)

    return {
        "error_t": err_t, "error_R": err_R, "precision": precision,
        "matching_score": matching_score, "num_correct": num_correct,
        "epipolar_errors": epi, "inliers": inliers,
    }
