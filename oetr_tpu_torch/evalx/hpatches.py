"""HPatches homography benchmark (port of ``oetr_tpu/evalx/hpatches.py``,
an own copy of its numpy code).

Mean matching accuracy (MMA) at pixel thresholds 1..15 under the
ground-truth homographies, split into illumination ('i*') and viewpoint
('v*') sequences, as the reference's eval_hpatches computes it.
"""
from __future__ import annotations

import numpy as np

THRESHOLDS = np.arange(1, 16)


def h_evaluate(H: np.ndarray, kpts0: np.ndarray, kpts1: np.ndarray,
               matches: np.ndarray) -> np.ndarray:
    """Reprojection distances of matched keypoints under GT homography.

    matches: [M, 2]. In float64 numpy: float32 loses ~0.05 px near the
    MMA@1 threshold (``geometry.homography.apply_homography`` is the
    batched device version).
    """
    pos_a = np.asarray(kpts0, np.float64)[matches[:, 0], :2]
    H = np.asarray(H, np.float64)
    denom = pos_a @ H[2, :2] + H[2, 2]
    proj = (pos_a @ H[:2, :2].T + H[:2, 2]) / denom[:, None]
    pos_b = np.asarray(kpts1, np.float64)[matches[:, 1], :2]
    return np.sqrt(np.sum((pos_b - proj) ** 2, axis=1))


def accumulate_pair(acc_i: dict, acc_v: dict, seq_name: str, dist: np.ndarray):
    """One pair's contribution."""
    if dist.shape[0] == 0:
        dist = np.array([np.inf])
    target = acc_i if seq_name.startswith("i") else acc_v
    for thr in THRESHOLDS:
        target[thr] = target.get(thr, 0.0) + float(np.mean(dist <= thr))


def mma_table(acc_i: dict, acc_v: dict, n_i: int, n_v: int) -> dict:
    """MMA per threshold + overall/illum/viewpoint summary."""
    out = {"illumination": {}, "viewpoint": {}, "overall": {}}
    for thr in THRESHOLDS:
        i = acc_i.get(thr, 0.0) / max(n_i, 1)
        v = acc_v.get(thr, 0.0) / max(n_v, 1)
        out["illumination"][int(thr)] = i
        out["viewpoint"][int(thr)] = v
        out["overall"][int(thr)] = ((acc_i.get(thr, 0.0) + acc_v.get(thr, 0.0))
                                    / max(n_i + n_v, 1))
    return out


def benchmark_results(pairs: list[dict]) -> dict:
    """Evaluate a list of {'seq_name', 'H_gt', 'kpts0', 'kpts1', 'matches'}
    records (host-loaded; matches [M, 2])."""
    acc_i: dict = {}
    acc_v: dict = {}
    n_i = n_v = 0
    for rec in pairs:
        dist = h_evaluate(rec["H_gt"], rec["kpts0"], rec["kpts1"],
                          rec["matches"])
        accumulate_pair(acc_i, acc_v, rec["seq_name"], dist)
        if rec["seq_name"].startswith("i"):
            n_i += 1
        else:
            n_v += 1
    return mma_table(acc_i, acc_v, n_i, n_v)
