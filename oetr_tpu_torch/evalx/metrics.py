"""Aggregate benchmark metrics (port of ``oetr_tpu/evalx/metrics.py``,
an own copy of its numpy code).

Pose AUC, accuracy and mAA of the reference's evaluation utilities, and the
IoU recalls of its training-time validation. They run once per benchmark
over a few thousand scalars, so they stay numpy on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pose_auc(errors: Sequence[float], thresholds: Sequence[float]) -> list[float]:
    """Trapezoid AUC of recall vs angular-error curve at each threshold.

    """
    errors = np.asarray(list(errors), dtype=np.float64)
    sort_idx = np.argsort(errors)
    errors = errors[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs


def pose_acc(errors: Sequence[float], thresholds: Sequence[float]) -> list[float]:
    """Fraction of errors below each threshold."""
    errors = np.asarray(list(errors), dtype=np.float64)
    return [float((errors < t).sum() / len(errors)) for t in thresholds]


def pose_mAA(errors: Sequence[float]) -> float:
    """IMC mean average accuracy over the 1..10 degree histogram."""
    errors = np.asarray(list(errors), dtype=np.float64)
    bars = np.arange(11)
    qt_hist, _ = np.histogram(errors, bars)
    qt_hist = qt_hist.astype(float) / float(len(errors))
    return float(np.mean(np.cumsum(qt_hist)))


def iou_recalls(ious: Sequence[float],
                thresholds: Sequence[float] | None = None) -> np.ndarray:
    """Recall of IoU values at each threshold (overlap-box validation).

    Default thresholds 0.5:0.05:0.95; the headline numbers are
    R0.5/R0.75/R0.9 (indices 0/5/8).
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 0.96, 0.05)
    ious = np.asarray(list(ious), dtype=np.float64)
    thresholds = np.asarray(thresholds, dtype=np.float64)
    return np.array([(ious >= t).sum() / float(len(ious)) for t in thresholds])


def error_summary(errors_R: Sequence[float], errors_t: Sequence[float],
                  thresholds: Sequence[float] = (5.0, 10.0, 20.0)) -> dict:
    """Headline MegaDepth table: AUC of max(err_R, err_t)."""
    err = np.maximum(np.asarray(list(errors_R), dtype=np.float64),
                     np.asarray(list(errors_t), dtype=np.float64))
    aucs = pose_auc(err, list(thresholds))
    return {f"auc@{int(t)}": a for t, a in zip(thresholds, aucs)}
