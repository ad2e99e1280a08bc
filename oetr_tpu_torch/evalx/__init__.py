"""Benchmark evaluation (MegaDepth, IMC, HPatches), ported from
``oetr_tpu/evalx``; the per-pair pose errors come from the port's
estimator, on the card unless the caller asks for the CPU."""
from . import datasets, hpatches, imc, imc_math, megadepth
from .metrics import (error_summary, iou_recalls, pose_acc, pose_auc,
                      pose_mAA)
from .trajectory import absolute_trajectory_error, camera_centers, umeyama_3d
from .twoview import correct_intrinsics, validation_error

__all__ = [
    "error_summary", "iou_recalls", "pose_acc", "pose_auc", "pose_mAA",
    "correct_intrinsics", "validation_error", "absolute_trajectory_error",
    "camera_centers", "umeyama_3d", "datasets", "hpatches", "imc",
    "imc_math", "megadepth",
]
