"""IMC-2021 validation benchmark (port of ``oetr_tpu/evalx/imc.py``).

Per-dataset pose AUC, precision, matching score and mAA@10, with the
reference's dynamic RANSAC thresholds for OETR-preprocessed runs.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..data.pairs import load_eval_pairs
from ..utils.h5io import SceneResults
from .metrics import pose_auc, pose_mAA
from .twoview import validation_error

IMC_DATASETS = ("googleurban-val", "pragueparks-val", "phototourism-val")

# The reference's thresholds (px) by dataset.
SG_THRESHOLDS = {"googleurban-val": 0.5, "pragueparks-val": 0.8,
                 "phototourism-val": 0.45}
NN_THRESHOLDS = {"googleurban-val": 0.6, "pragueparks-val": 0.75,
                 "phototourism-val": 0.6}


def benchmark_results(input_pairs: str, results_path: str,
                      pairwise: bool = False, dynamic_threshold: str = "",
                      device="cuda"):
    """[datasets, aucs, precisions, mscores, mAAs] with a 'total' row, the
    reference's structure. The estimator runs on ``device``."""
    pairs = load_eval_pairs(input_pairs)
    pose_errors = defaultdict(list)
    precisions = defaultdict(list)
    matching_scores = defaultdict(list)
    scenes: dict[str, SceneResults] = {}
    for p in pairs:
        dataset = p.name0.split("/")[0]
        scene = p.name0.split("/")[1] if "/" in p.name0 else "."
        if scene not in scenes:
            scenes[scene] = SceneResults(results_path, scene, pairwise)
        k0, k1, m, ip0, ip1 = scenes[scene].pair(p.name0, p.name1)
        if dynamic_threshold == "sg":
            thr = SG_THRESHOLDS.get(dataset, 1.0)
        elif dynamic_threshold == "nn":
            thr = NN_THRESHOLDS.get(dataset, 1.0)
        else:
            thr = 1.0
        r = validation_error(k0, k1, m, p.K0, p.K1, p.T_0to1, ip0, ip1,
                             thresh_px=thr, device=device)
        pose_errors[dataset].append(max(r["error_t"], r["error_R"]))
        precisions[dataset].append(r["precision"])
        matching_scores[dataset].append(r["matching_score"])
    for s in scenes.values():
        s.close()

    thresholds = [5, 10, 20]
    all_data, all_aucs, all_prec, all_ms, all_mAA = [], [], [], [], []
    for k in matching_scores:
        all_data.append(k)
        all_aucs.append([100.0 * a for a in pose_auc(pose_errors[k],
                                                     thresholds)])
        all_prec.append(100.0 * float(np.mean(precisions[k])))
        all_ms.append(100.0 * float(np.mean(matching_scores[k])))
        all_mAA.append(100.0 * pose_mAA(pose_errors[k]))

    total_err = sum(list(pose_errors.values()), [])
    all_data.append("total")
    all_aucs.append([100.0 * a for a in pose_auc(total_err, thresholds)])
    all_prec.append(100.0 * float(np.mean(sum(list(precisions.values()), []))))
    all_ms.append(100.0 * float(np.mean(sum(list(matching_scores.values()),
                                            []))))
    all_mAA.append(100.0 * pose_mAA(total_err))
    return [all_data, all_aucs, all_prec, all_ms, all_mAA]


def dynamic_threshold_for(method: str) -> str:
    """The reference's rule: OETR + SuperGlue -> 'sg'; OETR + NN -> 'nn'."""
    m = method.lower()
    if "oetr" in m:
        if "superglue" in m:
            return "sg"
        if "nn" in m:
            return "nn"
    return ""
