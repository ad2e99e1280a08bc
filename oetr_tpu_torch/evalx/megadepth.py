"""MegaDepth-1500 benchmark harness (port of
``oetr_tpu/evalx/megadepth.py``).

Evaluates saved h5 results (the reference's layout, ``utils/h5io.py``)
over a pair list and prints the reference's table: pose AUC@5/10/20
(x100), precision, matching score.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.pairs import load_eval_pairs
from ..utils.h5io import SceneResults
from .metrics import pose_auc
from .twoview import validation_error


def benchmark_results(input_pairs: str, results_path: str,
                      pairwise: bool = False, thresh_px: float = 1.0,
                      device="cuda"):
    """Metrics over one method's saved results: [aucs (x100 at 5/10/20),
    precision (x100), matching_score (x100)], the reference's list. The
    estimator runs on ``device``."""
    pairs = load_eval_pairs(input_pairs)
    pose_errors, precisions, matching_scores = [], [], []
    scenes: dict[str, SceneResults] = {}
    for p in pairs:
        scene = p.name0.split("/")[1] if "/" in p.name0 else "."
        if scene not in scenes:
            scenes[scene] = SceneResults(results_path, scene, pairwise)
        k0, k1, m, ip0, ip1 = scenes[scene].pair(p.name0, p.name1)
        r = validation_error(k0, k1, m, p.K0, p.K1, p.T_0to1, ip0, ip1,
                             thresh_px=thresh_px, device=device)
        pose_errors.append(max(r["error_t"], r["error_R"]))
        precisions.append(r["precision"])
        matching_scores.append(r["matching_score"])
    for s in scenes.values():
        s.close()

    aucs = [100.0 * a for a in pose_auc(pose_errors, [5, 10, 20])]
    return [aucs, 100.0 * float(np.mean(precisions)),
            100.0 * float(np.mean(matching_scores))]


def summary_table(errors: dict[str, list]) -> str:
    """Render the reference's summary table."""
    lines = ["methods\t\t\t AUC@5\t AUC@10\t AUC@20\t Prec\t MScore\t"]
    for method, (aucs, prec, ms) in errors.items():
        lines.append("{}\t {:.2f}\t {:.2f}\t {:.2f}\t {:.2f}\t {:.2f}\t".format(
            method.ljust(20), aucs[0], aucs[1], aucs[2], prec, ms))
    return "\n".join(lines)


def evaluate_methods(input_pairs: str, results_path: str,
                     methods: list[tuple[str, str]], device="cuda"):
    """The reference's main flow: evaluate each (folder, method_name),
    pairwise for LoFTR and OETR methods."""
    errors = {}
    for folder, method in methods:
        path = os.path.join(results_path, folder)
        if not os.path.exists(path):
            continue
        pairwise = "loftr" in method.lower() or "oetr" in method.lower()
        errors[method] = benchmark_results(input_pairs, path, pairwise,
                                           device=device)
    return errors
