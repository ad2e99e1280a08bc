"""The evaluation harnesses on files (the port's counterpart of the JAX
package's ``scripts/evaluate_megadepth.sh``, ``evaluate_imc.sh`` and
``evaluate_hpatches.sh``):

    python -m oetr_tpu_torch.scripts.evaluate megadepth <pairs.txt> \\
        <data_dir> <results_dir> [--device cuda]
    python -m oetr_tpu_torch.scripts.evaluate imc <pairs.txt> <data_dir> \\
        <results_dir> [method] [--device cuda]
    python -m oetr_tpu_torch.scripts.evaluate hpatches <hpatches_root> \\
        <results_dir> [--device cuda]

Each runs ``build_model("superpoint_aachen", "superglue_outdoor",
overlaper="oetr")`` (HPatches without the overlaper, unguided and not
pairwise) over the pair list through ``run_benchmark``, which reads the
images and writes the per-scene h5 results with the port's own code, then
scores the results and prints the shell script's ``run:`` line and table.
Nothing needs cv2 or h5py. Each flow is a function that takes a pipeline,
so a caller can hand it trained weights; it prints the script's lines
and returns their numbers.
"""
from __future__ import annotations

import argparse
import os

from ..evalx import hpatches, imc, megadepth
from ..evalx.datasets import generate_hpatches_pairs, iter_hpatches_results
from ..pipelines.runner import run_benchmark

METHOD = "oetr_superpoint_superglue"


def megadepth_flow(pipeline, pairs: str, data: str, results: str,
                   device="cuda") -> dict:
    """MegaDepth-1500: pose AUC@5/10/20, precision and matching score."""
    stats = run_benchmark(pipeline, pairs, data, results)
    print("run:", stats)
    aucs, prec, ms = megadepth.benchmark_results(pairs, results,
                                                 pairwise=True, device=device)
    print(megadepth.summary_table({METHOD: [aucs, prec, ms]}))
    return {"run": stats, "aucs": list(aucs), "precision": prec,
            "matching_score": ms}


def imc_flow(pipeline, pairs: str, data: str, results: str,
             method: str = METHOD, device="cuda") -> dict:
    """IMC: per dataset and in total, pose AUC, precision, matching score
    and mAA@10 under the method's dynamic threshold."""
    stats = run_benchmark(pipeline, pairs, data, results)
    print("run:", stats)
    datasets, aucs, prec, ms, maa = imc.benchmark_results(
        pairs, results, pairwise=True,
        dynamic_threshold=imc.dynamic_threshold_for(method), device=device)
    rows = {}
    for d, a, p, m, v in zip(datasets, aucs, prec, ms, maa):
        print(f"{d:16s} auc@5/10/20 {a[0]:5.2f}/{a[1]:5.2f}/{a[2]:5.2f} "
            f"prec {p:5.2f} ms {m:5.2f} mAA@10 {v:5.2f}")
        rows[d] = {"aucs": list(a), "precision": p, "matching_score": m,
                   "mAA@10": v}
    return {"run": stats, "rows": rows}


def hpatches_flow(pipeline, root: str, results: str) -> dict:
    """HPatches: '1.ppm' against '2..6.ppm' of each sequence, unguided;
    MMA at 1-15 px by illumination and viewpoint."""
    os.makedirs(results, exist_ok=True)
    pairs_txt = f"{results}/hpatches_pairs.txt"
    n = generate_hpatches_pairs(root, pairs_txt)
    print(f"pairs: {n}")
    stats = run_benchmark(pipeline, pairs_txt, root, results,
                          with_overlap=False, pairwise=False)
    print("run:", stats)
    table = hpatches.benchmark_results(
        list(iter_hpatches_results(pairs_txt, root, results)))
    for k, v in table.items():
        print(f"{k}: {v}")
    return {"run": stats, "pairs": n, "table": table}


def main(argv=None):
    ap = argparse.ArgumentParser(description="the evaluation harnesses")
    ap.add_argument("flow", choices=("megadepth", "imc", "hpatches"))
    ap.add_argument("args", nargs="+",
                    help="megadepth: pairs data results; imc: pairs data "
                         "results [method]; hpatches: root results")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    want = {"megadepth": (3, 3), "imc": (3, 4), "hpatches": (2, 2)}[a.flow]
    if not want[0] <= len(a.args) <= want[1]:
        ap.error(f"{a.flow} takes {want[0]}-{want[1]} positional arguments")

    from ..pipelines.api import build_model

    overlaper = None if a.flow == "hpatches" else "oetr"
    pipeline, _ = build_model("superpoint_aachen", "superglue_outdoor",
                              overlaper=overlaper, device=a.device)
    if a.flow == "megadepth":
        return megadepth_flow(pipeline, *a.args, device=a.device)
    if a.flow == "imc":
        return imc_flow(pipeline, *a.args[:3],
                        method=a.args[3] if len(a.args) > 3 else METHOD,
                        device=a.device)
    return hpatches_flow(pipeline, *a.args)


if __name__ == "__main__":
    main()
