#!/usr/bin/env python3
"""The CPU's own spread of the port's bundle adjustment, on the problem of
``chip_smoke.py``'s ``sfm`` part (b) (the counts of BAL's Dubrovnik-16:
16 cameras, 22,106 points, 83,718 observations; 15 LM steps of 40 CG
iterations, Huber 4 px, float32), from which that phase's card-vs-CPU
bounds are set:

  * the same BA with the pixels nudged by one float32 ulp: how far the
    final cost (of cost0), the cameras, the points and the ATE move;
  * the same BA with the 16 cameras all around the scene (a full ring)
    instead of a half ring: LM stalls after one step (the step is applied
    on the right of the rotation, the Jacobian taken in the so3 log, as in
    JAX), where the half ring converges.

    python3 sfm_spread.py [--threads 4]

Prints one JSON line. The CPU alone; ~1 minute on 4 threads.
"""
from __future__ import annotations

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from oetr_tpu_torch.evalx.trajectory import absolute_trajectory_error
    from oetr_tpu_torch.sfm import bundle_adjust

    torch.set_num_threads(args.threads)
    kw = dict(iters=cs.BAL_ITERS, cg_iters=cs.BAL_CG_ITERS,
              huber_delta=cs.BAL_HUBER)
    out = {"threads": args.threads, "device": "cpu"}
    problem, truth = cs.bal_problem()
    nudged = list(problem)
    nudged[5] = torch.nextafter(problem[5], torch.tensor(float("inf")))
    t0 = time.perf_counter()
    with torch.inference_mode():
        a = bundle_adjust(*problem, **kw)
        out["seconds_a_call"] = time.perf_counter() - t0
        b = bundle_adjust(*nudged, **kw)
        ring, ring_truth = cs.bal_problem(full_ring=True)
        r = bundle_adjust(*ring, **kw)
    ate = lambda res, t: absolute_trajectory_error(res["cams"].numpy(),
                                                   t)["ate_rmse"]
    h0 = float(a["cost_history"][0])
    out["nudge"] = {
        "final_cost_rel": abs(float(a["cost"] - b["cost"])) / h0,
        "cost_history_rel": float((a["cost_history"] - b["cost_history"])
                                  .abs().max()) / h0,
        "cams_max_abs": float((a["cams"] - b["cams"]).abs().max()),
        "pts_max_abs": float((a["pts"] - b["pts"]).abs().max()),
        "ate_rmse_gap": abs(ate(a, truth) - ate(b, truth))}
    out["half_ring"] = {"cost_history": a["cost_history"].tolist(),
                        "ate_rmse": [absolute_trajectory_error(
                            problem[0].numpy(), truth)["ate_rmse"],
                            ate(a, truth)]}
    out["full_ring"] = {"cost_history": r["cost_history"].tolist(),
                        "ate_rmse": [absolute_trajectory_error(
                            ring[0].numpy(), ring_truth)["ate_rmse"],
                            ate(r, ring_truth)]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
