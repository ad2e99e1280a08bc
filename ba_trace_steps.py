#!/usr/bin/env python3
"""Traced calls of the port's bundle adjustment on the card at 1, 3 and 15
LM steps, on the problem of ``chip_smoke.py``'s ``sfm`` part (b) (the
counts of BAL's Dubrovnik-16, 40 CG iterations, Huber 4 px, float32):
whether that phase's traced call of ``BAL_TRACE_ITERS`` steps, divided by
its steps, stands for the 15-step call users run.

    python3 ba_trace_steps.py [--out chiprun_out/ba_trace_steps.json]

For each call: wall ms, device busy ms, idle share and launches (one
traced call after one warm-up, ``chip_smoke.traced_stats``); then each
per step (the call over its steps) and the step's own cost (the
difference of two calls over the difference of their steps, no set-up).
Prints the card's name and power limit, then one JSON line, and writes it
to ``--out``. One CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

STEPS = (1, 3, 15)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "ba_trace_steps.json"))
    out_path = ap.parse_args(argv).out

    import torch

    if not torch.cuda.is_available():
        print("ba_trace_steps: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from oetr_tpu_torch.sfm import bundle_adjust

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    args, _ = cs.bal_problem()
    on_card = [a.to(cs.DEV) for a in args]
    calls = {}
    for n in STEPS:
        st = cs.traced_stats(torch, lambda: bundle_adjust(
            *on_card, iters=n, cg_iters=cs.BAL_CG_ITERS,
            huber_delta=cs.BAL_HUBER), reps=1, warmup=1, cpu=False)
        calls[n] = {k: st[k] for k in ("wall_ms", "device_busy_ms",
                                       "idle_share", "launches_per_call")}
    per_step = {n: {"busy_ms": c["device_busy_ms"] / n,
                    "launches": c["launches_per_call"] / n}
                for n, c in calls.items()}
    step_cost = {f"{a}_to_{b}": {
        "busy_ms": (calls[b]["device_busy_ms"] - calls[a]["device_busy_ms"])
        / (b - a),
        "launches": (calls[b]["launches_per_call"]
                     - calls[a]["launches_per_call"]) / (b - a)}
        for a, b in zip(STEPS, STEPS[1:])}
    out = {"problem": {"cameras": cs.BAL_CAMS, "points": cs.BAL_POINTS,
                       "observations": cs.BAL_OBS,
                       "cg_iters": cs.BAL_CG_ITERS},
           "calls": calls, "per_step": per_step, "step_cost": step_cost}
    line = json.dumps(out)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
