#!/usr/bin/env python3
"""``chip_smoke.py`` with the seconds each of its timing and checking
helpers took, summed by the function that called it: where the run's
time goes besides the checks themselves.

    python3 chip_time_sites.py [--out chiprun_out/time_sites.json]

Runs ``chip_smoke.main()`` of the working directory whole (one CUDA card;
its output and exit code are chip_smoke's; a helper that checkout lacks
is skipped) and writes ``--out``:
``{"seconds": {"caller:helper": s}, "calls": {"caller:helper": n}}``.
Helpers called inside other helpers count in both.
"""
from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

HELPERS = ("time_ms", "device_ms", "traced_stats", "pairs_per_s",
           "traced_launches", "card_vs_cpu", "trace_calls", "api_case",
           "api_vs_cpu", "api_matcher_vs_cpu", "pose_case", "eigh_by_shape",
           "mt_row", "demo_timing", "recorded_kernel_errors")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "time_sites.json"))
    out = ap.parse_args().out
    seconds, calls = collections.defaultdict(float), collections.Counter()

    def timed(name, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                key = f"{inspect.stack()[1].function}:{name}"
                seconds[key] += time.perf_counter() - t
                calls[key] += 1
        return call

    for name in HELPERS:
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    try:
        return cs.main()
    finally:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"seconds": seconds, "calls": calls}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
