"""The pose call's wall and device busy time, with the 5-point stage off
and on, and the eigh kernel's device time at every shape that call gives
it, for one checkout of this repository on one CUDA card.

    python3 pose_timing.py [--root DIR]

DIR (default: the directory of this script) is the root of a checkout:
its ``oetr_tpu_torch`` is imported, builds its own kernels into its own
``_build/`` and is what is timed; the measuring code is this script's
and ``chip_smoke.py``'s beside it. The call is ``chip_smoke.py``'s pose
timing: ``estimate_pose`` with JAX's defaults on 8 general pairs of 2048
slots (generator seeds 11 and 12). To compare two versions on one card,
unpack one into a directory that ``.gitignore`` lists and run the roots
in turns, one process each:

    for r in _archive/parent . . _archive/parent; do
        python3 pose_timing.py --root $r; done

Prints one JSON line: per setting of the 5-point stage, of WALL_CALLS
calls the wall ms (CUDA events) and the host's ms until the call returned
(median, least, most each), again with the card kept from going idle
(a sleep kernel on a side stream), and, per trace of three calls (TRACES
of them), the wall and device busy ms, the idle share and eigh's device
ms;
then, on the eigh inputs of one call with the stage off,
``chip_smoke.eigh_by_shape`` and the errors against LAPACK
(``chip_smoke.eigh_errors``, which raises beyond its tolerance). Exits 1
without a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
WALL_CALLS = 40
TRACES = 3


def load_smoke():
    """``chip_smoke.py`` beside this script (a checkout under test may hold
    an older one of its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def spread(times):
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def wall_ms(torch, fn, keep_busy_ms=0.0):
    """Of WALL_CALLS calls of ``fn()`` after two warm-ups, each started with
    its stream idle: the CUDA-event ms (the card's wall) and the host's ms
    until ``fn()`` returned (its launches queued). With ``keep_busy_ms``
    (about one call's ms), a one-block sleep kernel on a side stream keeps
    the card from going idle for the whole loop; the call's own stream
    does not wait for it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    if keep_busy_ms:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(3e6 * keep_busy_ms * (WALL_CALLS + 2)))
    event, host = [], []
    for _ in range(WALL_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        end.synchronize()
        event.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    return {"event": spread(event), "host": spread(host)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("pose_timing: needs a CUDA card", file=sys.stderr)
        return 1
    cs = load_smoke()
    import oetr_tpu_torch as port
    from oetr_tpu_torch import ops
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.ops._build import load_library

    if Path(port.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {port.__file__}, not from {root}")
    t0 = time.perf_counter()
    _, record = load_library()
    out = {"root": args.root, "built": record["built"],
           "build_s": time.perf_counter() - t0}
    general = pf.general_pose_pairs(
        pf.POSE_PAIRS, torch.Generator(device="cuda").manual_seed(11))
    with torch.inference_mode():
        for use_5pt in (False, True):
            gen = torch.Generator(device="cuda")

            def call():
                gen.manual_seed(12)
                return port.estimate_pose(
                    general["kpts0"], general["kpts1"], general["valid"],
                    general["K"], general["K"], gen, use_5pt=use_5pt)

            traces = []
            for _ in range(TRACES):
                stats = cs.traced_stats(torch, call)
                traces.append({
                    "wall_ms": stats["wall_ms"],
                    "busy_ms": stats["device_busy_ms"],
                    "idle_share": stats["idle_share"],
                    "eigh_device_ms": stats["device_ms_by_category"].get(
                        "small eigh (Jacobi)", 0.0),
                    "launches": stats["launches_per_call"]})
            wall = wall_ms(torch, call)
            out[f"use_5pt={use_5pt}"] = {
                "wall_ms": wall, "traces": traces,
                "wall_ms_card_kept_busy": wall_ms(
                    torch, call, keep_busy_ms=wall["event"]["median"])}
        with cs.recorded_eigh_inputs() as calls:
            port.estimate_pose(
                general["kpts0"], general["kpts1"], general["valid"],
                general["K"], general["K"],
                torch.Generator(device="cuda").manual_seed(12), use_5pt=False)
            torch.cuda.synchronize()
        rows = cs.eigh_by_shape(torch, ops.eigh, calls)
        out["eigh_by_shape"] = rows
        out["eigh_path_device_ms"] = sum(r["calls"] * r["device_ms"]
                                         for r in rows)
        out["eigh_errors"] = cs.eigh_errors(torch, ops, calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
