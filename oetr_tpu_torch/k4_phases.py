"""Where K4's time goes inside a launch, on the card.

    python -m oetr_tpu_torch.k4_phases [--scale 3.0]

Builds a copy of ``csrc/log_sinkhorn.cu`` with ``clock64`` stamps at the
kernel's phase boundaries (each stamp a ``__syncthreads`` and one read of
the SM's clock by thread 0), runs it on SuperGlue's transport problem at
[8, 2049, 2049] and on one pair of 3001² that does not fit the grid's
shared memory (30 iterations, scores of ``--scale`` times a normal sample,
~10% of keypoints masked), and prints one JSON line per shape: the cycles
each phase takes per iteration (load and epilogue: per launch), averaged
over the blocks that own rows, beside the CUDA-event time of the stamped
call and its error against the plain version. The stamps add a barrier
per phase, so the stamped call runs a little slower than the kernel. The
copy is built into the package's git-ignored ``_build/`` directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .ops import _build
from .ops.sinkhorn import (augment_scores, device_limits, log_sinkhorn,
                           sinkhorn_plan)

PHASES = ("load, marks and the grid barrier", "row pass and u",
          "column partials", "merge (waits for partials)",
          "v read (waits for v)", "epilogue")
# (text of the kernel, the same text with a stamp). Stamp k adds the cycles
# since the last stamp to slot k of the block.
STAMPS = (
    ("    int rows, int resident) {\n",
     "    int rows, int resident, long long* stamps) {\n"
     "  long long t0 = clock64();\n"
     "#define STAMP(k) { __syncthreads(); if (threadIdx.x == 0) { "
     "long long t1 = clock64(); stamps[blockIdx.x * 8 + (k)] += t1 - t0; "
     "t0 = t1; } }\n"),
    ("  cg::this_grid().sync();\n", "  cg::this_grid().sync();\n  STAMP(0);\n"),
    ("    __syncthreads();\n    // 2. The block's partial",
     "    STAMP(1);\n    // 2. The block's partial"),
    ("    // 3. v of the block's share", "    STAMP(2);\n    // 3. v of the"
     " block's share"),
    ("    // 4. The pair's whole v", "    STAMP(3);\n    // 4. The pair's whole"
     " v"),
    ("    __syncthreads();\n  }\n\n  // out =",
     "    STAMP(4);\n  }\n\n  // out ="),
    ("(c[j] + ur) + v_s[j]);\n    }\n  }\n}",
     "(c[j] + ur) + v_s[j]);\n    }\n  }\n  STAMP(5);\n}"),
    ("int launch(", "long long* g_stamps = nullptr;\nint launch("),
    ("(void*)&rows, (void*)&resident};",
     "(void*)&rows, (void*)&resident, (void*)&g_stamps};"),
    ('extern "C" int oetr_device_limits',
     'extern "C" void oetr_set_stamps(void* p) { g_stamps = (long long*)p; }'
     '\nextern "C" int oetr_device_limits'),
)


def stamped_source() -> str:
    """``csrc/log_sinkhorn.cu`` with every stamp of ``STAMPS`` in; raises
    if the kernel no longer holds one of the texts, once."""
    src = (_build.SRC_DIR / "log_sinkhorn.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"k4_phases: the kernel no longer has {old!r}")
        src = src.replace(old, new)
    return src


def stamped_library() -> ctypes.CDLL:
    src = stamped_source()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "k4_phases.cu"
    so = _build.BUILD_DIR / "k4_phases.so"
    cu.write_text(src)
    subprocess.run([_build.nvcc_path(), *_build.COMPILE_FLAGS, "-I",
                    str(_build.SRC_DIR), "-shared", str(cu), "-o", str(so)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.oetr_log_sinkhorn_f32.argtypes = _build.ENTRY_POINTS[
        "oetr_log_sinkhorn_f32"]
    lib.oetr_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def run(lib, b: int, k: int, scale: float, iters: int = 30) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    scores = torch.randn(b, k, k, generator=g, device=dev) * scale
    mask0 = torch.rand(b, k, generator=g, device=dev) > 0.1
    mask1 = torch.rand(b, k, generator=g, device=dev) > 0.1
    aug, mu, nu = augment_scores(scores, 1.0, mask0, mask1)[:3]
    _, m, n = aug.shape
    sms, smem = device_limits(dev.index or 0)
    plan = sinkhorn_plan(b, m, n, sms, smem)
    out = torch.empty_like(aug)
    work = torch.empty(plan.workspace_floats(sms, n), device=dev)
    stamps = torch.zeros(sms * 8, dtype=torch.int64, device=dev)
    lib.oetr_set_stamps(stamps.data_ptr())

    def call():
        rc = lib.oetr_log_sinkhorn_f32(
            aug.data_ptr(), mu.data_ptr(), nu.data_ptr(), out.data_ptr(),
            work.data_ptr(), b, m, n, iters, plan.pairs_per_launch,
            plan.rows_per_block, plan.resident_rows,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"k4_phases: launch failed, cudaError {rc}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    stamps.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    ref = log_sinkhorn(aug, mu, nu, iters)
    unmasked = ref > -1e8
    err = (out - ref)[unmasked].abs().max().item()
    owners = -(-m // plan.rows_per_block)     # blocks of a pair with rows
    per_block = stamps.view(sms, 8).double().cpu()
    rows = torch.cat([per_block[p * plan.blocks_per_pair:
                                p * plan.blocks_per_pair + owners]
                      for p in range(plan.pairs_per_launch)])
    cycles = {}
    for i, name in enumerate(PHASES):
        per = iters * plan.launches if 1 <= i <= 4 else plan.launches
        cycles[name] = rows[:, i].mean().item() / per
    return {"shape": [b, m, n], "iters": iters, "scale": scale,
            "plan": plan._asdict(), "stamped_event_ms": start.elapsed_time(end),
            "max_abs_err": err, "cycles_per_iteration": cycles,
            "iteration_cycles": sum(cycles[p] for p in PHASES[1:5])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=3.0,
                    help="scores are this times a standard normal sample")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_phases: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = stamped_library()
    for b, k in ((8, 2048), (1, 3000)):
        print(json.dumps({"device": smi, **run(lib, b, k, args.scale)}),
              flush=True)


if __name__ == "__main__":
    main()
