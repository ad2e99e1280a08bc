"""Where the time of the flagship OETR forward goes on the card.

    python -m oetr_tpu_torch.profile_forward [--plain]

Builds the flagship in bf16 with both kernel switches on (``--plain``:
both off) and seeded random weights, runs 3 warm-up forwards on 8 pairs of
640x640 images, then traces 3 forwards with torch.profiler and prints one
JSON line: wall and device-busy ms per forward, the device's idle share,
device ms per forward by category of kernel, and the kernels that take the
most device time.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from . import build_oetr, oetr_r50_config, oetr_r50_kernels_config, replace

PAIRS, HW, DTYPE = 8, 640, "bfloat16"   # the chip_smoke.py slice

# Kernel-name substrings -> category, first match wins.
CATEGORIES = (
    ("K2 linear_encoder", ("linear_encoder_kernel",)),
    ("K3 gn_relu_maxpool", ("gn_relu_maxpool_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
    ("norm statistics", ("norm", "moments", "welford", "rowwise")),
    ("reduction", ("reduce",)),
    ("elementwise / copy", ("elementwise", "copy", "cat", "vectorized")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="both kernel switches off")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")

    cfg = (replace(oetr_r50_config(), dtype=DTYPE) if args.plain
           else oetr_r50_kernels_config(DTYPE))
    model = build_oetr(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (PAIRS, HW, HW, 3)
    im1 = torch.rand(*shape, generator=g, device="cuda")
    im2 = torch.rand(*shape, generator=g, device="cuda")

    n = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(3):
            model(im1, im2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                model(im1, im2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n

    by_cat = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3 / n
        by_cat[category(evt.key)] += ms
        by_kernel[evt.key][0] += ms
        by_kernel[evt.key][1] += evt.count // n
    busy_ms = sum(by_cat.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "config": {"dtype": DTYPE, "pairs": PAIRS, "hw": HW,
                   "kernels": not args.plain},
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "pairs_per_s_traced": PAIRS / wall_ms * 1e3,
        "device_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])),
        "top_kernels": [{"name": k[:120], "ms": v[0], "launches": v[1]}
                        for k, v in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
