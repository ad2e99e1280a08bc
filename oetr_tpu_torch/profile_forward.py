"""Where the device time of the port's main paths goes on the card.

    python -m oetr_tpu_torch.profile_forward [--plain] [--pipeline oetr|sparse]
        [--attention linear:cuda|full:cuda|full:flash]

``--pipeline oetr`` (the default): the flagship OETR forward in bf16 on 8
pairs of 640x640 images, its encoder attention as ``--attention`` says
(K2 by default, K5 or K6 for full attention; ``--plain`` takes the plain
op of the same kind). ``--pipeline sparse``: the overlap-guided sparse
pipeline as ``chip_smoke.py`` drives it (OETR on 640x640 copies, heatmap
boxes, crops onto 832x832, SuperPoint with k = 2048, SuperGlue with 9
layers and 30 Sinkhorn iterations; bf16, 8 pairs, no retry). Every kernel
switch is on (``--plain``: every switch off), the weights are seeded and
random. After warm-up, 3 calls are traced with torch.profiler and one JSON
line is printed: wall and device-busy ms per call, the device's idle share,
device ms per call by category of kernel and, for the sparse pipeline, by
stage (a kernel counts for the ``record_function`` range of
``SparsePipeline``, ``SuperPoint`` or ``SuperGlue`` whose device-side span
it starts in), and the kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from . import (PipelineConfig, SparsePipeline, build_oetr, build_superglue,
               build_superpoint, oetr_r50_config, oetr_r50_kernels_config,
               replace)

PAIRS, HW, DTYPE = 8, 640, "bfloat16"   # the chip_smoke.py paths
CANVAS, KEYPOINTS = 832, 2048

# Kernel-name substrings -> category, first match wins.
CATEGORIES = (
    ("K2 linear_encoder", ("linear_encoder_kernel",)),
    ("K3 gn_relu_maxpool", ("gn_stats_kernel", "gn_fold_kernel",
                            "gn_apply_pool_kernel")),
    ("K4 log_sinkhorn", ("sinkhorn_kernel",)),
    ("K1 linear_attention", ("linear_attention_kernel",)),
    # softmax_attention.cuh's kernel template: <T, D, false> is K5, <T, D,
    # true> K6.
    ("K5 full_attention", ("16, false>", "32, false>", "64, false>")),
    ("K6 flash_attention", ("16, true>", "32, true>", "64, true>")),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "nhwc", "nchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
    ("softmax", ("softmax",)),
    ("norm statistics", ("norm", "moments", "welford", "rowwise")),
    ("top-k / sort", ("topk", "sort", "radix")),
    ("reduction", ("reduce",)),
    ("elementwise / copy", ("elementwise", "copy", "cat", "vectorized")),
)
# The sparse pipeline's record_function ranges, in path order.
STAGES = ("oetr", "crop", "superpoint_net", "nms_topk", "superglue_gnn",
          "sinkhorn", "match_extraction")


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def build_flagship(plain: bool, attention: str = "linear:cuda"):
    """The flagship OETR in bf16, kernel switches on (or off, with the plain
    op of ``attention``'s kind), seed 0."""
    if plain:
        base = oetr_r50_config()
        cfg = replace(base, dtype=DTYPE, neck=replace(
            base.neck, attention=attention.split(":")[0]))
    else:
        cfg = oetr_r50_kernels_config(DTYPE, attention)
    return build_oetr(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))


def oetr_call(plain: bool, attention: str):
    model = build_flagship(plain, attention)
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (PAIRS, HW, HW, 3)
    im1 = torch.rand(*shape, generator=g, device="cuda")
    im2 = torch.rand(*shape, generator=g, device="cuda")
    return lambda: model(im1, im2)


def sparse_call(plain: bool):
    dt = getattr(torch, DTYPE)
    oetr = build_flagship(plain)
    sp = build_superpoint(device="cuda", max_keypoints=KEYPOINTS, dtype=dt,
                          generator=torch.Generator().manual_seed(3))
    sg = build_superglue(device="cuda", dtype=dt, cuda_sinkhorn=not plain,
                         generator=torch.Generator().manual_seed(4))
    pipe = SparsePipeline(sp, sg, oetr=oetr, cfg=PipelineConfig(
        canvas_hw=(CANVAS, CANVAS), oetr_hw=(HW, HW), fallback_min_matches=0,
        box_source="heatmap"))
    g = torch.Generator(device="cuda").manual_seed(5)
    rand = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    im0, im1 = rand(PAIRS, CANVAS, CANVAS, 3), rand(PAIRS, CANVAS, CANVAS, 3)
    o0, o1 = rand(PAIRS, HW, HW, 3), rand(PAIRS, HW, HW, 3)
    hw = torch.full((PAIRS, 2), CANVAS, dtype=torch.int32, device="cuda")
    sc = torch.full((PAIRS, 2), CANVAS / HW, device="cuda")
    return lambda: pipe(im0, im1, hw, hw, o0, o1, sc, sc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="every kernel switch off")
    ap.add_argument("--pipeline", choices=("oetr", "sparse"), default="oetr")
    ap.add_argument("--attention", default="linear:cuda",
                    choices=("linear:cuda", "full:cuda", "full:flash"),
                    help="the OETR encoder's attention (--pipeline oetr)")
    args = ap.parse_args(argv)
    if args.pipeline == "sparse" and args.attention != "linear:cuda":
        ap.error("--attention applies to --pipeline oetr")
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    call = (sparse_call(args.plain) if args.pipeline == "sparse"
            else oetr_call(args.plain, args.attention))
    n = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n

    # Device events: the kernels, and the device-side spans of the
    # record_function ranges (which are not kernels: they are kept apart).
    kernels, spans = [], []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.name in STAGES:
            spans.append((evt.time_range.start, evt.time_range.end, evt.name))
        else:
            kernels.append(evt)
    by_cat = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0])
    by_stage = defaultdict(float)
    for evt in kernels:
        ms = evt.time_range.elapsed_us() / 1e3 / n
        by_cat[category(evt.name)] += ms
        by_kernel[evt.name][0] += ms
        by_kernel[evt.name][1] += 1
        stage = next((name for start, end, name in spans
                      if start <= evt.time_range.start < end),
                     "outside the ranges")
        by_stage[stage] += ms
    busy_ms = sum(by_cat.values())
    result = {
        "device": torch.cuda.get_device_name(0),
        "config": {"pipeline": args.pipeline, "dtype": DTYPE, "pairs": PAIRS,
                   "hw": HW, "kernels": not args.plain,
                   "attention": args.attention},
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "pairs_per_s_traced": PAIRS / wall_ms * 1e3,
        "device_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])),
    }
    if args.pipeline == "sparse":
        result["config"].update(canvas=CANVAS, keypoints=KEYPOINTS)
        result["device_ms_by_stage"] = {
            s: by_stage.get(s, 0.0) for s in STAGES + ("outside the ranges",)}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    result["top_kernels"] = [{"name": k[:120], "ms": v[0],
                              "launches": v[1] // n} for k, v in top]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
