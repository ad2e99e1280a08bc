"""Where the device time of the port's main paths goes on the card.

    python -m oetr_tpu_torch.profile_forward [--plain]
        [--pipeline oetr|sparse|dense|loftr|pose]
        [--attention linear:cuda|full:cuda|full:flash]

``--pipeline oetr`` (the default): the flagship OETR forward in bf16 on 8
pairs of 640x640 images, its encoder attention as ``--attention`` says
(K2 by default, K5 or K6 for full attention; ``--plain`` takes the plain
op of the same kind). ``--pipeline sparse``: the overlap-guided sparse
pipeline as ``chip_smoke.py`` drives it (OETR on 640x640 copies, heatmap
boxes, crops onto 832x832, SuperPoint with k = 2048, SuperGlue with 9
layers and 30 Sinkhorn iterations; bf16, 8 pairs, no retry). ``--pipeline
dense``: the dense pipeline as ``chip_smoke.py`` drives it (4 scene pairs
from the port's generator, OETR in bf16 on 640x640 copies, heatmap boxes,
crops onto 832x832, bench stage 6's LoFTR in f32; no retry). ``--pipeline
loftr``: that LoFTR alone as bench stage 6 runs it (16 scene pairs of
256x256, f32; it runs no kernel of the port). ``--pipeline pose``:
``estimate_pose`` with JAX's defaults (512 hypotheses, 8 LO candidates,
the planar fallback, the 5-point stage off as on the card by default) on
8 general two-view problems of 2048 slots (``general_pose_pairs``); its
eigensolves run the Jacobi kernel. Every kernel switch is on
(``--plain``: every switch off), the weights are seeded and random. After
warm-up, 3 calls are traced with torch.profiler and one JSON line is
printed: wall and device-busy ms per call, the device's idle share, the
peak memory of the traced calls, device ms per call by category of kernel
and, for a pipeline, by stage (a kernel counts for the
``record_function`` range of the pipeline, ``SuperPoint``, ``SuperGlue``
or ``LoFTR`` whose device-side span it starts in), and the kernels that
take the most device time.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from collections import defaultdict

import torch

from . import (DensePipeline, PipelineConfig, SparsePipeline, build_loftr,
               build_oetr, build_superglue, build_superpoint,
               make_device_generator, oetr_r50_config,
               oetr_r50_kernels_config, replace)
from .geometry import estimate_pose
from .geometry.overlap import rigid_inverse, warp_grid_via_depth
from .models.superpoint import grayscale
from .utils.profiling import device_events, pad_trace

PAIRS, HW, DTYPE = 8, 640, "bfloat16"   # the chip_smoke.py paths
CANVAS, KEYPOINTS = 832, 2048
DENSE_PAIRS = 4
LOFTR_PAIRS, LOFTR_HW = 16, 256
# bench stage 6's LoFTR (bench.py:196-199), run in f32; chip_smoke.py
# builds it from here.
LOFTR_KW = dict(d_coarse=192, d_fine=96, coarse_layers=4, fine_layers=1,
                nhead=8, temperature=0.1, match_threshold=0.2,
                max_matches=1024, fine_window=5)
# The scene generator's settings in bench stage 5 (bench.py:377-379).
SCENE_KW = dict(scale_range=(1.0, 1.6), p_translate=0.5)

# The pose path: 8 pairs of 2048 correspondence slots (the sparse path's
# k), 1400 true correspondences of a general scene with
# tests/test_ransac.py's recipe (0.5 px noise, 30% outliers) in an 832²
# frame (its 600 px focal length at 640, scaled).
POSE_PAIRS, POSE_SLOTS, POSE_TRUE = 8, 2048, 1400
POSE_FOCAL, POSE_NOISE_PX, POSE_OUTLIERS = 780.0, 0.5, 0.3

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
    ("small eigh (Jacobi)", ("sym_eigh_kernel",)),
    ("convolution", ("conv", "fprop", "implicit", "dgrad", "wgrad", "nhwc",
                     "nchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "xmma")),
    ("softmax", ("softmax",)),
    ("norm statistics", ("norm", "moments", "welford", "rowwise")),
    ("top-k / sort", ("topk", "sort", "radix")),
    ("reduction", ("reduce",)),
    ("elementwise / copy", ("elementwise", "copy", "cat", "vectorized")),
)
# The pipelines' record_function ranges, in path order.
STAGES = {"sparse": ("oetr", "crop", "superpoint_net", "nms_topk",
                     "superglue_gnn", "sinkhorn", "match_extraction"),
          "dense": ("oetr", "crop", "loftr_backbone", "loftr_coarse",
                    "coarse_matching", "loftr_fine"),
          "loftr": ("loftr_backbone", "loftr_coarse", "coarse_matching",
                    "loftr_fine")}


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


def scene_pairs(hw: int, b: int, seed: int, device: str = "cuda"):
    """b scene pairs of hw² from the port's generator (bench stage 5's
    settings) on ``device``."""
    return make_device_generator(hw, b, device=device, **SCENE_KW)(
        torch.Generator(device=device).manual_seed(seed))


def pipeline_args(raw: dict, oetr_hw: int) -> tuple:
    """A pipeline's arguments for the generator's batch ``raw``: the
    canvases, their valid sizes, their oetr_hw² copies (antialiased
    bilinear, as jax.image.resize shrinks) and full px per copy px."""
    im0, im1 = raw["image1"], raw["image2"]
    b, hw, dev = im0.shape[0], im0.shape[1], im0.device
    small = lambda im: torch.nn.functional.interpolate(
        im.permute(0, 3, 1, 2), size=(oetr_hw, oetr_hw), mode="bilinear",
        align_corners=False, antialias=True).permute(0, 2, 3, 1).contiguous()
    sizes = torch.full((b, 2), hw, dtype=torch.int32, device=dev)
    sc = torch.full((b, 2), hw / oetr_hw, device=dev)
    return (im0, im1, sizes, sizes, small(im0), small(im1), sc, sc)


def loftr_model(device: str = "cuda"):
    """bench stage 6's LoFTR with seeded weights (seed 8)."""
    return build_loftr(device=device,
                       generator=torch.Generator().manual_seed(8), **LOFTR_KW)


def loftr_call():
    """bench stage 6: LoFTR on LOFTR_PAIRS grayscale scene pairs."""
    model = loftr_model()
    raw = scene_pairs(LOFTR_HW, LOFTR_PAIRS, seed=8)
    g0, g1 = grayscale(raw["image1"]), grayscale(raw["image2"])
    return lambda: model(g0, g1)


def dense_call(plain: bool):
    """The dense pipeline on DENSE_PAIRS scene pairs: OETR in bf16 (kernel
    switches on, or off), LoFTR in f32, seeds as in ``chip_smoke.py``."""
    pipe = DensePipeline(loftr_model(), oetr=build_flagship(plain),
                         cfg=PipelineConfig(canvas_hw=(CANVAS, CANVAS),
                                            oetr_hw=(HW, HW),
                                            fallback_min_matches=0,
                                            box_source="heatmap"))
    args = pipeline_args(scene_pairs(CANVAS, DENSE_PAIRS, seed=9), HW)
    return lambda: pipe(*args)


def _uniform(g: torch.Generator, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def _rotation_xyz(a: torch.Tensor) -> torch.Tensor:
    """[..., 3] angles (radians) -> Rz Ry Rx [..., 3, 3] (scipy's
    extrinsic 'xyz' Euler angles)."""
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a[..., 0]), torch.zeros_like(a[..., 0])

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, c[..., 0], -s[..., 0]],
              [zero, s[..., 0], c[..., 0]]])
    ry = mat([[c[..., 1], zero, s[..., 1]], [zero, one, zero],
              [-s[..., 1], zero, c[..., 1]]])
    rz = mat([[c[..., 2], -s[..., 2], zero], [s[..., 2], c[..., 2], zero],
              [zero, zero, one]])
    return rz @ ry @ rx


def _intrinsics(b: int, focal: float, hw: int, device) -> torch.Tensor:
    K = torch.zeros((b, 3, 3), dtype=torch.float32, device=device)
    K[:, 0, 0], K[:, 1, 1] = focal, focal
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = hw / 2.0, hw / 2.0, 1.0
    return K


def _with_outliers(g, kpts1, candidates, frac, hw):
    """kpts1 with ``frac`` of the candidate slots (the first of a random
    order) moved to uniform points of the frame; and that mask."""
    b, n = candidates.shape
    order = torch.argsort(torch.rand((b, n), generator=g, device=g.device)
                          - 2.0 * candidates.float(), dim=-1)
    n_out = (frac * candidates.sum(-1).float()).round().long()
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=g.device).expand(b, n))
    out = rank < n_out[:, None]
    moved = _uniform(g, (b, n, 2), 0.0, float(hw))
    return torch.where(out[..., None], moved, kpts1), out


def general_pose_pairs(b: int, generator: torch.Generator,
                       n_true: int = POSE_TRUE, n_slots: int = POSE_SLOTS,
                       outlier_frac: float = POSE_OUTLIERS,
                       hw: int = CANVAS, focal: float = POSE_FOCAL) -> dict:
    """b general two-view problems drawn on the generator's device, with
    the recipe of tests/test_ransac.py: points uniform in a 6-unit cube 8
    units in front of camera 0, R from Euler angles in ±15°, a random unit
    t, POSE_NOISE_PX of Gaussian noise on both views, ``outlier_frac`` of
    the true slots moved to uniform points of the hw² frame, and the slots
    after ``n_true`` padding. Returns kpts0, kpts1 [b, n_slots, 2], valid
    [b, n_slots], K [b, 3, 3] (both views), T_0to1 [b, 4, 4] and outlier
    [b, n_slots]."""
    g, dev = generator, generator.device
    R = _rotation_xyz(_uniform(g, (b, 3), -15.0, 15.0) * (math.pi / 180.0))
    t = torch.randn((b, 3), generator=g, device=dev)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
    X = _uniform(g, (b, n_true, 3), -3.0, 3.0)
    X[..., 2] += 8.0
    K = _intrinsics(b, focal, hw, dev)

    def project(P):
        uv = P @ K.transpose(-1, -2)
        return uv[..., :2] / uv[..., 2:]

    noise = lambda: POSE_NOISE_PX * torch.randn((b, n_true, 2), generator=g,
                                                device=dev)
    uv0 = project(X) + noise()
    uv1 = project(X @ R.transpose(-1, -2) + t[:, None]) + noise()
    uv1, out = _with_outliers(g, uv1, torch.ones((b, n_true), dtype=torch.bool,
                                                 device=dev),
                              outlier_frac, hw)
    pad = lambda x: torch.cat([x, torch.zeros((b, n_slots - n_true)
                                              + x.shape[2:], dtype=x.dtype,
                                              device=dev)], dim=1)
    T = torch.eye(4, device=dev).repeat(b, 1, 1)
    T[:, :3, :3], T[:, :3, 3] = R, t
    valid = (torch.arange(n_slots, device=dev) < n_true).expand(b, n_slots)
    return {"kpts0": pad(uv0), "kpts1": pad(uv1), "valid": valid, "K": K,
            "T_0to1": T, "outlier": pad(out)}


def planar_pose_pairs(raw: dict, generator: torch.Generator,
                      step: int = 16, n_slots: int = POSE_SLOTS) -> dict:
    """Correspondences of the scene generator's pairs ``raw`` (a
    fronto-parallel textured plane; pure translation or a dolly-in): the
    centres of a grid of image-1 pixels at ``step`` px, warped into image
    2 by ``warp_grid_via_depth`` with the pair's depth and poses; those
    that land in image 2 first (up to ``n_slots``, the rest padding), and
    POSE_OUTLIERS of them moved to uniform points of the frame. Returns
    the keys of ``general_pose_pairs``, in original-frame pixels (the
    generator's crop is 0 and its ratio 1)."""
    g = generator
    uv2, _, has_depth = warp_grid_via_depth(
        raw["K1"], raw["depth1"], raw["pose1"], raw["crop1"], raw["ratio1"],
        raw["K2"], raw["pose2"], raw["crop2"], raw["ratio2"])
    b, hw = uv2.shape[0], uv2.shape[1]
    dev = uv2.device
    c = torch.arange(step // 2, hw, step, device=dev, dtype=torch.float32)
    cy, cx = torch.meshgrid(c, c, indexing="ij")
    pick = lambda x: x[:, step // 2::step, step // 2::step].reshape(
        (b, -1) + x.shape[3:])
    kp0 = torch.stack([cx, cy], -1).reshape(1, -1, 2).expand(b, -1, -1) + 0.5
    kp1 = pick(uv2) + 0.5
    inside = pick(has_depth) & ((kp1 >= 0) & (kp1 < hw)).all(-1)
    order = torch.argsort((~inside).to(torch.int8), dim=-1, stable=True)
    order = order[:, :n_slots]
    take = lambda x: torch.gather(x, 1, order[..., None].expand(-1, -1, 2))
    valid = torch.gather(inside, 1, order)
    kp0, kp1 = take(kp0), take(kp1)
    kp1, out = _with_outliers(g, kp1, valid, POSE_OUTLIERS, hw)
    zero = torch.zeros_like(kp0)
    return {"kpts0": torch.where(valid[..., None], kp0, zero),
            "kpts1": torch.where(valid[..., None], kp1, zero),
            "valid": valid, "K": raw["K1"],
            "T_0to1": raw["pose2"] @ rigid_inverse(raw["pose1"]),
            "outlier": out}


def pose_call(use_5pt=None):
    """estimate_pose with JAX's defaults on POSE_PAIRS general problems."""
    g = torch.Generator(device="cuda").manual_seed(11)
    d = general_pose_pairs(POSE_PAIRS, g)
    draw = torch.Generator(device="cuda")

    def call():
        draw.manual_seed(12)
        return estimate_pose(d["kpts0"], d["kpts1"], d["valid"], d["K"],
                             d["K"], draw, use_5pt=use_5pt)
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="every kernel switch off")
    ap.add_argument("--pipeline",
                    choices=("oetr", "sparse", "dense", "loftr", "pose"),
                    default="oetr")
    ap.add_argument("--attention", default="linear:cuda",
                    choices=("linear:cuda", "full:cuda", "full:flash"),
                    help="the OETR encoder's attention (--pipeline oetr)")
    args = ap.parse_args(argv)
    if args.pipeline != "oetr" and args.attention != "linear:cuda":
        ap.error("--attention applies to --pipeline oetr")
    if args.pipeline in ("loftr", "pose") and args.plain:
        ap.error(f"--pipeline {args.pipeline} runs no kernel switch")
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    call = {"sparse": lambda: sparse_call(args.plain),
            "dense": lambda: dense_call(args.plain),
            "loftr": loftr_call,
            "pose": pose_call,
            "oetr": lambda: oetr_call(args.plain, args.attention)}[
        args.pipeline]()
    pairs = {"dense": DENSE_PAIRS, "loftr": LOFTR_PAIRS,
             "pose": POSE_PAIRS}.get(args.pipeline, PAIRS)
    stages = STAGES.get(args.pipeline, ())
    n = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.profiler.profile(activities=acts) as prof:
            pad_trace()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
            pad_trace()
            torch.cuda.synchronize()

    kernels, ranges = device_events(prof)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in ranges]
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
        "config": {"pipeline": args.pipeline, "dtype": DTYPE, "pairs": pairs,
                   "hw": HW, "kernels": not args.plain,
                   "attention": args.attention},
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "pairs_per_s_traced": pairs / wall_ms * 1e3,
        "peak_mem_gb_traced": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])),
    }
    if args.pipeline == "sparse":
        result["config"].update(canvas=CANVAS, keypoints=KEYPOINTS)
    if args.pipeline == "dense":
        result["config"].update(canvas=CANVAS, loftr=LOFTR_KW,
                                loftr_dtype="float32")
    if args.pipeline == "loftr":
        result["config"].update(hw=LOFTR_HW, dtype="float32", loftr=LOFTR_KW)
    if args.pipeline == "pose":
        result["config"].update(hw=CANVAS, dtype="float32", slots=POSE_SLOTS,
                                true=POSE_TRUE, use_5pt=False)
    if stages:
        result["device_ms_by_stage"] = {
            s: by_stage.get(s, 0.0) for s in stages + ("outside the ranges",)}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    result["top_kernels"] = [{"name": k[:120], "ms": v[0],
                              "launches": v[1] // n} for k, v in top]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
