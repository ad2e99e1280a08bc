#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (oetr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``oetr_tpu_torch/csrc`` with nvcc
(reporting ptxas's registers and spills for the bf16 kernels on mma.sync:
K2, K5, K6; and for the eigh kernel's sixteen instantiations with their
stack frames, none allowed for the pose path's n = 3 and n = 9), holds each kernel against its plain torch version at the main
paths' shapes (K2 at the flagship's and the fc config's widths, K3, K1, K5
and K6 in float32 and bfloat16, K5 and K6 also at [2, 4096, 8, 32] and in
bf16 at SuperGlue's [8, 2048, 4, 64], K4 in float32; for every kernel its
device time per call from torch.profiler, and its library chain's, beside
the CUDA-event time around a call; K3's statistics and apply kernels also
each alone; K4 with its launch plan, its launches counted in a trace, and
on one pair too large for the grid's shared memory), then drives these
paths with seeded random weights:
  * ``slice``: the flagship OETR forward (ResNet50 to layer3, d_model 256,
    640x640 pairs) with its kernel switches on (K2, K3), against the same
    model with them off;
  * ``sparse``: the overlap-guided pipeline (OETR -> heatmap boxes -> crop
    onto 832x832 -> SuperPoint, k = 2048 -> SuperGlue, 9 layers, 30
    Sinkhorn iterations) on 8 pairs in bf16 with K2, K3 and K4 on, against
    the same pipeline with only the Sinkhorn kernel off; its rate with every
    switch on and off; one call whose low-match pairs take the full-image
    retry; and 2 pairs in float32, all switches on against all off;
  * ``full``: the flagship with full softmax attention through K5
    (``'full:cuda'``) and through K6 (``'full:flash'``), with K3, against
    ``'full'`` (plain ops), in bf16 at 8 pairs and float32 at 2 pairs; and
    ``'full:flash'`` at 1600x1600 (2500 tokens) on 2 pairs;
  * ``fc``: ``oetr_fc_r50_config`` (layer4, d_model 512, 8 heads of 64)
    with ``'linear:cuda'`` (K2 at D = 64) against ``'linear'``;
  * ``linear_attend``: the attention block of the port's decoder layer
    over 400 tokens with ``'linear:cuda'``, the one module path to K1
    (OETR's encoder takes K2, its decoder has one query), against the same
    block on the CPU;
  * ``grad``: the gradients through K1, K5, K6 ([8, 400, 8, 32]), K2
    ([8, 400, 256]) and K3 ([16, 320, 320, 64]) in bf16, each the same
    bits as plain autograd of the function JAX differentiates, then the
    flagship's forward and backward in f32 at 2 pairs with the switches on
    against off: every parameter has a gradient, within OETR_GRAD_TOL
    outside the backbone and at OETR_BACKBONE_COS inside it;
  * ``loftr``: bench stage 6's LoFTR (d_coarse 192, d_fine 96, 4 coarse
    layers, K = 1024, f32) on 16 scene pairs of 256x256: pairs/s, device
    busy ms and peak memory, and 2 of the pairs against the same weights on
    the CPU (it runs no kernel of the port: its attention is the plain
    ``den + eps`` op, as in JAX);
  * ``dense``: the dense pipeline (OETR in bf16 on 640x640 copies, heatmap
    boxes, gate, crops onto 832x832, that LoFTR in f32) on 4 scene pairs
    with OETR's switches on (K2, K3, every output of theirs in one OETR
    pass held to the plain version on the same inputs) against off
    (the path's rate and traced launches are ``trained``'s, with trained
    weights); ``dense_retry``: one call whose low-match pairs take the
    full-image retry;
  * ``scenes``: the port's scene generator on the card (8 pairs of 832x832,
    bench stage 5's settings), its ground-truth boxes against the geometry
    path on the CPU (stage 5's pipeline on such pairs is ``trained``'s);
  * ``pose``: two-view pose (``estimate_pose`` with JAX's defaults: 512
    hypotheses, 8 LO candidates, the planar fallback) on 8 pairs of 2048
    slots: general scenes (1400 true correspondences, 0.5 px noise, 30%
    outliers) held to the truth, and the scene generator's planar pairs
    with the route that won each (H, P&P or E); the 5-point stage off (the
    card's default) and on; each against the port on the CPU given the
    card's eigh and svd3 results, on the same inputs and draws, and read
    beside the plain CPU; the eigh kernel
    (``csrc/small_eigh.cu``, the estimator's null vectors and 3x3 SVDs) on
    every call of the path against LAPACK, its device ms at each distinct
    shape of the path beside torch.linalg.eigh's and the bound, and its
    total in the traced pose call;
    ms a call, device busy ms, idle share, launches and device -> host
    copies a call (none with the 5-point stage off), and the host 5-point
    stage alone. In float32 the refinement returns its input, as JAX's
    does;
  * ``train``: OETR training at full width (the flagship in f32 with K2
    and K3 on, 8 pairs of 640² from the device generator a step, AdamW
    with TrainConfig's defaults, cycle=True, seeded weights): the step's
    launch counts and every K2 and K3 output of its forward against the
    plain version; the losses, gradient norm and gradients of a step with
    the kernels on against off (dropout off); a step with every loss
    switch on; ms a step, pairs/s, peak memory, traced K2 and K3 launches
    and device -> host copies (none) a step; and a checkpoint in JAX's
    orbax ``TrainState`` layout (its bytes, the seconds to write and to
    read, its ``_METADATA``'s OCDBT and zarr v2 flags, its tree held to
    optax AdamW's layout by ``load_checkpoint``) resumed to the
    same bits; ``export_params`` on it (the params store equal to the
    model); and ``probe_heatmap_boxes``'s box half on the read-back state
    (8 generator pairs at 640², K2 16 and K3 1, each call against its
    plain version; mIoU rows against the generator's GT boxes);
  * ``api``: the public matching API (``build_model``, ``get_matches``'s
    helper below the image decode, ``get_pose``) at 832x832 canvases and
    640x640 OETR passes, one pair a call, f32, seeded weights: SuperPoint +
    SuperGlue + OETR through ``build_model``; the same models from the
    registry with K2, K3 and K4 on (launches 16/1/1 a call, counted and
    traced) against the switches off; D2-Net, R2D2 and ASLFeat with NN,
    DISK with its brute-force matcher and with SuperGlue (DISK's); LoFTR
    with OETR; COTR (``cotr_match``, 1024 queries on a 256x256 pair); each
    with pairs/s, device time, idle share, the identity check (an image
    against itself: matched keypoints within 1.5 px; LoFTR's with the
    committed ``.ckpt_loftr_r5`` at its own threshold) and ``get_pose`` on
    its matches; each extractor and COTR against the CPU at 256x256; and
    ``get_pose`` against the homography generator's true H;
  * ``shipped``: the trained-weights path: the committed matching stores
    (``.ckpt_matching_r5``) read by the port's own reader (OCDBT, zarr and
    its zstd decoder, built with g++ beside nvcc), then
    ``build_shipped_model("superglue")`` at JAX's shipped widths (832²
    canvas, SuperPoint k 2048, SuperGlue descriptor 128, 9 layers, K4 on)
    on 8 device-generator pairs: pairs/s, busy ms, idle share, every K4
    call against its plain version, K4 on against off at threshold 0.2,
    >= 64 matches over 0.2; JAX's matcher gate (256², k 512: SuperGlue's
    assignment precision >= NN's); the trained SuperGlue on the card
    against the CPU; the identity check with the real SuperGlue at 0.2;
  * ``trained``: the all-trained main path. (a) The OETR and LoFTR
    stores read by the port's reader (a missing store fails the phase);
    (b) bench stage 5 with every weight trained: the flagship OETR from
    ``.ckpt_oetr_r5`` in bf16 with K2 and K3 on (heatmap boxes on bilinear
    640² copies), SuperPoint (k 2048, descriptor 128, threshold 0) and
    SuperGlue (descriptor 128, K4 on) from ``.ckpt_matching_r5`` in bf16,
    fallback 30, on 8 generator pairs of 832² (stage 5's settings):
    pairs/s, busy ms, idle share, launches, the kernels' calls a call,
    matches over 0.2, ``used_overlap``, the pairs retried and each pair's
    box IoU against the generator's GT boxes, and the retry forced on
    every pair; (c) every K2, K3 and K4 call
    of that call against its plain version, the switches on against off
    (boxes, ``used_overlap``, matches on equal crops), the OETR in f32 on
    the card against the CPU beside the CPU's one-ulp spread; (d)
    ``build_shipped_model("loftr", with_overlap=True)`` on 4 pairs of 832²
    (pairs/s, busy ms, idle share, K2 32 and K3 1 CUDA launches in its trace,
    every K2 and K3 call against its plain version), JAX's LoFTR gate at 256² (>= 100 matches a pair, median
    endpoint error < 2.5 px) and stage 5's matches scored with
    ``estimate_pose``, guided and direct (AUC@5/10/20);
  * ``sfm``: reconstruction, in two parts. (a) The SfM demo's rig
    (``oetr_tpu_torch.sfm.demo`` at scripts/sfm_demo.py's defaults: 12
    views of 320², a 45° arc, 30 view pairs), its correspondences from
    the rendered depths (no cv2 and no trained matcher weights here):
    ``estimate_pose`` per pair, the chain, both ``reconstruct`` rows
    (triangulation on the eigh kernel at n = 4, BA), the ATE before and
    after, the COLMAP model and database read back; every eigh call of the
    path against LAPACK, the 4x4 shapes' device ms beside
    torch.linalg.eigh's, and the card's points against the CPU's by their
    reprojection errors. The chain row's BA is a no-op (camera 0 at zero
    rotation: JAX's float32 NaN Jacobian, copied); the odometry row's ATE
    must fall below half its start's. (b) ``bundle_adjust`` at the counts
    of BAL's Dubrovnik-16 (16 cameras, 22,106 points, 83,718
    observations; 15 steps of 40 CG iterations, Huber 4 px, f32): ms a
    call and a step, busy ms, idle share, launches, device -> host copies
    (none allowed), peak memory, and the card against the port on the CPU
    (run in a child process meanwhile): final cost, cameras, ATE;
  * ``match_train``: the matching trainers and the FCOS head, one line
    each, f32, seeded weights, the JAX demos' sizes at full width:
    SuperPoint's joint step with homographic-adaptation labels (32 x 128²,
    6 views; the labeler also against the CPU on the same draws),
    SuperGlue (8 pairs, 512 keypoints of the port's SuperPoint, GT by depth
    and pose; the plain Sinkhorn), LoFTR (the ``loftr`` phase's model, 4
    pairs of 256², the fine loss), ContextDesc (8 pairs of 128², 128
    host-drawn keypoints, GT from the exact homography) and the FCOS head
    on [8, 40, 40, 256] through ``fcos_losses``: ms a step, peak memory,
    CUDA launches and device -> host copies (none) in a traced step, busy
    ms, idle share, and one step against the CPU on the same weights and
    inputs (none of the port's kernels is on these paths);
  * ``demos``: the demo programs (``python -m oetr_tpu_torch.scripts.*``)
    at their JAX defaults' widths, f32, seeded weights, through their own
    phase functions on the device generators' pairs: ``train_demo``'s OETR
    (ResNet18 to layer3, d 64, 8 heads, 2 + 2 layers, 16 pairs of 160²)
    with the fused stem (K3) and ``'linear:cuda'`` (K2), its recall table
    before and after on 8 pairs; ``train_matching_demo --device_data``:
    SuperPoint (corner teacher, 32 x 128²), SuperGlue on its keypoints (8
    pairs x 512 at 256², its batch made on the card), its segment state
    written in JAX's orbax layout and read back into a fresh SuperGlue
    (bit-equal), whose ``evaluate`` runs 8 pairs with K4 on (the SIFT rows
    need cv2: not run); and
    ``train_loftr_demo``'s LoFTR (fine loss, 4 pairs of 256²) with its
    ``loftr`` row: ms a step, peak memory, a traced step (no device -> host
    copy), each program's JSON fields, and every K2, K3 and K4 call of the
    phase against its plain version;
  * ``variants``: the OETR variants at the flagship's widths, bf16, 8
    pairs of 640², K2 on and the fused-stem switch on: (a) the frozen
    BatchNorm backbone from a reference-layout checkpoint file (written
    from a seed with the reference's aliases and unused keys, read through
    ``load_reference_checkpoint``), K2 16 calls and K3 none, traced beside
    the GroupNorm flagship in the same run, and in f32 on one pair against
    the CPU; (b) the space-to-depth stem with GroupNorm and K3 on the 4x4
    conv's output (K2 16, K3 1), its backbone in f32 against the 7x7 one
    with the kernel mapped; (c) the LayerNorm backbone (K2 16, K3 none);
    every K2 and K3 call of each path against its plain version, boxes on
    against off, pairs/s; then ``device_memory_stats`` and K2's
    ``speed_of_light`` against ``bound()``;
  * ``multi``: the parallel layer at one NCCL rank (the machine has one
    card, and NCCL takes one rank a device): the flagship's f32 train step
    through DDP, 2 steps, against one process on the same weights,
    batches and generators (bit-equality reported), every K2 and K3 call
    of the DDP steps against its plain version, ms a step of each, a
    traced DDP step; FSDP2 with K2 in bf16 and TP in f32 on a small config
    against one process; ``bundle_adjust`` at Dubrovnik-16's counts with a
    group against local.
K1's lines give its cluster (blocks per batch row and head), its grid and
its device time at every cluster size.
One JSON line per phase, each with ``t_s``, seconds since start, and
``phase_s``, seconds since the line before. The last
line is ``{"ok": true, "device": {...}}``; it is printed only when every
check passed. Without a CUDA card, or without the port beside it, the
script exits 1 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
BUDGET_S = 300.0
DEV = "cuda"
BATCH_PAIRS = 8
IMAGE_HW = 640
# Boxes of the kernel path against the switches-off path, in pixels at
# 640x640. float32: the two paths differ only in summation order. bf16: the
# tlbr head computes its logits in bf16, as the JAX model does, and one bf16
# step at |logit| ~ 2-4 moves a box edge by ~2 px; two bf16 paths that round
# at different points land a few steps apart (each path sits 2-7 px from
# the float32 forward), so the bound is 2.5% of the side. Each bf16 path is
# also held to the same bound against the float32 forward.
BOX_TOL_PX = {"bfloat16": 16.0, "float32": 0.02}
# Kernel launches per OETR forward on each encoder attention kind: 4 layers
# x (self + cross) x 2 images.
ENCODER_KERNEL = {"linear:cuda": "linear_encoder_attention",
                  "full:cuda": "full_attention_cuda",
                  "full:flash": "flash_attention_cuda"}
LONG_HW = 1600       # 50 x 50 tokens: MegaDepth's long side, K6's regime
# The kernels' wrappers, each with its launch count.
KERNELS = ("linear_encoder_attention", "groupnorm_relu_maxpool",
           "log_sinkhorn_cuda", "linear_attention_cuda",
           "full_attention_cuda", "flash_attention_cuda", "eigh")
# Sparse pipeline at bench stage 4's shapes.
CANVAS_HW = 832
SPARSE_K = 2048
SINKHORN_ITERS = 30
# K4 against its plain version, unmasked entries and dustbins: 1e-4
# absolute (__expf and the online rescaling round differently from
# torch.logsumexp), or 16 float32 ulps of the pair's scale, its largest
# unmasked |entry|, where that is more. The potentials u and v live at
# that scale even where C + u + v is small (they cancel), each of the 30
# iterations rounds them once in each version, and random-weight
# SuperGlue scores reach several hundred, where one ulp is 1e-5..6e-5.
# Masked entries (the -1e9 sentinel): both <= -1e8.
K4_TOL_ABS = 1e-4
K4_TOL_ULPS = 16
K4_MASKED = -1e8
# One pair of 3001² does not fit the grid's shared memory (23 rows a
# block, 16 of them resident on an H100).
K4_OVER_SMEM_K = 3000
K4_WIDE_SCALE = 300.0
MATCH_AGREE_MIN = 0.99   # matches0 agreement, K4 on vs off, valid keypoints
# OETR's parameter gradients in f32, switches on (K2, K3) against off. The
# two forwards differ in f32 summation order only, so outside the backbone
# the gradients agree to within OETR_GRAD_TOL of max(1, the off path's
# largest |gradient| of the parameter). The backbone's gradients, with
# random weights, are sensitive to rounding itself: a forward that differs
# by rounding moves a weight's gradient by some percent of its largest
# entry (the phase reports how far scaling one input by 1 + 1e-7 moves
# them, beside how far the switches do). So each backbone parameter's
# gradient is held to its direction instead: its cosine similarity with
# the off path's.
OETR_GRAD_TOL = 1e-3
OETR_BACKBONE_COS = 0.999
SFU_PER_CLK_PER_SM = 16  # exponentials per clock per SM (Hopper SFUs)
# LoFTR at bench stage 6's widths (profile_forward.LOFTR_KW), f32.
LOFTR_PAIRS, LOFTR_HW = 16, 256
# LoFTR on the card against the CPU, f32 with TF32 off. coarse_conf to
# LOFTR_CONF_RTOL of the CPU's largest entry: cuDNN and cuBLAS sum in other
# orders through 4 layers, and with seeded weights the largest entry is
# ~5e-4 and a typical one ~1e-6 (1/1024 squared), so an absolute bound
# would pass a wrong coarse stage. Each row's argmax (what the coarse
# stage decides, valid match or not) agrees on >= 99% of the rows, and
# where it differs the card's pick is a row maximum of the CPU's within
# that tolerance. The valid masks equal on >= 99% of the K slots, and the
# image-1 positions of slots whose cells agree within 1e-2 px.
LOFTR_CONF_RTOL = 1e-4
LOFTR_PX_TOL = 1e-2
DENSE_PAIRS = 4
SCENE_PAIRS = 8
# The pose path (profile_forward.general_pose_pairs: 8 pairs of 2048 slots,
# 1400 true correspondences with 0.5 px noise and 30% outliers; and the
# scene generator's planar pairs), JAX's estimator defaults, float32 (no
# Gauss-Newton refinement, as in JAX). On the general scenes every pair
# within POSE_GT_R_DEG / POSE_GT_T_DEG of the truth (the JAX tests' bounds
# at 200 points), on the card and on the CPU. The card against the port
# on the CPU given the card's eigh and svd3 results, on the same inputs
# and draws: each pair's err_R and err_t within POSE_CPU_DEG of the CPU's,
# inlier counts within POSE_CPU_INLIERS (relative). That run differs from
# the card's everywhere but in the eigensolvers, and EIGH_TOL holds the
# eigh kernel to LAPACK on every call of the path. The card against the
# plain CPU (LAPACK's eigensolvers) is read, and bounded by the truth only:
# without the refinement the float32 estimator's null vectors of nearly
# singular 8-point normal matrices follow the eigensolver's last bits, so
# its hypotheses, LO candidates and result move with any change of
# rounding. The CPU's own spread on these inputs (the plain CPU against
# LAPACK's float64 routines rounded to float32, pose_parting.wide_lapack)
# is deterministic: general 1.2261° / 7.47% of the inliers with the
# 5-point stage off, 0.2954° / 0.54% on; planar 0.0560° / 0, 0.0878° /
# 0.07%; the same in the four H100 runs that read it (PRs 21-22). Read it
# on the CPU: ``python -m oetr_tpu_torch.pose_parting --spread``.
POSE_GT_R_DEG, POSE_GT_T_DEG = 2.0, 5.0
POSE_CPU_DEG = 0.25
POSE_CPU_INLIERS = 0.01
# The eigh kernel against LAPACK's syevd (its plain version) on the path's
# matrices: eigenvalues, the residual |A V - V diag(w)| and V's
# orthogonality, relative to each matrix's largest |eigenvalue|; both are
# backward stable, to ~n float32 ulps.
EIGH_TOL = 1e-5
# The train step, f32, kernels (K2, K3) on against off, one step from the
# same weights, batch and generator, dropout off: the two forwards differ
# in summation order only, so the total loss within TRAIN_LOSS_RTOL and the
# global gradient norm within TRAIN_NORM_RTOL (relative); each parameter's
# gradient at the grad phase's bounds (OETR_GRAD_TOL, OETR_BACKBONE_COS).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_NORM_RTOL = 1e-3


def elapsed() -> float:
    return time.perf_counter() - T0


LAST_PHASE_S = [0.0]


def phase(phase_name: str, /, **fields) -> None:
    """One JSON line: the phase, t_s (seconds since start), phase_s (since
    the line before) and its fields."""
    now = elapsed()
    if now > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget at phase "
                           f"{phase_name}")
    print(json.dumps({"phase": phase_name, "t_s": round(now, 3),
                      "phase_s": round(now - LAST_PHASE_S[0], 3),
                      **fields}), flush=True)
    LAST_PHASE_S[0] = now


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_calls(torch, call, reps):
    """Wall ms of ``reps`` synchronized calls, host clock: the median."""
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t)
    return statistics.median(wall) * 1e3


def trace_calls(torch, fn, reps: int, warmup: int = 1, sessions: int = 6,
                select=None, cpu: bool = True):
    """``reps`` calls of ``fn()`` in a torch.profiler trace, after
    ``warmup`` calls: (the profile, its device events (kernels, copies,
    sets; utils.profiling.device_events leaves out the pad kernels that
    open and close the trace and absorb the device events it can miss at
    its ends, and the device-side spans of record_function ranges), the
    wall ms per
    call, the traces taken). ``fn`` launches the same work on every call,
    so a trace where the count of events that ``select`` keeps (all by
    default) is 0 or not a multiple of ``reps`` missed some (seen once on
    the H100 in ~100 traces, and once in two traces in a row); so did one
    whose first or last device event is not a pad kernel (the profiler
    misses a trace's first events, 4-10 of its 128 pads in a run here, and
    the pads absorb them unless it missed all of one end's). Either is
    taken again, up to ``sessions`` traces in all: with ``reps`` 1 the
    pads are the guard. With ``cpu=False`` only the device is traced (no
    CPU op events: a trace of thousands of launches is processed in a
    fraction of the time)."""
    from oetr_tpu_torch.utils.profiling import (PAD_KERNEL, device_events,
                                                pad_trace)

    select = select or (lambda evts: evts)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    counts = []
    for taken in range(1, sessions + 1):
        with torch.profiler.profile(activities=acts) as prof:
            pad_trace()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
            pad_trace()
            torch.cuda.synchronize()
        dev, _ = device_events(prof)
        kept = select(dev)
        on_device = sorted((e for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and not e.is_user_annotation),
                           key=lambda e: e.time_range.start)
        padded = bool(on_device) and all(
            PAD_KERNEL in e.name for e in (on_device[0], on_device[-1]))
        if kept and len(kept) % reps == 0 and padded:
            return prof, dev, wall, taken
        names = collections.Counter(e.name for e in kept)
        counts.append((len(kept), padded, {name[:80]: n for name, n in
                                           names.items() if n % reps}))
    raise RuntimeError(f"torch.profiler recorded (device events, both ends "
                       f"pads, the names whose count is not a multiple of "
                       f"{reps}) {counts} for {reps} calls")


def device_ms(torch, fn, reps: int = 10, warmup: int = 1) -> float:
    """Device time per call of ``fn()``: the summed duration of the device
    events of ``reps`` calls in a trace (``trace_calls``), over ``reps``.
    Unlike ``time_ms`` it leaves out the host's work between launches."""
    _, dev, _, _ = trace_calls(torch, fn, reps, warmup, cpu=False)
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def traced_launches(torch, fn, kernel_name: str, reps: int = 1) -> int:
    """Launches per call of ``fn()`` of the kernels whose name holds
    ``kernel_name``: their device events in a trace of ``reps`` calls
    (``trace_calls``), over ``reps``."""
    pick = lambda evts: [e for e in evts if kernel_name in e.name]
    _, dev, _, _ = trace_calls(torch, fn, reps, select=pick, cpu=False)
    return len(pick(dev)) // reps


def nbytes(*tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def bound(byte_count: int, ops: int, dtype: str, transcendentals: int = 0,
          sfu_per_s: float | None = None) -> tuple[float, str]:
    """Least time on the card (ms) and the term that sets it: the largest of
    bytes over the memory rate, operations over the peak rate for the
    dtype, and transcendentals (exponentials) over the special-function
    units' rate ``sfu_per_s``. The card's peaks are
    ``oetr_tpu_torch.utils.profiling``'s."""
    from oetr_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_OPS_PER_S

    terms = {"bytes": byte_count / HBM_BYTES_PER_S * 1e3,
             "operations": ops / PEAK_OPS_PER_S[dtype] * 1e3}
    if transcendentals:
        terms["transcendentals"] = transcendentals / sfu_per_s * 1e3
    term = max(terms, key=terms.get)
    return terms[term], term


def tolerance(dtype: str, ref_max: float, bf16_ulps: float,
              f32_rel: float) -> float:
    """Absolute tolerance, relative to the output's largest magnitude."""
    scale = max(1.0, ref_max)
    return (bf16_ulps * 2.0 ** -7 if dtype == "bfloat16" else f32_rel) * scale


# --------------------------------------------------------------- kernels --

def check_linear_encoder(torch, F, ops, dtype_name, b, l, s, seed,
                         q_masked, c=256, nhead=8):
    """K2 against its plain version; returns the phase fields."""
    dt = getattr(torch, dtype_name)
    dev = DEV
    d = c // nhead
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = randn(b, l, c).to(dt)
    src = randn(b, s, c).to(dt)
    xpos = randn(1, l, c, scale=0.5).to(dt)
    spos = randn(1, s, c, scale=0.5).to(dt)
    lnq = torch.stack([1 + randn(c, scale=0.1), randn(c, scale=0.1)])
    lnkv = torch.stack([1 + randn(c, scale=0.1), randn(c, scale=0.1)])
    wq, wk, wv = (randn(c, c, scale=c ** -0.5) for _ in range(3))
    kv_mask = torch.rand(b, s, generator=g, device=dev) >= 0.1
    q_mask = (torch.rand(b, l, generator=g, device=dev) >= 0.1
              if q_masked else None)
    args = (x, src, xpos, spos, lnq, lnkv, wq, wk, wv, q_mask, kv_mask)

    out = ops.linear_encoder_attention(*args, nhead=nhead)
    ref = ops.linear_encoder_attention_reference(*args, nhead=nhead)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = tolerance(dtype_name, ref_max, bf16_ulps=2, f32_rel=1e-4)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"K2 {dtype_name} [{b},{l},{s}]: max_abs_err "
                             f"{err} > tol {tol}")

    wq_t, wk_t, wv_t = (w.to(dt) for w in (wq, wk, wv))
    lnq_t, lnkv_t = lnq.to(dt), lnkv.to(dt)

    def library():  # layer_norm + matmul + einsum, a yardstick only
        qn = F.layer_norm(x, (c,), lnq_t[0], lnq_t[1]) + xpos
        kvn = F.layer_norm(src, (c,), lnkv_t[0], lnkv_t[1]) + spos
        q = F.elu(F.linear(qn, wq_t).view(b, l, nhead, d)) + 1
        k = F.elu(F.linear(kvn, wk_t).view(b, s, nhead, d)) + 1
        v = F.linear(kvn, wv_t).view(b, s, nhead, d)
        k = k * kv_mask[:, :, None, None]
        kv = torch.einsum("bshd,bshe->bhde", k, v / s)
        den = torch.einsum("blhd,bhd->blh", q, k.sum(1)).clamp_min(1e-6)
        return torch.einsum("blhd,bhde->blhe", q, kv) * (s / den)[..., None]

    call = lambda: ops.linear_encoder_attention(*args, nhead=nhead)
    ms = time_ms(torch, call)
    plain_ms = time_ms(torch, lambda: ops.linear_encoder_attention_reference(
        *args, nhead=nhead))
    library_ms = time_ms(torch, library)
    flops = (2 * b * (l * c * c + 2 * s * c * c)
             + 2 * b * nhead * (s * d * d + l * d * d + l * d))
    bound_ms, bound_by = bound(nbytes(*args, out), flops, dtype_name)
    dev_ms, lib_dev_ms = device_ms(torch, call), device_ms(torch, library)
    return {"kernel": "linear_encoder_attention", "dtype": dtype_name,
            "shape": {"B": b, "L": l, "S": s, "C": c, "H": nhead},
            "q_mask": q_masked, "kv_masked_frac": 0.1,
            "max_abs_err": err, "tol": tol, "kernel_ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": lib_dev_ms,
            "device_over_library": dev_ms / lib_dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes(*args, out), "flops": flops}


def check_gn_pool(torch, F, ops, load_library, dtype_name, b, h, w, c,
                  seed):
    """K3 against its plain version, and its statistics and apply kernels
    each alone; returns the phase fields."""
    dt = getattr(torch, dtype_name)
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, h, w, c, generator=g, device=dev) * 2 + 0.5).to(dt)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)

    out = ops.groupnorm_relu_maxpool(x, gamma, beta)
    ref = ops.groupnorm_relu_maxpool_reference(x, gamma, beta)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = tolerance(dtype_name, ref_max, bf16_ulps=1, f32_rel=1e-5)
    if out.shape != (b, h // 2, w // 2, c) or not math.isfinite(err) \
            or err > tol:
        raise AssertionError(f"K3 {dtype_name}: max_abs_err {err} > tol {tol}")

    x_nchw = x.permute(0, 3, 1, 2)          # channels_last view, no copy
    gamma_t, beta_t = gamma.to(dt), beta.to(dt)

    def library():  # group_norm + relu + max_pool2d, a yardstick only
        y = F.relu(F.group_norm(x_nchw, 32, gamma_t, beta_t, 1e-5))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    # The statistics kernels alone against gn_scale_shift (f32 sums in
    # another order: 1e-5 of the largest |scale|, |shift|).
    scale, shift = ops.gn_scale_shift(x, gamma, beta, 32, 1e-5)
    k_scale, k_shift = ops.gn_scale_shift_cuda(x, gamma, beta, 32, 1e-5)
    stats_err = max(((k - r).abs().max() / r.abs().max()).item()
                    for k, r in ((k_scale, scale), (k_shift, shift)))
    if not stats_err <= 1e-5:
        raise AssertionError(f"K3 {dtype_name} statistics: relative error "
                             f"{stats_err} > 1e-5")
    lib, _ = load_library()
    sfx = "f32" if dtype_name == "float32" else "bf16"
    stream = lambda: torch.cuda.current_stream().cuda_stream
    buf = torch.empty_like(out)

    def apply_only():  # the apply kernel alone, statistics precomputed
        rc = getattr(lib, f"oetr_gn_apply_pool_{sfx}")(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), buf.data_ptr(),
            b, h, w, c, stream())
        if rc:
            raise RuntimeError(f"K3 apply launch failed: cudaError {rc}")

    apply_only()
    torch.cuda.synchronize()
    apply_err = (buf.float() - ref.float()).abs().max().item()
    if not apply_err <= tol:
        raise AssertionError(f"K3 {dtype_name} apply: {apply_err} > {tol}")
    call = lambda: ops.groupnorm_relu_maxpool(x, gamma, beta)
    ms = time_ms(torch, call)
    plain_ms = time_ms(torch, lambda: ops.groupnorm_relu_maxpool_reference(
        x, gamma, beta))
    library_ms = time_ms(torch, library)
    ops_count = b * (h // 2) * (w // 2) * c * 9 * 3 + 6 * b * h * w * c
    bound_ms, bound_by = bound(nbytes(x, gamma, beta, out), ops_count,
                               dtype_name)
    dev_ms, lib_dev_ms = device_ms(torch, call), device_ms(torch, library)
    return {"kernel": "groupnorm_relu_maxpool", "dtype": dtype_name,
            "shape": {"B": b, "H": h, "W": w, "C": c},
            "max_abs_err": err, "tol": tol, "kernel_ms": ms,
            "device_ms": dev_ms,
            "stats_rel_err": stats_err, "stats_tol_rel": 1e-5,
            "stats_device_ms": device_ms(
                torch, lambda: ops.gn_scale_shift_cuda(x, gamma, beta)),
            "apply_max_abs_err": apply_err,
            "apply_device_ms": device_ms(torch, apply_only),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": lib_dev_ms,
            "device_over_library": dev_ms / lib_dev_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def k4_compare(torch, out, ref):
    """K4's check: (max abs error over unmasked entries, the largest ratio
    of error to tolerance); raises on a masked/unmasked disagreement or a
    non-finite value."""
    if not (torch.isfinite(out).all() and torch.isfinite(ref).all()):
        raise AssertionError("K4: non-finite values")
    masked = ref <= K4_MASKED
    if not torch.equal(out <= K4_MASKED, masked):
        raise AssertionError("K4: masked entries disagree")
    scale = torch.where(masked, 0.0, ref.abs()).amax(dim=(1, 2))
    tol = torch.clamp(K4_TOL_ULPS * torch.finfo(torch.float32).eps * scale,
                      min=K4_TOL_ABS)[:, None, None].expand_as(ref)[~masked]
    err = (out[~masked] - ref[~masked]).abs()
    return err.max().item(), (err / tol).max().item()


def k4_problem(torch, b, k, seed, scale=3.0):
    """SuperGlue's transport problem at k keypoints a side, scores of
    ``scale`` times a normal sample: two pairs with ~10% of keypoints
    masked, one with k1 != k0 valid (where b > 2)."""
    from oetr_tpu_torch.ops.sinkhorn import augment_scores

    dev = DEV
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(b, k, k, generator=g, device=dev) * scale
    mask0 = torch.ones(b, k, dtype=torch.bool, device=dev)
    mask1 = torch.ones(b, k, dtype=torch.bool, device=dev)
    for i in range(min(b, 2)):
        mask0[i] = torch.rand(k, generator=g, device=dev) >= 0.1
        mask1[i] = torch.rand(k, generator=g, device=dev) >= 0.1
    if b > 2:
        mask1[2, k * 4 // 5:] = False
    return augment_scores(scores, 1.0, mask0, mask1)[:3]


def check_sinkhorn(torch, ops, b, k, iters, seed, sfu_per_s, big_k):
    """K4 against its plain version on SuperGlue's transport problem at
    k keypoints a side, and on one pair at big_k, too large for the grid's
    shared memory; returns the phase fields."""
    from oetr_tpu_torch.ops.sinkhorn import device_limits, sinkhorn_plan

    aug, mu, nu = k4_problem(torch, b, k, seed)
    out = ops.log_sinkhorn_cuda(aug, mu, nu, iters)
    ref = ops.log_sinkhorn(aug, mu, nu, iters)
    torch.cuda.synchronize()
    err, worst = k4_compare(torch, out, ref)
    if not worst <= 1.0:
        raise AssertionError(f"K4 [{b},{k + 1},{k + 1}]: max_abs_err {err}, "
                             f"{worst:.2f} x its tolerance")
    limits = device_limits(torch.cuda.current_device())
    _, m, n = aug.shape
    plan = sinkhorn_plan(b, m, n, *limits)

    # One pair whose slabs do not fit: part of each block's rows from L2.
    big = k4_problem(torch, 1, big_k, seed + 1)
    big_plan = sinkhorn_plan(1, big_k + 1, big_k + 1, *limits)
    if big_plan.resident_rows >= big_plan.rows_per_block:
        raise AssertionError(f"K4 at {big_k + 1}²: plan {big_plan} keeps "
                             "every row in shared memory")
    big_out = ops.log_sinkhorn_cuda(*big, iters)
    big_err, big_worst = k4_compare(torch, big_out,
                                    ops.log_sinkhorn(*big, iters))
    if not big_worst <= 1.0:
        raise AssertionError(f"K4 [1,{big_k + 1},{big_k + 1}]: max_abs_err "
                             f"{big_err}, {big_worst:.2f} x its tolerance")
    del big_out

    # Scores of several hundred, as random-weight SuperGlue gives them: the
    # runs' maxima move more, and more runs take their exponentials again.
    wide = k4_problem(torch, b, k, seed + 2, scale=K4_WIDE_SCALE)
    wide_out = ops.log_sinkhorn_cuda(*wide, iters)
    wide_err, wide_worst = k4_compare(torch, wide_out,
                                      ops.log_sinkhorn(*wide, iters))
    if not wide_worst <= 1.0:
        raise AssertionError(f"K4 scores x{K4_WIDE_SCALE}: max_abs_err "
                             f"{wide_err}, {wide_worst:.2f} x its tolerance")
    del wide_out
    wide_ms = device_ms(torch, lambda: ops.log_sinkhorn_cuda(*wide, iters),
                        reps=5)
    del wide

    call = lambda: ops.log_sinkhorn_cuda(aug, mu, nu, iters)
    launches = traced_launches(torch, call, "sinkhorn_kernel")
    if launches != plan.launches:
        raise AssertionError(f"K4: {launches} sinkhorn_kernel launches a "
                             f"call in the trace, the plan has "
                             f"{plan.launches}")
    ms = time_ms(torch, call)
    dev_ms = device_ms(torch, call, reps=5)
    plain_ms = time_ms(torch, lambda: ops.log_sinkhorn(aug, mu, nu, iters),
                       reps=5)
    bound_ms, bound_term = bound(nbytes(aug, mu, nu, out),
                                 4 * b * iters * m * n, "float32",
                                 transcendentals=2 * b * iters * m * n,
                                 sfu_per_s=sfu_per_s)
    return {"kernel": "log_sinkhorn_cuda", "dtype": "float32",
            "shape": {"B": b, "M": m, "N": n, "iters": iters},
            "masked_pairs": [0, 1], "k1_ne_k0_pair": 2,
            "max_abs_err": err, "err_over_tol": worst,
            "tol": {"abs": K4_TOL_ABS, "ulps": K4_TOL_ULPS},
            "kernel_ms": ms, "device_ms": dev_ms,
            "sms_and_smem_per_block": list(limits),
            "pairs_per_launch": plan.pairs_per_launch,
            "rows_per_block": plan.rows_per_block,
            "resident_rows": plan.resident_rows,
            "smem_bytes_per_block": plan.smem_bytes,
            # sinkhorn_kernel's launches in a trace of one wrapper call,
            # beside the plan's: one cooperative launch per group of pairs
            "cuda_launches_per_call": launches,
            "planned_launches_per_call": plan.launches,
            "over_smem": {"shape": [1, big_k + 1, big_k + 1],
                          "rows_per_block": big_plan.rows_per_block,
                          "resident_rows": big_plan.resident_rows,
                          "max_abs_err": big_err,
                          "err_over_tol": big_worst,
                          "device_ms": device_ms(
                              torch, lambda: ops.log_sinkhorn_cuda(
                                  *big, iters), reps=3)},
            "wide_scores": {"scale": K4_WIDE_SCALE, "max_abs_err": wide_err,
                            "err_over_tol": wide_worst, "device_ms": wide_ms},
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_term == "bytes" else "operations",
            "bound_term": bound_term}


def attention_bound(torch, kind, q, k, v, qm, km, out, dtype_name,
                    sfu_per_s):
    """(bound ms, its term) for one attention call on this run's data:
    the visible (query, key) pairs of every head for K5 and K6 (two
    products of D multiply-adds and one exponential each), the elu
    exponentials that the inputs need for K1."""
    b, l, h, d = q.shape
    s = k.shape[1]
    if kind == "linear":
        ops_count = 2 * b * h * (s * d * d + l * d * d + l * d)
        exps = int((q <= 0).sum().item() + (k <= 0).sum().item())
    else:
        nq = qm.sum(1) if qm is not None else torch.full((b,), l,
                                                         device=q.device)
        nk = km.sum(1) if km is not None else torch.full((b,), s,
                                                         device=q.device)
        exps = int((nq * nk).sum().item()) * h
        ops_count = 4 * exps * d
    return bound(nbytes(q, k, v, qm, km, out), ops_count, dtype_name,
                 transcendentals=exps, sfu_per_s=sfu_per_s)


def check_attention(torch, F, ops, kind, dtype_name, b, l, s, masks, seed,
                    sfu_per_s, h=8, d=32):
    """K1 ('linear'), K5 ('full') or K6 ('flash') against its plain version
    on [B, L|S, H, D] inputs; masks 'none', 'both' or 'q_only' (10% of
    tokens masked). Returns the phase fields."""
    wrapper, plain = {
        "linear": (ops.linear_attention_cuda, ops.linear_attention_reference),
        "full": (ops.full_attention_cuda, ops.full_attention_reference),
        "flash": (ops.flash_attention_cuda, ops.flash_attention_reference),
    }[kind]
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=DEV).manual_seed(seed)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=DEV).to(dt)
               for n in (l, s, s))
    qm = (torch.rand(b, l, generator=g, device=DEV) >= 0.1
          if masks in ("both", "q_only") else None)
    km = (torch.rand(b, s, generator=g, device=DEV) >= 0.1
          if masks == "both" else None)
    out = wrapper(q, k, v, qm, km)
    ref = plain(q, k, v, qm, km)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    tol = tolerance(dtype_name, ref_max, bf16_ulps=2, f32_rel=1e-4)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{kind} attention {dtype_name} "
                             f"[{b},{l},{s},{h},{d}] masks {masks}: "
                             f"max_abs_err {err} > tol {tol}")

    pair = None     # K5, K6: the [B, 1, L, S] mask that SDPA takes
    if kind == "linear":
        def library():  # the einsum chain, a yardstick only
            qf = F.elu(q) + 1
            kf = F.elu(k) + 1
            kv = torch.einsum("bshd,bshe->bhde", kf, v / s)
            den = torch.einsum("blhd,bhd->blh", qf, kf.sum(1)).clamp_min(1e-6)
            out = torch.einsum("blhd,bhde->blhe", qf, kv)
            return out * (s / den)[..., None]
    else:
        if qm is not None or km is not None:
            qm_ = qm if qm is not None else torch.ones(b, l, dtype=torch.bool,
                                                       device=DEV)
            km_ = km if km is not None else torch.ones(b, s, dtype=torch.bool,
                                                       device=DEV)
            pair = (qm_[:, None, :, None] & km_[:, None, None, :])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():  # scaled_dot_product_attention, a yardstick only
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=pair)

    reps = 5 if b * l * s <= 8 * 400 * 400 else 2
    ms = time_ms(torch, lambda: wrapper(q, k, v, qm, km), reps=reps)
    plain_ms = time_ms(torch, lambda: plain(q, k, v, qm, km), reps=reps)
    library_ms = time_ms(torch, library, reps=reps)
    bound_ms, term = attention_bound(torch, kind, q, k, v, qm, km, out,
                                     dtype_name, sfu_per_s)
    name = wrapper.__name__
    fields = {"kernel": name, "dtype": dtype_name,
              "shape": {"B": b, "L": l, "S": s, "H": h, "D": d},
              "masks": masks, "max_abs_err": err, "tol": tol,
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if term == "bytes" else "operations",
              "bound_term": term}
    # The kernel's and the library's own device time, without the host
    # work that the CUDA-event times above carry (kernel_ms - device_ms is
    # the wrapper's host work).
    dev_ms = device_ms(torch, lambda: wrapper(q, k, v, qm, km), reps=reps)
    lib_dev_ms = device_ms(torch, library, reps=reps)
    fields.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
                  device_over_library=dev_ms / lib_dev_ms)
    if kind == "linear":
        # K1's plan: blocks per (batch row, head) and the grid; then the
        # device time at every cluster size, the plan's among them.
        from oetr_tpu_torch.ops.attention_kernels import (
            _linear_launch, cluster_capacity, linear_attention_cluster)
        capacity = cluster_capacity(0, dt, d)
        nc = linear_attention_cluster(b * h, max(l, s), capacity)
        fields.update(cluster=nc, grid=[nc, h, b],
                      clusters_at_once=capacity, cluster_device_ms={
            n: device_ms(torch, lambda: _linear_launch(q, k, v, qm, km, 1e-6,
                                                       n), reps=reps)
            for n in (1, 2, 4, 8)})
    if pair is not None:
        # SDPA turns a boolean mask into an additive one inside the call;
        # given that bias ready-made, its time is the attention's alone.
        bias = torch.zeros(pair.shape, dtype=dt, device=DEV).masked_fill_(
            ~pair, float("-inf"))
        bias_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias), reps=reps)
        fields.update(library_bias_device_ms=bias_ms,
                      device_over_library_bias=dev_ms / bias_ms)
    return fields


def tensor_core_resources(resources):
    """ptxas's registers and spill bytes of each bf16 kernel on mma.sync:
    K5 / K6 (``softmax_attention_mma.cuh``) by head width, and K2's two
    sides (``linear_encoder.cu``) by head width rounded up to 16; raises if
    one is missing."""
    rows = []
    for mangled, res in sorted(resources.items()):
        m = re.search(r"mma_attention_kernelILi(\d+)ELb([01])E", mangled)
        if m:
            rows.append({"kernel": f"K{5 + int(m.group(2))} bf16 "
                                   f"D={m.group(1)}", **res})
        m = re.search(r"linear_encoder_kernelI13__nv_bfloat16Li(\d+)ELb([01])E",
                      mangled)
        if m:
            side = "source" if m.group(2) == "1" else "query"
            rows.append({"kernel": f"K2 bf16 DP={m.group(1)} {side}", **res})
    if len(rows) != 14:
        raise AssertionError(f"ptxas reported {len(rows)} of the 14 bf16 "
                             "K2/K5/K6 kernels")
    return sorted(rows, key=lambda r: r["kernel"])


def k1_resources(resources):
    """ptxas's registers and spill bytes of K1's kernels, by dtype and
    head width rounded up to 16; raises if one is missing."""
    rows = []
    for mangled, res in sorted(resources.items()):
        m = re.search(r"linear_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                      mangled)
        if m:
            dt = "f32" if m.group(1) == "f" else "bf16"
            rows.append({"kernel": f"K1 {dt} DP={m.group(2)}", **res})
    if len(rows) != 8:
        raise AssertionError(f"ptxas reported {len(rows)} of the 8 K1 "
                             "kernels")
    return sorted(rows, key=lambda r: r["kernel"])


def eigh_resources(record):
    """ptxas's registers, spill bytes and stack frame of the eigh kernel's
    sixteen instantiations (one thread a matrix for n <= 3, a lane group
    from n = 4); raises if one is missing, or if the pose path's (n = 3 and
    n = 9) has a stack frame or spills."""
    frames = record.get("stack_frames", {})
    rows = []
    for mangled, res in sorted(record["resources"].items()):
        m = re.search(r"sym_eigh_kernel_(thread|lanes)ILi(\d+)E", mangled)
        if m:
            rows.append({"kernel": f"eigh {m.group(1)} n={m.group(2)}",
                         "n": int(m.group(2)), **res,
                         "stack_frame": frames.get(mangled)})
    if len(rows) != 16:
        raise AssertionError(f"ptxas reported {len(rows)} of the 16 eigh "
                             "kernels")
    for r in rows:
        if r["n"] in (3, 9) and (r["stack_frame"] != 0
                                 or r.get("spill_stores", 1)
                                 or r.get("spill_loads", 1)):
            raise AssertionError(f"eigh n={r['n']}: stack or spills: {r}")
    return sorted(rows, key=lambda r: r["n"])


def k3_k4_resources(resources):
    """ptxas's registers and spill bytes of K4's kernel and K3's three (the
    statistics and apply kernels in both dtypes at 8 and 1 channels a
    thread); raises if one is missing."""
    names = ("sinkhorn_kernel", "gn_stats_kernel", "gn_fold_kernel",
             "gn_apply_pool_kernel")
    rows = []
    for mangled, res in sorted(resources.items()):
        for name in names:
            if re.search(rf"\d{name}", mangled):
                label = name
                if name in ("gn_stats_kernel", "gn_apply_pool_kernel"):
                    vec = re.search(r"Li(\d+)E", mangled)
                    label += (" bf16" if "bfloat16" in mangled else " f32") \
                        + f" V={vec.group(1) if vec else '?'}"
                rows.append({"kernel": label, **res})
    if len(rows) != 10:
        raise AssertionError(f"ptxas reported {len(rows)} of the 10 K3/K4 "
                             "kernels")
    return sorted(rows, key=lambda r: r["kernel"])


# ----------------------------------------------------------------- slice --

def slice_configs(port, dtype_name, attention="linear:cuda"):
    """(kernel switches on, off) for the flagship: the fused stem and the
    encoder's attention kernel ``attention``, or neither with the plain
    op of the same kind."""
    base = port.oetr_r50_config()
    plain = attention.split(":")[0]
    return (port.oetr_r50_kernels_config(dtype_name, attention),
            port.replace(base, dtype=dtype_name,
                         neck=port.replace(base.neck, attention=plain)))


def fc_configs(port, dtype_name):
    """(K2 on, off) for ``oetr_fc_r50_config``."""
    base = port.replace(port.oetr_fc_r50_config(), dtype=dtype_name)
    return (port.replace(base, neck=port.replace(base.neck,
                                                 attention="linear:cuda")),
            base)


def check_outputs(torch, cfg, out, b, hw, tag):
    stride = 32 if cfg.backbone.stop_layer == "layer3" else 64
    n_tok = (hw // stride) ** 2
    d = cfg.d_model
    shapes = {"pred_bbox1": (b, 4), "pred_bbox2": (b, 4), "center1": (b, 2),
              "center2": (b, 2), "tlbr1": (b, 4), "tlbr2": (b, 4),
              "prob_map1": (b, n_tok), "prob_map2": (b, n_tok),
              "mem1": (b, n_tok, d), "mem2": (b, n_tok, d)}
    for key, shape in shapes.items():
        t = out[key]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{tag} {key}: shape {tuple(t.shape)} != "
                                 f"{shape}")
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag} {key}: non-finite values")
    for key in ("pred_bbox1", "pred_bbox2"):
        box = out[key]
        if (box < 0).any() or (box > hw).any() or \
                (box[:, 2:] < box[:, :2]).any():
            raise AssertionError(f"{tag} {key}: box outside [0, {hw}]")
    for key in ("prob_map1", "prob_map2"):
        if (out[key].sum(-1) - 1).abs().max() > 1e-3:
            raise AssertionError(f"{tag} {key}: does not sum to 1")


def box_diff_px(port, out_a, out_b, hw):
    """Largest difference (px) over the tlbr boxes, the centers and the
    heatmap-decoded boxes."""
    diffs = []
    for key in ("pred_bbox1", "pred_bbox2", "center1", "center2"):
        diffs.append((out_a[key] - out_b[key]).abs().max().item())
    ha = port.decode_boxes(out_a, (hw, hw), (hw, hw), source="heatmap")
    hb = port.decode_boxes(out_b, (hw, hw), (hw, hw), source="heatmap")
    diffs += [(a - b).abs().max().item() for a, b in zip(ha, hb)]
    return max(diffs)


def run_forward(torch, port, ops, cfg_on, cfg_off, want, b, hw, timed,
                tag):
    """One OETR forward with the kernels (``cfg_on``), against the model
    with the switches off (``cfg_off``) and the same weights (and, in bf16,
    both against the float32 forward). ``want`` maps each kernel to its
    launches in that forward. Box bounds are BOX_TOL_PX's share of the
    side. Returns the phase fields and the forward's launches."""
    dtype_name = cfg_on.dtype
    model = port.build_oetr(cfg_on, device=DEV,
                            generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    plain = port.build_oetr(cfg_off, device=DEV,
                            generator=torch.Generator().manual_seed(1))
    plain.load_state_dict(state)
    g = torch.Generator(device=DEV).manual_seed(2)
    im1 = torch.rand(b, hw, hw, 3, generator=g, device=DEV)
    im2 = torch.rand(b, hw, hw, 3, generator=g, device=DEV)
    tol = BOX_TOL_PX[dtype_name] * hw / IMAGE_HW

    with torch.inference_mode():
        # The path, once, with the launch counts read around it.
        reset_counts(ops)
        torch.cuda.reset_peak_memory_stats()
        out = model(im1, im2)
        torch.cuda.synchronize()
        launches = launch_counts(ops)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {name: want.get(name, 0) for name in KERNELS}
        if launches != want:
            raise AssertionError(f"{tag} kernel launches {launches} != {want}")
        ref = plain(im1, im2)
        check_outputs(torch, cfg_on, out, b, hw, f"{tag} kernels")
        check_outputs(torch, cfg_off, ref, b, hw, f"{tag} plain")
        fields = {"dtype": dtype_name, "pairs": b, "image_hw": hw,
                  "attention": cfg_on.neck.attention,
                  "plain_attention": cfg_off.neck.attention,
                  "launches": {k: n for k, n in launches.items() if n},
                  "peak_mem_gb_one_forward": peak_gb,
                  "box_max_diff_px": box_diff_px(port, out, ref, hw),
                  "box_tol_px": tol}
        if dtype_name != "float32":
            truth_cfg = port.replace(cfg_off, dtype="float32")
            truth = port.build_oetr(truth_cfg, device=DEV,
                                    generator=torch.Generator().manual_seed(1))
            truth.load_state_dict(state)
            f32 = truth(im1, im2)
            del truth
            fields["kernels_vs_f32_px"] = box_diff_px(port, out, f32, hw)
            fields["plain_vs_f32_px"] = box_diff_px(port, ref, f32, hw)
        for key in ("box_max_diff_px", "kernels_vs_f32_px", "plain_vs_f32_px"):
            if fields.get(key, 0.0) > tol:
                raise AssertionError(f"{tag} {dtype_name}: {key} "
                                     f"{fields[key]} > {tol} px")
        if timed:
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                model(im1, im2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                model(im1, im2)
            torch.cuda.synchronize()
            fields["pairs_per_s"] = 10 * b / (time.perf_counter() - t)
            fields["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            for _ in range(2):
                plain(im1, im2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                plain(im1, im2)
            torch.cuda.synchronize()
            fields["plain_pairs_per_s"] = 10 * b / (time.perf_counter() - t)
    return fields, launches


def run_slice(torch, port, ops, dtype_name, b, timed,
              attention="linear:cuda", hw=None):
    """The flagship with the encoder kernel of ``attention`` and the fused
    stem, against the switches-off model (see run_forward), at hw x hw
    (IMAGE_HW by default)."""
    hw = hw or IMAGE_HW
    cfg_on, cfg_off = slice_configs(port, dtype_name, attention)
    want = {ENCODER_KERNEL[attention]: 4 * cfg_on.neck.num_layers,
            "groupnorm_relu_maxpool": 1}
    tag = "slice" if attention == "linear:cuda" else f"full {attention}"
    return run_forward(torch, port, ops, cfg_on, cfg_off, want, b, hw, timed,
                       tag)


def run_linear_attend(torch, port, ops, b):
    """K1's module path: the decoder layer's attention block (the port's
    MultiHeadAttention, d_model 256, 8 heads) with ``'linear:cuda'`` over
    b x 400 tokens in bf16, against the same block on the CPU, where K1's
    plain version runs. Returns the phase fields and the launches."""
    from oetr_tpu_torch.models.layers import materialize
    from oetr_tpu_torch.models.transformer import MultiHeadAttention

    def block(device):
        with torch.device("meta"):
            mha = MultiHeadAttention(256, 8, "linear:cuda", torch.bfloat16)
        return materialize(mha, device, torch.Generator().manual_seed(6))

    on_card, on_cpu = block(DEV), block("cpu")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(b, 400, 256, generator=g)
    mask = torch.rand(b, 400, generator=g) >= 0.1
    xd, md = x.to(DEV), mask.to(DEV)
    with torch.inference_mode():
        reset_counts(ops)
        out = on_card(xd, xd, xd, md, md)
        torch.cuda.synchronize()
        launches = launch_counts(ops)
        want = {name: int(name == "linear_attention_cuda") for name in KERNELS}
        if launches != want:
            raise AssertionError(f"linear_attend launches {launches} != "
                                 f"{want}")
        ref = on_cpu(x, x, x, mask, mask)
        ms = time_ms(torch, lambda: on_card(xd, xd, xd, md, md))
    err = (out.float().cpu() - ref.float()).abs().max().item()
    # bf16 on both sides: K1 and its plain version round at the same
    # points; the projections (cuBLAS vs the CPU's GEMM) may round a value
    # a step apart, so 4 steps of the output's scale.
    tol = 4 * 2.0 ** -7 * max(1.0, ref.float().abs().max().item())
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"linear_attend: card vs CPU {err} > {tol}")
    return {"dtype": "bfloat16", "tokens": [b, 400], "d_model": 256,
            "heads": 8, "attention": "linear:cuda",
            "launches": {k: n for k, n in launches.items() if n},
            "card_vs_cpu_max_abs": err, "tol": tol, "block_ms": ms}, launches


# ------------------------------------------------------------------ grad --

def grads_of(torch, fn, inputs, up):
    """Gradients of ``fn(*leaves)`` against the output gradient ``up``,
    with a fresh leaf for every floating-point tensor in ``inputs``."""
    leaves = [t.detach().clone().requires_grad_() if t.is_floating_point()
              else t for t in inputs]
    fn(*leaves).backward(up)
    return [t.grad for t in leaves if t.is_floating_point()]


def kernel_grads(torch, ops, name, fn, plain, inputs, up):
    """The gradients through the kernel's wrapper (one launch, its
    autograd Function) against plain autograd of the function JAX
    differentiates, on the same inputs: the same function of the same
    inputs, so they must be bit-equal."""
    reset_counts(ops)
    got = grads_of(torch, fn, inputs, up)
    launched = launch_counts(ops)[name]
    ref = grads_of(torch, plain, inputs, up)
    torch.cuda.synchronize()
    diff = max((a.float() - r.float()).abs().max().item()
               for a, r in zip(got, ref))
    equal = all(torch.equal(a, r) for a, r in zip(got, ref))
    finite = all(torch.isfinite(a).all().item() for a in got)
    if launched != 1 or not (equal and finite):
        raise AssertionError(f"grad {name}: launches {launched}, bit-equal "
                             f"{equal}, finite {finite}, max diff {diff}")
    return {"inputs": len(got), "launches": launched, "bit_equal": equal,
            "max_abs_diff": diff, "shape": list(inputs[0].shape)}


def oetr_loss(torch, out, seed):
    """A scalar that reaches every output: each key's mean against fixed
    random weights."""
    g = torch.Generator().manual_seed(seed)
    return sum((out[key] * torch.randn(out[key].shape, generator=g).to(
        out[key].device)).mean() for key in sorted(out))


def run_grad(torch, port, ops, b):
    """(a) K1, K5, K6 at [b, 400, 8, 32], K2 at [b, 400, 256] and K3 at
    [2b, 320, 320, 64], bf16: the Function's gradients against plain
    autograd on the card. (b) The flagship in f32 at 2 pairs, 640x640,
    forward and backward with the switches on (K2, K3) and off, same
    weights: every parameter has a finite gradient; outside the backbone
    each within OETR_GRAD_TOL of max(1, the off path's largest |gradient|
    of that parameter), in the backbone each at a cosine of at least
    OETR_BACKBONE_COS with the off path's (see OETR_GRAD_TOL)."""
    dt = torch.bfloat16
    g = torch.Generator(device=DEV).manual_seed(40)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=DEV) * scale

    every = torch.ones(b, 400, dtype=torch.bool, device=DEV)
    q, k, v, up = (rn(b, 400, 8, 32).to(dt) for _ in range(4))
    fields = {}
    for name, plain in (("linear_attention_cuda", ops.linear_attention),
                        ("full_attention_cuda", ops.full_attention),
                        ("flash_attention_cuda", ops.full_attention)):
        fields[name] = kernel_grads(
            torch, ops, name, getattr(ops, name),
            lambda q_, k_, v_, plain=plain: plain(q_, k_, v_, every, every),
            (q, k, v), up)
    c = 256
    enc = (rn(b, 400, c).to(dt), rn(b, 400, c).to(dt),
           rn(1, 400, c, scale=0.5).to(dt), rn(1, 400, c, scale=0.5).to(dt),
           torch.stack([1 + rn(c, scale=0.1), rn(c, scale=0.1)]),
           torch.stack([1 + rn(c, scale=0.1), rn(c, scale=0.1)]),
           *(rn(c, c, scale=c ** -0.5) for _ in range(3)))
    fields["linear_encoder_attention"] = kernel_grads(
        torch, ops, "linear_encoder_attention",
        lambda *a: ops.linear_encoder_attention(*a, nhead=8),
        lambda *a: ops.linear_encoder_attention_op(*a, nhead=8), enc,
        rn(b, 400, c).to(dt))
    x = (rn(2 * b, 320, 320, 64) * 2 + 0.5).to(dt)
    fields["groupnorm_relu_maxpool"] = kernel_grads(
        torch, ops, "groupnorm_relu_maxpool", ops.groupnorm_relu_maxpool,
        ops.groupnorm_relu_maxpool_reference,
        (x, 1 + rn(64, scale=0.1), rn(64, scale=0.1)),
        rn(2 * b, 160, 160, 64).to(dt))
    del x

    # (b) OETR's backward, f32, 2 pairs; the off path a second time with
    # the first image scaled by 1 + 1e-7, the backbone's own sensitivity.
    cfg_on, cfg_off = slice_configs(port, "float32")
    on = port.build_oetr(cfg_on, device=DEV,
                         generator=torch.Generator().manual_seed(0))
    off = port.build_oetr(cfg_off, device=DEV,
                          generator=torch.Generator().manual_seed(1))
    off.load_state_dict(on.state_dict())
    gi = torch.Generator(device=DEV).manual_seed(2)
    im1, im2 = (torch.rand(2, IMAGE_HW, IMAGE_HW, 3, generator=gi,
                           device=DEV) for _ in range(2))
    reset_counts(ops)
    t = time.perf_counter()
    oetr_loss(torch, on(im1, im2), seed=41).backward()
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t
    launches = {k_: n for k_, n in launch_counts(ops).items() if n}
    grads = {}
    for tag, scale in (("off", 1.0), ("nudged", 1.0 + 1e-7)):
        off.zero_grad(set_to_none=True)
        oetr_loss(torch, off(im1 * scale, im2), seed=41).backward()
        grads[tag] = {n: p.grad.clone() for n, p in off.named_parameters()}
    torch.cuda.synchronize()
    worst = {"rel": (0.0, None), "cos": (1.0, None),
             "backbone_rel": (0.0, None), "nudged_backbone_rel": (0.0, None)}
    with_grad, total = 0, 0
    for name, p in on.named_parameters():
        total += 1
        if p.grad is None or not torch.isfinite(p.grad).all():
            continue
        with_grad += 1
        r = grads["off"][name]
        scale = max(1.0, r.abs().max().item())
        rel = (p.grad - r).abs().max().item() / scale
        if name.startswith("backbone."):
            cos = torch.nn.functional.cosine_similarity(
                p.grad.double().flatten(), r.double().flatten(), dim=0).item()
            nudged = (grads["nudged"][name] - r).abs().max().item() / scale
            for key, val, bad in (("cos", cos, cos < worst["cos"][0]),
                                  ("backbone_rel", rel,
                                   rel > worst["backbone_rel"][0]),
                                  ("nudged_backbone_rel", nudged,
                                   nudged > worst["nudged_backbone_rel"][0])):
                if bad:
                    worst[key] = (val, name)
        elif rel > worst["rel"][0]:
            worst["rel"] = (rel, name)
    want = {"linear_encoder_attention": 4 * cfg_on.neck.num_layers,
            "groupnorm_relu_maxpool": 1}
    if (with_grad != total or worst["rel"][0] > OETR_GRAD_TOL
            or worst["cos"][0] < OETR_BACKBONE_COS or launches != want):
        raise AssertionError(f"grad OETR: {with_grad} of {total} parameters "
                             f"with a finite gradient, worst {worst} vs "
                             f"{OETR_GRAD_TOL} / cos {OETR_BACKBONE_COS}, "
                             f"launches {launches}")
    fields["oetr"] = {
        "dtype": "float32", "pairs": 2, "image_hw": IMAGE_HW,
        "launches": launches, "parameters": total,
        "parameters_with_grad": with_grad,
        "max_rel_grad_diff_outside_backbone": worst["rel"][0],
        "worst_outside_backbone": worst["rel"][1], "tol": OETR_GRAD_TOL,
        "min_backbone_grad_cosine": worst["cos"][0],
        "worst_backbone_cosine_parameter": worst["cos"][1],
        "backbone_cosine_min": OETR_BACKBONE_COS,
        "max_rel_grad_diff_backbone": worst["backbone_rel"][0],
        "max_rel_grad_diff_backbone_input_nudged_1e-7":
            worst["nudged_backbone_rel"][0],
        "forward_backward_s": on_s}
    return fields


# ---------------------------------------------------------------- sparse --



def launch_counts(ops):
    return {name: getattr(ops, name).launches for name in KERNELS}


def reset_counts(ops):
    for name in KERNELS:
        getattr(ops, name).launches = 0


class Capture:
    """A SuperGlue as the pipeline's match_fn that keeps its last output."""

    def __init__(self, matcher):
        self.matcher, self.last = matcher, None

    def __call__(self, data):
        self.last = self.matcher(data)
        return self.last


def sparse_models(torch, port, dtype_name, kernels, like=None):
    """(OETR, SuperPoint, SuperGlue) at bench stage 4's widths with every
    kernel switch on or off; seeded weights, or ``like``'s."""
    dt = getattr(torch, dtype_name)
    cfg = (port.oetr_r50_kernels_config(dtype_name) if kernels
           else port.replace(port.oetr_r50_config(), dtype=dtype_name))
    models = (
        port.build_oetr(cfg, device=DEV,
                        generator=torch.Generator().manual_seed(0)),
        port.build_superpoint(device=DEV, max_keypoints=SPARSE_K,
                              dtype=dt,
                              generator=torch.Generator().manual_seed(3)),
        port.build_superglue(device=DEV, dtype=dt, cuda_sinkhorn=kernels,
                             generator=torch.Generator().manual_seed(4)))
    if like is not None:
        for mine, theirs in zip(models, like):
            mine.load_state_dict(theirs.state_dict())
    return models


def sparse_inputs(torch, b):
    """bench stage 4's batch: uniform 832² pairs, their 640² OETR copies."""
    g = torch.Generator(device=DEV).manual_seed(5)
    rand = lambda *shape: torch.rand(*shape, generator=g, device=DEV)
    im0, im1 = rand(b, CANVAS_HW, CANVAS_HW, 3), rand(b, CANVAS_HW,
                                                       CANVAS_HW, 3)
    o0, o1 = rand(b, IMAGE_HW, IMAGE_HW, 3), rand(b, IMAGE_HW, IMAGE_HW, 3)
    hw = torch.full((b, 2), CANVAS_HW, dtype=torch.int32, device=DEV)
    sc = torch.full((b, 2), CANVAS_HW / IMAGE_HW, device=DEV)
    return (im0, im1, hw, hw, o0, o1, sc, sc)


def pipeline(port, models, matcher, min_matches):
    oetr, sp, _ = models
    cfg = port.PipelineConfig(canvas_hw=(CANVAS_HW, CANVAS_HW),
                              oetr_hw=(IMAGE_HW, IMAGE_HW),
                              fallback_min_matches=min_matches,
                              box_source="heatmap")
    return port.SparsePipeline(sp, matcher, oetr=oetr, cfg=cfg)


def match_agreement(a, b, valid):
    """Share of valid keypoints whose matches0 entries agree."""
    return ((a == b) & valid).sum().item() / max(1, valid.sum().item())


def pairs_per_s(torch, pipe, args, reps):
    for _ in range(1):
        pipe(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        pipe(*args)
    torch.cuda.synchronize()
    return reps * args[0].shape[0] / (time.perf_counter() - t)


def run_sparse(torch, port, ops, b):
    """The sparse pipeline in bf16 at 8 pairs: (a) K2, K3 and K4 on against
    only K4 off, (b) rates with every switch on and off, then one call with
    the full-image retry. Returns the phase fields of both and the main
    path's launches."""
    from oetr_tpu_torch.ops.sinkhorn import extract_matches

    # Both runs of (a) must pick the same convolution algorithms.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    on = sparse_models(torch, port, "bfloat16", kernels=True)
    sg_k4_off = port.build_superglue(device=DEV, dtype=torch.bfloat16,
                                     cuda_sinkhorn=False)
    sg_k4_off.load_state_dict(on[2].state_dict())
    cap_on, cap_off = Capture(on[2]), Capture(sg_k4_off)
    pipe_on = pipeline(port, on, cap_on, 0)
    pipe_k4_off = pipeline(port, on, cap_off, 0)
    args = sparse_inputs(torch, b)

    with torch.inference_mode():
        # The main path, once, with the launch counts read around it.
        reset_counts(ops)
        out = pipe_on(*args)
        torch.cuda.synchronize()
        launches = launch_counts(ops)
        want = dict(zip(KERNELS, (16, 1, 1, 0, 0, 0, 0)))
        if launches != want:
            raise AssertionError(f"sparse launches {launches} != {want}")
        ref = pipe_k4_off(*args)
        torch.cuda.synchronize()
        for key in ("bbox0", "bbox1", "keypoints0", "keypoints1", "valid0",
                    "valid1"):
            if not torch.equal(out[key], ref[key]):
                raise AssertionError(f"sparse: {key} differs with K4 off")
        la_on = cap_on.last["log_assignment"]
        la_off = cap_off.last["log_assignment"]
        err, worst = k4_compare(torch, la_on, la_off)
        v0, v1 = out["valid0"], out["valid1"]
        at_02 = match_agreement(out["matches0"], ref["matches0"], v0)
        m0_on = extract_matches(la_on, 0.0, v0, v1)[0]
        m0_off = extract_matches(la_off, 0.0, v0, v1)[0]
        at_00 = match_agreement(m0_on, m0_off, v0)
        if not (worst <= 1.0 and at_02 >= MATCH_AGREE_MIN
                and at_00 >= MATCH_AGREE_MIN):
            raise AssertionError(
                f"sparse K4 on vs off: log_assignment err {err} "
                f"({worst:.2f} x tol), matches agree {at_02} / {at_00}")
        n_kpts = [int(x) for x in v0.sum(-1).tolist()]
        fields = {
            "dtype": "bfloat16", "pairs": b, "canvas_hw": CANVAS_HW,
            "keypoints": SPARSE_K, "launches_per_call": launches,
            "log_assignment_err": err, "log_assignment_err_over_tol": worst,
            "matches_agree_thr_0.2": at_02, "matches_agree_thr_0.0": at_00,
            "matches_per_pair_thr_0.2": out["num_matches"].tolist(),
            "matches_per_pair_thr_0.0": ((m0_on > -1) & v0).sum(-1).tolist(),
            "valid_keypoints_per_pair": n_kpts,
            "pairs_used_overlap": int(out["used_overlap"].sum()),
            "bbox0_first_pair": out["bbox0"][0].tolist()}

        # (b) rates: every switch on, then every switch off.
        torch.cuda.reset_peak_memory_stats()
        fields["pairs_per_s"] = pairs_per_s(torch, pipe_on, args, reps=3)
        fields["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del pipe_k4_off, sg_k4_off
        off = sparse_models(torch, port, "bfloat16", kernels=False, like=on)
        pipe_off = pipeline(port, off, off[2], 0)
        fields["plain_pairs_per_s"] = pairs_per_s(torch, pipe_off, args,
                                                  reps=3)
        del pipe_off, off

        # One call with the reference's rule: < 30 matches -> full image.
        need = ((out["num_matches"] < 30) & out["used_overlap"]).cpu()
        n_retry = int(need.sum())
        reset_counts(ops)
        retried = pipeline(port, on, on[2], 30)(*args)
        torch.cuda.synchronize()
        retry_launches = launch_counts(ops)
        want_k4 = 1 + -(-n_retry // 2)      # retry_batch 2
        used_after = retried["used_overlap"].cpu()
        if (retry_launches["log_sinkhorn_cuda"] != want_k4
                or not torch.equal(used_after,
                                   out["used_overlap"].cpu() & ~need)):
            raise AssertionError(f"retry: {n_retry} pairs, launches "
                                 f"{retry_launches}, used {used_after}")
        retry = {"fallback_min_matches": 30, "retry_batch": 2,
                 "pairs_retried": n_retry, "launches": retry_launches,
                 "matches_per_pair": retried["num_matches"].tolist()}
    return fields, retry, launches


def run_sparse_f32(torch, port, b):
    """2 pairs in float32, every switch on against every switch off."""
    on = sparse_models(torch, port, "float32", kernels=True)
    off = sparse_models(torch, port, "float32", kernels=False, like=on)
    args = [a[:b] for a in sparse_inputs(torch, b)]
    with torch.inference_mode():
        a = pipeline(port, on, on[2], 0)(*args)
        r = pipeline(port, off, off[2], 0)(*args)
        torch.cuda.synchronize()
    box = max((a[k] - r[k]).abs().max().item() for k in ("bbox0", "bbox1"))
    if not (box <= BOX_TOL_PX["float32"]
            and torch.equal(a["used_overlap"], r["used_overlap"])):
        raise AssertionError(f"sparse f32: boxes {box} px apart or "
                             "used_overlap differs")
    same_kp = ((a["keypoints0"] == r["keypoints0"]).all(-1)
               & (a["valid0"] == r["valid0"]))
    return {"dtype": "float32", "pairs": b, "box_max_diff_px": box,
            "box_tol_px": BOX_TOL_PX["float32"],
            "used_overlap": a["used_overlap"].tolist(),
            "keypoints0_equal": int(same_kp.sum()),
            "keypoints0_total": int(same_kp.numel()),
            "matches0_agree": match_agreement(a["matches0"], r["matches0"],
                                              a["valid0"] & same_kp),
            "matches_per_pair": [a["num_matches"].tolist(),
                                 r["num_matches"].tolist()]}


# ----------------------------------------------------- loftr, dense, scenes --

def scene_inputs(b, seed):
    """b scene pairs of CANVAS_HW² from the port's generator on the card
    (bench stage 5's settings) and the pipeline's arguments for them, with
    IMAGE_HW² OETR copies. Returns (arguments, the generator's batch)."""
    from oetr_tpu_torch import profile_forward as pf

    raw = pf.scene_pairs(CANVAS_HW, b, seed, device=DEV)
    return pf.pipeline_args(raw, IMAGE_HW), raw


def run_loftr(torch, port, ops):
    """bench stage 6's LoFTR on LOFTR_PAIRS scene pairs of LOFTR_HW², f32,
    seeded weights: the forward once with the launch counts read around it
    (LoFTR runs none of the port's kernels), 2 pairs against the same
    weights on the CPU, pairs/s (median of CUDA-event timings), device busy
    ms (torch.profiler) and peak memory."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.models.superpoint import grayscale

    model = pf.loftr_model(DEV)
    raw = pf.scene_pairs(LOFTR_HW, LOFTR_PAIRS, seed=8, device=DEV)
    g0, g1 = grayscale(raw["image1"]), grayscale(raw["image2"])
    b, n = LOFTR_PAIRS, (LOFTR_HW // 8) ** 2
    k = min(pf.LOFTR_KW["max_matches"], n)
    with torch.inference_mode():
        model(g0, g1)       # cuDNN times its algorithms for these shapes
        torch.cuda.synchronize()
        reset_counts(ops)
        torch.cuda.reset_peak_memory_stats()
        out = model(g0, g1)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches = launch_counts(ops)
        if any(launches.values()):
            raise AssertionError(f"loftr launched {launches}")
        for key, shape in (("mkpts0", (b, k, 2)), ("mkpts1", (b, k, 2)),
                           ("conf", (b, k)), ("coarse_conf", (b, n, n))):
            if tuple(out[key].shape) != shape or \
                    not torch.isfinite(out[key]).all():
                raise AssertionError(f"loftr {key}: shape "
                                     f"{tuple(out[key].shape)}, or not finite")
        ref = pf.loftr_model("cpu")(g0[:2].cpu(), g1[:2].cpu())
        call = lambda: model(g0, g1)
        ms = time_ms(torch, call, reps=5, warmup=1)
        busy = device_ms(torch, call, reps=2, warmup=1)
    got = {key: out[key][:2].cpu() for key in ref}
    conf, conf_ref = got["coarse_conf"], ref["coarse_conf"]
    conf_tol = LOFTR_CONF_RTOL * conf_ref.max().item()
    conf_err = (conf - conf_ref).abs().max().item()
    pick, pick_ref = conf.argmax(-1), conf_ref.argmax(-1)
    argmax_agree = (pick == pick_ref).float().mean().item()
    # How far below the CPU's row maximum the card's pick lies there.
    pick_gap = (conf_ref.amax(-1) - conf_ref.gather(-1, pick[..., None])[
        ..., 0]).max().item()
    valid_agree = (got["valid"] == ref["valid"]).float().mean().item()
    same_cells = (got["cells0"] == ref["cells0"]) & \
        (got["cells1"] == ref["cells1"])
    px = (got["mkpts1"] - ref["mkpts1"]).abs().amax(-1)
    both = got["valid"] & ref["valid"] & same_cells
    px_valid = px[both].max().item() if both.any() else 0.0
    px_cells = px[same_cells].max().item()
    if not (conf_err <= conf_tol and argmax_agree >= MATCH_AGREE_MIN
            and pick_gap <= conf_tol and valid_agree >= MATCH_AGREE_MIN
            and same_cells.float().mean().item() >= MATCH_AGREE_MIN
            and px_valid <= LOFTR_PX_TOL and px_cells <= LOFTR_PX_TOL):
        raise AssertionError(
            f"loftr card vs CPU: coarse_conf {conf_err} (tol {conf_tol}), "
            f"row argmax agree {argmax_agree} (gap {pick_gap}), valid agree "
            f"{valid_agree}, cells agree {same_cells.float().mean().item()}, "
            f"mkpts1 {px_valid} (valid) / {px_cells} (all rows)")
    return {"dtype": "float32", "pairs": b, "image_hw": LOFTR_HW,
            "widths": dict(pf.LOFTR_KW), "cudnn_deterministic":
            torch.backends.cudnn.deterministic,
            "launches": {}, "pairs_per_s": b / ms * 1e3, "forward_ms": ms,
            "device_busy_ms": busy, "peak_mem_gb": peak_gb,
            "valid_per_pair": out["valid"].sum(-1).tolist(),
            "coarse_conf_max": out["coarse_conf"].max().item(),
            "cpu_pairs": 2, "coarse_conf_max_abs_err": conf_err,
            "coarse_conf_tol": conf_tol,
            "coarse_conf_rtol": LOFTR_CONF_RTOL,
            "row_argmax_agree": argmax_agree,
            "row_argmax_gap": pick_gap,
            "valid_agree": valid_agree,
            "cells_agree": same_cells.float().mean().item(),
            "mkpts1_max_err_px_valid": px_valid,
            "mkpts1_max_err_px_all_rows": px_cells,
            "mkpts1_tol_px": LOFTR_PX_TOL}


@contextlib.contextmanager
def recorded_kernel_calls(sinkhorn=False):
    """Records every call OETR makes to K2's and K3's wrappers (and with
    ``sinkhorn`` every call SuperGlue makes to the transport around K4:
    K4's own wrapper counts its launches under its module name), as
    {wrapper name: [(args, kwargs, output), ...]}, passing each on. The
    tensors are copies taken at the call: a train step updates the
    parameters among the arguments in place after its forward."""
    from oetr_tpu_torch.models import resnet, superglue, transformer

    calls = {}
    names = [(transformer, "linear_encoder_attention"),
             (resnet, "groupnorm_relu_maxpool")]
    if sinkhorn:
        names.append((superglue, "log_optimal_transport"))
    sites = [(mod, name, getattr(mod, name)) for mod, name in names]

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            copy = lambda a: a.detach().clone() if hasattr(a, "detach") \
                else a
            calls.setdefault(name, []).append(
                (tuple(copy(a) for a in args),
                 {k: copy(v) for k, v in kwargs.items()}, copy(out)))
            return out
        return call

    try:
        for mod, name, fn in sites:
            setattr(mod, name, recorder(name, fn))
        yield calls
    finally:
        for mod, name, fn in sites:
            setattr(mod, name, fn)


def recorded_kernel_errors(torch, ops, calls, path="dense"):
    """Each recorded output of K2, K3 and the transport with K4 against
    the plain version on the same inputs, at the kernel checks' tolerances
    (K2: 2 bf16 ulps or 1e-4, K3: 1 ulp or 1e-5, of max(1, the plain
    output's largest magnitude); K4: ``k4_compare``'s). Returns {name:
    {"calls", "input", "max_abs_err", "max_err_over_tol"}}; raises where
    an output is outside its tolerance."""
    plain_transport = lambda *args, **kwargs: ops.log_optimal_transport(
        *args, **dict(kwargs, use_cuda=False))
    plain = {"linear_encoder_attention":
             (ops.linear_encoder_attention_reference, 2, 1e-4),
             "groupnorm_relu_maxpool":
             (ops.groupnorm_relu_maxpool_reference, 1, 1e-5),
             "log_optimal_transport": (plain_transport, None, None)}
    result = {}
    for name, recorded in calls.items():
        reference, ulps, rel = plain[name]
        errs, ratios = [], []
        for args, kwargs, out in recorded:
            ref = reference(*args, **kwargs).float()
            if tuple(out.shape) != tuple(ref.shape):
                raise AssertionError(f"{name} on the {path} path: shape "
                                     f"{tuple(out.shape)}")
            if ulps is None:
                err, ratio = k4_compare(torch, out, ref)
            else:
                err = (out.float() - ref).abs().max().item()
                dtype_name = str(args[0].dtype).removeprefix("torch.")
                ratio = err / tolerance(dtype_name, ref.abs().max().item(),
                                        ulps, rel)
            if not ratio <= 1.0:
                raise AssertionError(f"{name} on the {path} path, input "
                                     f"{tuple(args[0].shape)}: max_abs_err "
                                     f"{err}, {ratio:.2f} x its tolerance")
            errs.append(err)
            ratios.append(ratio)
        result[name] = {"calls": len(recorded), "input": list(
            recorded[0][0][0].shape), "max_abs_err": max(errs),
            "max_err_over_tol": max(ratios)}
    return result


def dense_pipeline(port, oetr, loftr, min_matches):
    cfg = port.PipelineConfig(canvas_hw=(CANVAS_HW, CANVAS_HW),
                              oetr_hw=(IMAGE_HW, IMAGE_HW),
                              fallback_min_matches=min_matches,
                              retry_batch=2, box_source="heatmap")
    return port.DensePipeline(loftr, oetr=oetr, cfg=cfg)


def slot_agreement(a, b):
    """Share of the K slots of every pair where two dense outputs agree:
    the same validity and image-0 position, the image-1 position within
    LOFTR_PX_TOL."""
    same = ((a["valid"] == b["valid"])
            & ((a["mkpts0"] - b["mkpts0"]).abs().amax(-1) <= LOFTR_PX_TOL)
            & ((a["mkpts1"] - b["mkpts1"]).abs().amax(-1) <= LOFTR_PX_TOL))
    return same.float().mean().item()


def run_dense(torch, port, ops, b):
    """The dense pipeline on b scene pairs: OETR in bf16 with K2 and K3 on
    against ``oetr_r50_config()`` (switches off), one LoFTR in f32 for
    both. Returns the ``dense`` and ``dense_retry`` phase fields and the
    main path's launches."""
    from oetr_tpu_torch import profile_forward as pf

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    cfg_on = port.oetr_r50_kernels_config("bfloat16")
    cfg_off = port.replace(port.oetr_r50_config(), dtype="bfloat16")
    oetr_on = port.build_oetr(cfg_on, device=DEV,
                              generator=torch.Generator().manual_seed(0))
    oetr_off = port.build_oetr(cfg_off, device=DEV,
                               generator=torch.Generator().manual_seed(1))
    oetr_off.load_state_dict(oetr_on.state_dict())
    loftr = pf.loftr_model(DEV)
    pipe_on = dense_pipeline(port, oetr_on, loftr, 0)
    pipe_off = dense_pipeline(port, oetr_off, loftr, 0)
    args, _ = scene_inputs(b, seed=9)
    tol = BOX_TOL_PX["bfloat16"] * CANVAS_HW / IMAGE_HW

    with torch.inference_mode():
        pipe_on(*args)      # cuDNN times LoFTR's convolutions at 832²
        torch.cuda.synchronize()
        # The main path, once, with the launch counts read around it.
        reset_counts(ops)
        torch.cuda.reset_peak_memory_stats()
        out = pipe_on(*args)
        torch.cuda.synchronize()
        launches = launch_counts(ops)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {name: 0 for name in KERNELS}
        want.update(linear_encoder_attention=16, groupnorm_relu_maxpool=1)
        if launches != want:
            raise AssertionError(f"dense launches {launches} != {want}")
        ref = pipe_off(*args)
        torch.cuda.synchronize()
        # With seeded weights every heatmap box is the full frame and no
        # LoFTR slot is valid, so the pipeline's outputs cannot see a wrong
        # K2 or K3. So the path's OETR pass once more: every K2 and K3 output
        # against its plain version on the inputs the path gave it, and
        # OETR's raw outputs with the switches on against off.
        with recorded_kernel_calls() as calls:
            raw_on = oetr_on(args[4], args[5])
        kernel_errs = recorded_kernel_errors(torch, ops, calls)
        if {k: v["calls"] for k, v in kernel_errs.items()} != {
                k: n for k, n in want.items() if n}:
            raise AssertionError(f"dense: recorded kernel calls "
                                 f"{kernel_errs}")
        del calls
        raw_off = oetr_off(args[4], args[5])
        check_outputs(torch, cfg_on, raw_on, b, IMAGE_HW, "dense kernels")
        check_outputs(torch, cfg_off, raw_off, b, IMAGE_HW, "dense plain")
        oetr_px = box_diff_px(port, raw_on, raw_off, IMAGE_HW)
        raw_diff = {k: (raw_on[k].float() - raw_off[k].float()).abs().max()
                    .item() for k in ("tlbr1", "tlbr2", "prob_map1",
                                      "prob_map2")}
        if not oetr_px <= BOX_TOL_PX["bfloat16"]:
            raise AssertionError(f"dense: OETR on vs off {oetr_px} px > "
                                 f"{BOX_TOL_PX['bfloat16']}")
        box = max((out[k] - ref[k]).abs().max().item()
                  for k in ("bbox0", "bbox1"))
        agree = slot_agreement(out, ref)
        if not (box <= tol and agree >= MATCH_AGREE_MIN and torch.equal(
                out["used_overlap"], ref["used_overlap"])):
            raise AssertionError(f"dense on vs off: boxes {box} px apart "
                                 f"(tol {tol}), slots agree {agree}, used "
                                 f"{out['used_overlap']} / "
                                 f"{ref['used_overlap']}")
        fields = {
            "pairs": b, "canvas_hw": CANVAS_HW, "oetr_hw": IMAGE_HW,
            "oetr_dtype": "bfloat16", "loftr_dtype": "float32",
            "launches_per_call": {k: n for k, n in launches.items() if n},
            "path_kernels_vs_plain": kernel_errs,
            "oetr_box_max_diff_px": oetr_px,
            "oetr_box_tol_px": BOX_TOL_PX["bfloat16"],
            "oetr_raw_max_diff": raw_diff,
            "box_max_diff_px": box, "box_tol_px": tol,
            "slots_agree": agree, "agree_min": MATCH_AGREE_MIN,
            "used_overlap": out["used_overlap"].tolist(),
            "matches_per_pair": out["num_matches"].tolist(),
            "bbox0": [[round(v, 2) for v in row]
                      for row in out["bbox0"].tolist()],
            "peak_mem_gb_one_call": peak_gb}
        del pipe_off, oetr_off, raw_on, raw_off

        # One call with the reference's rule: < 30 matches -> full image.
        need = ((out["num_matches"] < 30) & out["used_overlap"]).cpu()
        n_retry = int(need.sum())
        reset_counts(ops)
        retried = dense_pipeline(port, oetr_on, loftr, 30)(*args)
        torch.cuda.synchronize()
        retry_launches = launch_counts(ops)
        used_after = retried["used_overlap"].cpu()
        plain = pipe_on._run(*[a[need.to(DEV)] for a in args[:4]])
        if n_retry < 1 or retry_launches != want or not (
                torch.equal(used_after, out["used_overlap"].cpu() & ~need)
                and torch.equal(retried["num_matches"][need.to(DEV)],
                                plain["num_matches"])):
            raise AssertionError(f"dense retry: {n_retry} pairs, launches "
                                 f"{retry_launches}, used {used_after}")
        retry = {"fallback_min_matches": 30, "retry_batch": 2,
                 "pairs_retried": n_retry,
                 "launches": {k: n for k, n in retry_launches.items() if n},
                 "matches_per_pair": retried["num_matches"].tolist()}
    return fields, retry, launches


def run_scenes(torch, port, b):
    """The port's scene generator on the card (bench stage 5's settings),
    its ground-truth boxes against ``overlap_bbox_pair`` on the CPU on the
    same tensors. Stage 5's pipeline on its pairs is the ``trained``
    phase's. Returns the phase fields."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.geometry.overlap import overlap_bbox_pair

    gen_ms = time_ms(torch, lambda: pf.scene_pairs(CANVAS_HW, b, 7, DEV),
                     reps=3, warmup=1)
    raw = pf.scene_pairs(CANVAS_HW, b, 7, device=DEV)
    names = ("K1", "depth1", "pose1", "crop1", "ratio1", "K2", "depth2",
             "pose2", "crop2", "ratio2")
    box1, _, box2, _, valid = overlap_bbox_pair(*(raw[n].cpu()
                                                  for n in names))
    gt_equal = (torch.equal(box1, raw["overlap_box1"].cpu())
                and torch.equal(box2, raw["overlap_box2"].cpu())
                and torch.equal(valid, raw["overlap_valid"].cpu()))
    img = raw["image1"]
    levels = img * 255.0
    s = raw["scale"]
    lo, hi = pf.SCENE_KW["scale_range"]
    in_range = ((s == 1.0) | ((s >= lo) & (s <= hi))).all()
    if not (gt_equal and bool(in_range) and 0.0 <= img.min().item()
            and img.max().item() <= 1.0
            and (levels - levels.round()).abs().max().item() <= 1e-3):
        raise AssertionError(f"scenes: GT boxes equal to the CPU's "
                             f"{gt_equal}, scales {s.tolist()}")
    return {"pairs": b, "canvas_hw": CANVAS_HW,
            "generator": {**pf.SCENE_KW, "ms": gen_ms,
                          "translated_pairs": int((s == 1.0).sum()),
                          "scale": [round(v, 4) for v in s.tolist()]},
            "gt_boxes_equal_cpu": gt_equal,
            "overlap_box1": raw["overlap_box1"].tolist()}


# ------------------------------------------------------------------ pose --

@contextlib.contextmanager
def pose_draws(replay=None, device=None):
    """Records the estimator's draws of one call by stage ({stage: tensor},
    ``replay`` None), or hands it the draws ``replay`` copied to
    ``device``."""
    from oetr_tpu_torch.geometry import draws

    real, log = draws.gumbel, {}

    def recording(stage, shape, generator):
        log[stage] = real(stage, shape, generator)
        return log[stage]

    def replaying(stage, shape, generator):
        g = replay[stage]
        if tuple(g.shape) != tuple(shape):
            raise AssertionError(f"draw {stage}: {tuple(g.shape)} != {shape}")
        return g.to(device)

    draws.gumbel = recording if replay is None else replaying
    try:
        yield log
    finally:
        draws.gumbel = real


@contextlib.contextmanager
def recorded_eigh_inputs():
    """Records the input of every eigh call, passing each on."""
    from oetr_tpu_torch.geometry import homography, ransac
    from oetr_tpu_torch.ops import small_eigh
    from oetr_tpu_torch.sfm import ba

    calls, real = [], small_eigh.eigh

    def recorder(A):
        calls.append(A)
        return real(A)

    sites = (small_eigh, homography, ransac, ba)
    try:
        for mod in sites:
            mod.eigh = recorder
        yield calls
    finally:
        for mod in sites:
            mod.eigh = real


def eigh_errors(torch, ops, calls):
    """Each recorded eigh input through the kernel against LAPACK's syevd
    (the plain version) on the host, relative to each matrix's largest
    |eigenvalue|: eigenvalues, the residual |A V - V diag(w)| and the
    orthogonality of V. Raises beyond EIGH_TOL. Returns the fields."""
    worst = {"eigenvalues": 0.0, "residual": 0.0, "orthogonality": 0.0}
    abs_err, shapes = 0.0, collections.Counter()
    for A in calls:
        w, V = ops.eigh(A)
        w_ref, _ = ops.eigh_reference(A.cpu())
        w, V, Ac = w.cpu().double(), V.cpu().double(), A.cpu().double()
        scale = w_ref.double().abs().amax(-1, keepdim=True).clamp(min=1e-30)
        n = A.shape[-1]
        errs = {"eigenvalues": ((w - w_ref.double()).abs() / scale).max(),
                "residual": ((Ac @ V - V * w[..., None, :]).abs().amax(-1)
                             / scale).max(),
                "orthogonality": (V.transpose(-1, -2) @ V - torch.eye(
                    n, dtype=torch.float64)).abs().max()}
        for k, v in errs.items():
            worst[k] = max(worst[k], v.item())
        abs_err = max(abs_err, (w - w_ref.double()).abs().max().item())
        if not bool((w[..., 1:] >= w[..., :-1]).all()):
            raise AssertionError("eigh: eigenvalues not ascending")
        shapes[str(list(A.shape))] += 1
    if not max(worst.values()) <= EIGH_TOL:
        raise AssertionError(f"eigh kernel vs LAPACK: {worst} > {EIGH_TOL}")
    return {"calls": len(calls), "shapes": dict(shapes), "tol": EIGH_TOL,
            "max_rel_err": worst, "max_abs_err": abs_err}


def eigh_by_shape(torch, eigh, calls, reps=10):
    """Per distinct shape of the recorded ``calls``, largest first: the
    calls of that shape, the device ms of ``eigh`` and of torch.linalg.eigh
    on its first input, and the bound: each matrix read once and w, V
    written once, and ~9 n³ flops a matrix, what a symmetric
    eigendecomposition with vectors needs (Householder tridiagonalization
    and implicit QL, Golub & Van Loan §8.3), not the Jacobi sweeps'."""
    first, count = {}, collections.Counter()
    for a in calls:
        first.setdefault(tuple(a.shape), a)
        count[tuple(a.shape)] += 1
    rows = []
    for shape, a in sorted(first.items(), key=lambda kv: -kv[1].numel()):
        batch, n = a.numel() // (shape[-1] ** 2), shape[-1]
        w, V = eigh(a)
        bnd, bound_by = bound(nbytes(a, w, V), batch * 9 * n ** 3, "float32")
        rows.append({"shape": list(shape), "calls": count[shape],
                     "device_ms": device_ms(torch, lambda: eigh(a), reps),
                     "library_device_ms": device_ms(
                         torch, lambda: torch.linalg.eigh(a), reps),
                     "bound_ms": bnd, "bound_by": bound_by})
    return rows


def eigh_row(torch, ops, calls):
    """The eigh kernel's row of the kernels line: ``eigh_by_shape`` of the
    path's calls and their sum over the path; and on the largest call,
    A [8, 512, 9, 9] (round 1's normal matrices), the wrapper's ms, LAPACK
    on the host (the plain version) and torch.linalg.eigh's ms."""
    by_shape = eigh_by_shape(torch, ops.eigh, calls)
    top = by_shape[0]
    a = next(a for a in calls if list(a.shape) == top["shape"])
    host = a.cpu()
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        ops.eigh_reference(host)
        t.append((time.perf_counter() - t0) * 1e3)
    return {"shape": top["shape"], "matrices": host.numel() // (
                host.shape[-1] ** 2),
            "kernel_ms": time_ms(torch, lambda: ops.eigh(a)),
            "device_ms": top["device_ms"],
            "plain_ms": statistics.median(t),
            "plain": "LAPACK syevd on the host (scipy), the CPU path",
            "library_ms": time_ms(torch, lambda: torch.linalg.eigh(a)),
            "library_device_ms": top["library_device_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "by_shape": by_shape,
            "path_device_ms": sum(r["calls"] * r["device_ms"]
                                  for r in by_shape)}


def traced_stats(torch, fn, reps=1, names=(), warmup=1, cpu=True,
                 top_kernels=0):
    """Per call of ``fn()`` in a trace of ``reps`` calls (``trace_calls``,
    after ``warmup`` calls): wall ms, device busy ms (and by
    profile_forward's kernel categories, with the ``top_kernels`` kernels
    by device time when asked), the idle share, kernel launches (and those of
    the kernels whose names hold each of ``names``), device -> host
    copies, and with ``cpu`` (a slower trace) the CPU ops that read a
    value back (``device_reads``)."""
    from oetr_tpu_torch.profile_forward import category
    from oetr_tpu_torch.utils.profiling import PAD_KERNEL, PADS

    prof, dev, wall, taken = trace_calls(torch, fn, reps, warmup, cpu=cpu)
    pads = sum(e.device_type == torch.autograd.DeviceType.CUDA
               and PAD_KERNEL in e.name for e in prof.events())
    by_category, by_name = collections.Counter(), collections.Counter()
    for e in dev:
        ms = e.time_range.elapsed_us() / 1e3 / reps
        by_category[category(e.name)] += ms
        by_name[e.name[:90]] += ms
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    dtoh = [e for e in copies if "DtoH" in e.name]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
    readers = collections.Counter()
    for e in prof.events():
        if e.name in ("aten::_local_scalar_dense", "aten::nonzero",
                      "aten::item"):
            top = e
            while top.cpu_parent is not None:
                top = top.cpu_parent
            readers[f"{e.name} in {top.name}"] += 1
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "launches_per_call": (len(dev) - len(copies)) / reps,
            "dtoh_copies_per_call": len(dtoh) / reps,
            **({"device_reads": dict(readers)} if cpu else {}),
            "traces_taken": taken,
            "pad_events_missed": 2 * PADS - pads,
            "device_ms_by_category": dict(by_category.most_common()),
            **({"top_kernels_ms": dict(by_name.most_common(top_kernels))}
               if top_kernels else {}),
            **{f"{name}_per_call": sum(name in e.name for e in dev) / reps
               for name in names}}


def score_matches(torch, port, out, raw, seed=16):
    """A sparse pipeline's matches (``out``, keypoints in the canvas frame)
    scored against the generator's true relative poses (``raw``) with
    ``estimate_pose`` at JAX's defaults: matches a pair, pairs with a pose,
    AUC@5/10/20 of max(err_R, err_t) (inf without a pose) and the median
    errors in degrees."""
    from oetr_tpu_torch.geometry.overlap import rigid_inverse

    m0 = out["matches0"]
    valid = m0 > -1
    k1 = torch.gather(out["keypoints1"].float(), 1,
                      m0.clamp(min=0)[..., None].expand(-1, -1, 2))
    res = port.estimate_pose(out["keypoints0"].float(), k1, valid,
                             raw["K1"], raw["K2"],
                             torch.Generator(device=DEV).manual_seed(seed))
    T = raw["pose2"] @ rigid_inverse(raw["pose1"])
    et, eR = port.pose_error(T, res["R"], res["t"])
    ok = res["ok"]
    err = torch.where(ok, torch.maximum(et, eR), float("inf"))
    median = lambda e: (statistics.median(e[ok].tolist()) if ok.any()
                        else None)
    return {"matches_per_pair": valid.sum(-1).tolist(),
            "pairs_ok": int(ok.sum()),
            "pose_auc@5/10/20": port.pose_auc(err.tolist(), [5, 10, 20]),
            "median_err_R_deg": median(eR), "median_err_t_deg": median(et)}


def pose_case(torch, port, d, use_5pt, seed, device=None, replay=None,
              linalg=None):
    """estimate_pose with JAX's defaults on the problems ``d`` (on
    ``device``, DEV by default); its draws from a generator seeded
    ``seed``, or ``replay``; with ``linalg`` (an earlier call's stages)
    every eigh and svd3 result taken from that call instead. Returns
    (result, per-pair errors, the draws, the route whose candidate won
    each pair's vote: 'H' (a homography decomposition), 'P&P' (plane and
    parallax) or 'E' (the LO-RANSAC's pose), as the estimator's vote
    picked it, the stages recorded)."""
    from oetr_tpu_torch.geometry.ransac import VOTE_ROUTES
    from oetr_tpu_torch.pose_parting import recorded

    device = device or DEV
    d = {k: v.to(device) for k, v in d.items()}
    with pose_draws(replay, device) as log, recorded(linalg) as stages:
        res = port.estimate_pose(
            d["kpts0"], d["kpts1"], d["valid"], d["K"], d["K"],
            torch.Generator(device=device).manual_seed(seed),
            use_5pt=use_5pt)
    err_t, err_R = port.pose_error(d["T_0to1"], res["R"], res["t"])
    routes = [VOTE_ROUTES[i] for i in stages["_vote"][0][1].tolist()]
    return (res, (err_R.cpu(), err_t.cpu()),
            log if replay is None else replay, routes, stages)


def run_pose(torch, port, ops):
    """Two-view pose on the card (``estimate_pose`` with JAX's defaults,
    B = 8, N = 2048): general scenes (the ground truth within
    POSE_GT_R_DEG / POSE_GT_T_DEG on the card and on the CPU, no padded
    slot an inlier) and the scene generator's planar pairs, with the
    5-point stage off (the card's default) and on; the card against the
    CPU given the card's eigh and svd3 results on the same inputs and
    draws (bounded), and against the plain CPU (read); the eigh kernel on
    every call of the path against LAPACK; times (stage 5's matches are
    scored in the ``trained`` phase). Returns the phase fields (``failures`` lists the cases out of
    bounds; the phase goes on to its readings) and the eigh kernel's
    row."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.geometry import draws, normalize_keypoints
    from oetr_tpu_torch.geometry.fivepoint import five_point_hypotheses
    from oetr_tpu_torch.geometry.homography import sample_minimal_sets
    from oetr_tpu_torch.pose_parting import parting

    general = pf.general_pose_pairs(
        pf.POSE_PAIRS, torch.Generator(device=DEV).manual_seed(11))
    planar = pf.planar_pose_pairs(
        pf.scene_pairs(CANVAS_HW, pf.POSE_PAIRS, 13, device=DEV),
        torch.Generator(device=DEV).manual_seed(14))
    fields = {"pairs": general["valid"].shape[0],
              "slots": general["valid"].shape[1],
              "true": int(general["valid"][0].sum()), "hw": CANVAS_HW,
              "dtype": "float32",
              "num_hypotheses": 512, "lo_candidates": 8,
              "planar_fallback": True}
    start, seconds = time.perf_counter(), {}

    def lap(part):
        seconds[part] = time.perf_counter() - start - sum(seconds.values())

    with torch.inference_mode():
        # The main path, once, with the launch counts read around it.
        reset_counts(ops)
        with recorded_eigh_inputs() as eigh_calls:
            pose_case(torch, port, general, False, 12)
            torch.cuda.synchronize()
        launches = launch_counts(ops)
        if launches["eigh"] == 0 or any(n for k, n in launches.items()
                                        if k != "eigh"):
            raise AssertionError(f"pose launches {launches}")
        fields["launches"] = {k: n for k, n in launches.items() if n}
        fields["eigh"] = eigh_errors(torch, ops, eigh_calls)
        row = eigh_row(torch, ops, eigh_calls)
        row.update(launches=launches["eigh"],
                   max_abs_err=fields["eigh"]["max_abs_err"])
        fields["eigh_kernel"] = row
        lap("main_path_and_eigh")

        failures = []
        for name, d, seed in (("general", general, 12), ("planar", planar,
                                                          15)):
            out = {}
            for use_5pt in (False, True):
                res, (eR, et), log, route, stages = pose_case(
                    torch, port, d, use_5pt, seed)
                given, (gR, gt), _, given_route, _ = pose_case(
                    torch, port, d, use_5pt, seed, device="cpu", replay=log,
                    linalg=stages)
                cpu, (cR, ct), _, cpu_route, _ = pose_case(
                    torch, port, d, use_5pt, seed, device="cpu", replay=log)
                del stages

                def gap(a, b):
                    deg, rel = parting(d["T_0to1"].cpu(), a, b)
                    return deg.max().item(), rel.max().item()

                deg, dn = gap(res, cpu)
                given_deg, given_dn = gap(res, given)
                n_card = res["num_inliers"].cpu()
                padded = bool((res["inliers"] & ~d["valid"]).any())
                case = {"err_R_deg": eR.tolist(), "err_t_deg": et.tolist(),
                        "ok": res["ok"].tolist(),
                        "num_inliers": n_card.tolist(),
                        "valid": d["valid"].sum(-1).tolist(),
                        "route": route, "cpu_route": cpu_route,
                        "cpu_err_R_deg": cR.tolist(),
                        "cpu_err_t_deg": ct.tolist(),
                        "cpu_num_inliers": cpu["num_inliers"].tolist(),
                        "card_vs_cpu_max_deg": deg,
                        "card_vs_cpu_inliers_max_rel": dn,
                        "given_cpu_route": given_route,
                        "given_cpu_err_R_deg": gR.tolist(),
                        "given_cpu_err_t_deg": gt.tolist(),
                        "given_cpu_num_inliers":
                            given["num_inliers"].tolist(),
                        "card_vs_given_cpu_max_deg": given_deg,
                        "card_vs_given_cpu_inliers_max_rel": given_dn,
                        "padded_inliers": padded}
                checks = {
                    "card_vs_given_cpu": given_deg <= POSE_CPU_DEG
                    and given_dn <= POSE_CPU_INLIERS,
                    "no_padded_inlier": not padded}
                if name == "general":
                    checks["truth"] = all(
                        bool(r["ok"].all()) and R.max().item() < POSE_GT_R_DEG
                        and t.max().item() < POSE_GT_T_DEG
                        for r, R, t in ((res, eR, et), (cpu, cR, ct)))
                failed = [k for k, v in checks.items() if not v]
                if failed:
                    failures.append(f"{name} use_5pt={use_5pt}: "
                                    f"{', '.join(failed)}")
                out[f"use_5pt={use_5pt}"] = case
            fields[name] = out
        fields["failures"] = failures
        lap("card_vs_cpu")
        fields["bounds"] = {"gt_R_deg": POSE_GT_R_DEG,
                            "gt_t_deg": POSE_GT_T_DEG,
                            "gt_holds_for": "the card and the CPU",
                            "card_vs_given_cpu_deg": POSE_CPU_DEG,
                            "card_vs_given_cpu_inliers": POSE_CPU_INLIERS,
                            "read_only": "card_vs_cpu (the plain CPU; the "
                                         "CPU's own spread: pose_parting "
                                         "--spread)"}

        # Times on the card, B = 8, N = 2048.
        timing = {}
        for use_5pt in (False, True):
            gen = torch.Generator(device=DEV)

            def call():
                gen.manual_seed(12)
                return port.estimate_pose(
                    general["kpts0"], general["kpts1"], general["valid"],
                    general["K"], general["K"], gen, use_5pt=use_5pt)

            ms = time_ms(torch, call, reps=3, warmup=1)
            stats = traced_stats(torch, call)
            if not use_5pt and stats["dtoh_copies_per_call"] != 0:
                raise AssertionError(f"pose, use_5pt off: device -> host "
                                     f"copies {stats}")
            timing[f"use_5pt={use_5pt}"] = {"ms_per_call": ms,
                                             "pairs_per_s": pf.POSE_PAIRS
                                             / ms * 1e3, **stats}
        k0n = normalize_keypoints(general["kpts0"], general["K"])
        k1n = normalize_keypoints(general["kpts1"], general["K"])
        g5 = draws.gumbel("five_point", general["valid"].shape[:1] + (
            128,) + general["valid"].shape[1:],
                          torch.Generator(device=DEV).manual_seed(17))
        idx5 = sample_minimal_sets(g5, general["valid"], 5)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            five_point_hypotheses(k0n, k1n, idx5)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        timing["five_point_host_ms"] = statistics.median(host)
        traced = timing["use_5pt=False"]
        row.update(traced_pose_device_ms=traced["device_ms_by_category"].get(
                       "small eigh (Jacobi)", 0.0),
                   traced_pose_busy_ms=traced["device_busy_ms"])
        timing["five_point_samples"] = pf.POSE_PAIRS * 128
        fields["timing"] = timing
        lap("timing")
    fields["seconds"] = seconds
    return fields, row


# ----------------------------------------------------------------- train --

def finite(metrics) -> bool:
    return all(bool(v.isfinite().all()) for v in metrics.values())


def set_dropout(model, rate):
    from oetr_tpu_torch.models.transformer import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate


def run_train(torch, port, ops):
    """OETR training at full width: the flagship (ResNet50 to layer3,
    d_model 256, 4 x (self + cross), 2 decoder layers) in f32 with K2 and
    K3 on, 8 pairs of 640² a step from the device generator
    (overlap_ab_demo.py's defaults: scale 1.8-3.2, no translation), seeded
    weights, TrainConfig's defaults (AdamW lr 1e-4, weight decay 1e-2),
    cycle=True; TF32 off, cuDNN's deterministic algorithms. (1) The main
    path, one step, its launch counts read around it and every K2 and K3
    output of its forward held to the plain version on the same inputs.
    (2) One step with the kernels on against off (``oetr_r50_config()``),
    same weights, batch and generator, dropout off: the losses within
    TRAIN_LOSS_RTOL, the global gradient norm within TRAIN_NORM_RTOL, and
    each parameter's gradient at the grad phase's bounds. (3) One step with
    every loss switch on. (4) Three timed steps after one warm-up with
    cuDNN's defaults: ms a step, pairs/s, peak memory; then a trace: K2's
    and K3's CUDA launches a step, device -> host copies (none), busy ms
    by kind of kernel, idle share. (1), (2), (3) and (5) use cuDNN's
    deterministic algorithms. (5) A
    checkpoint saved after step 2, in JAX's orbax TrainState layout, and
    loaded into a fresh state: its step 3 equals the uninterrupted step 3,
    bit for bit; the bytes and the seconds to write and to read; then
    ``export_params`` on its directory (the params store read back equal
    to the loaded model) and ``probe_heatmap_boxes``'s box half on the
    read-back state (``probe_state``). Every loss finite. Returns (fields,
    the main path's launches, the probe's launches)."""
    import tempfile

    from oetr_tpu_torch.training import (create_train_state,
                                         global_grad_norm, load_checkpoint,
                                         make_train_step, save_checkpoint)

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    tcfg = port.TrainConfig()
    b = tcfg.batch_size
    synth = port.make_device_generator(IMAGE_HW, b, scale_range=(1.8, 3.2),
                                       p_translate=0.0, device=DEV)
    batches = [synth(torch.Generator(device=DEV).manual_seed(70 + i))
               for i in range(3)]
    cfg_on = port.oetr_r50_kernels_config("float32")
    cfg_off = port.oetr_r50_config()
    gen = lambda seed: torch.Generator(device=DEV).manual_seed(seed)

    def fresh(cfg, seed):
        return create_train_state(cfg, tcfg,
                                  torch.Generator().manual_seed(seed),
                                  device=DEV)[1]

    step = make_train_step(cycle=True)
    want = {name: 0 for name in KERNELS}
    want.update(linear_encoder_attention=4 * cfg_on.neck.num_layers,
                groupnorm_relu_maxpool=1)
    fields = {"model": "oetr_r50_kernels_config('float32')",
              "pairs": b, "image_hw": IMAGE_HW, "dtype": "float32",
              "lr": tcfg.lr, "weight_decay": tcfg.weight_decay,
              "cycle": True, "weights": "seeded",
              "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
              "tf32_cudnn": torch.backends.cudnn.allow_tf32,
              "cudnn_deterministic": torch.backends.cudnn.deterministic}

    # (1) The main path, once, with the launch counts read around it.
    on = fresh(cfg_on, 0)
    reset_counts(ops)
    with recorded_kernel_calls() as calls:
        on, metrics = step(on, batches[0], gen(80))
        torch.cuda.synchronize()
    launches = launch_counts(ops)
    if launches != want or not finite(metrics):
        raise AssertionError(f"train launches {launches} != {want}, or a "
                             f"loss not finite: {metrics}")
    with torch.no_grad():
        fields["path_kernels_vs_plain"] = recorded_kernel_errors(
            torch, ops, calls, "train")
    del calls
    fields["launches_per_step"] = {k: n for k, n in launches.items() if n}
    fields["losses_step1"] = {k: v.item() for k, v in metrics.items()}

    # (2) Kernels on against off: the same weights, batch and generator,
    # dropout off on both.
    off = fresh(cfg_off, 1)
    off.model.load_state_dict(on.model.state_dict())
    runs = {}
    for tag, st in (("on", on), ("off", off)):
        set_dropout(st.model, 0.0)
        _, m = step(st, batches[1], gen(81))
        runs[tag] = (m, global_grad_norm(st.model).item())
        set_dropout(st.model, 0.1)
    (m_on, n_on), (m_off, n_off) = runs["on"], runs["off"]
    rel = {k: abs(m_on[k].item() - m_off[k].item())
           / max(abs(m_off[k].item()), 1e-12) for k in m_off}
    worst = {"rel": (0.0, None), "cos": (1.0, None)}
    ref = dict(off.model.named_parameters())
    for name, p in on.model.named_parameters():
        r = ref[name].grad
        if name.startswith("backbone."):
            cos = torch.nn.functional.cosine_similarity(
                p.grad.double().flatten(), r.double().flatten(), dim=0).item()
            if cos < worst["cos"][0]:
                worst["cos"] = (cos, name)
        else:
            d = (p.grad - r).abs().max().item() / max(1.0, r.abs().max()
                                                     .item())
            if d > worst["rel"][0]:
                worst["rel"] = (d, name)
    norm_rel = abs(n_on - n_off) / n_off
    if not (rel["loss"] <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
            and worst["rel"][0] <= OETR_GRAD_TOL
            and worst["cos"][0] >= OETR_BACKBONE_COS
            and finite(m_on) and finite(m_off)):
        raise AssertionError(f"train on vs off: losses {rel}, grad norm "
                             f"{n_on} vs {n_off}, gradients {worst}")
    fields["on_vs_off"] = {
        "loss_on": m_on["loss"].item(), "loss_off": m_off["loss"].item(),
        "loss_rel_diff": rel["loss"], "loss_rtol": TRAIN_LOSS_RTOL,
        "max_entry_rel_diff": max(rel.values()),
        "grad_norm_on": n_on, "grad_norm_off": n_off,
        "grad_norm_rel_diff": norm_rel, "grad_norm_rtol": TRAIN_NORM_RTOL,
        "max_rel_grad_diff_outside_backbone": worst["rel"][0],
        "worst_outside_backbone": worst["rel"][1], "tol": OETR_GRAD_TOL,
        "min_backbone_grad_cosine": worst["cos"][0],
        "worst_backbone_cosine_parameter": worst["cos"][1],
        "backbone_cosine_min": OETR_BACKBONE_COS, "dropout": 0.0}
    del off, ref, runs

    # (3) Every loss switch on.
    every = make_train_step(cycle=True, full_cycle=True,
                            aux_match_weight=1.0, heatmap_weight=1.0,
                            size_weight=1.0, reweight_power=1.0)
    reset_counts(ops)
    on, m_every = every(on, batches[2], gen(82))
    torch.cuda.synchronize()
    every_launches = launch_counts(ops)
    if every_launches != want or not finite(m_every):
        raise AssertionError(f"train, every loss: launches "
                             f"{every_launches}, losses {m_every}")
    fields["every_loss_switch"] = {
        "switches": "full_cycle, aux_match 1.0, heatmap 1.0, size_loss 1.0, "
                    "reweight 1.0",
        "losses": {k: v.item() for k, v in m_every.items()}}

    # (4) Times: three steps after one warm-up; then a trace.
    g = gen(83)
    seen = []

    def call():
        _, m = step(on, batches[0], g)
        seen.append(m)

    torch.cuda.reset_peak_memory_stats()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False):
        ms = time_ms(torch, call, reps=3, warmup=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = traced_stats(torch, call, names=("linear_encoder_kernel",
                                                 "gn_apply_pool_kernel"),
                             cpu=False)
    if not all(finite(m) for m in seen):
        raise AssertionError("train: a timed step's loss is not finite")
    if (stats["dtoh_copies_per_call"] != 0
            or stats["linear_encoder_kernel_per_call"] != 32
            or stats["gn_apply_pool_kernel_per_call"] != 1):
        raise AssertionError(f"train, traced step: {stats}")
    fields["timing"] = {"cudnn": "default (not deterministic, no autotune)",
                        "ms_per_step": ms, "pairs_per_s": b / ms * 1e3,
                        "peak_mem_gb": peak_gb, "steps": len(seen),
                        "traced_per_step": stats}
    del on, seen

    # (5) Checkpoint and resume: the same bits as the uninterrupted run.
    def run(st, i):
        return step(st, batches[i], gen(90 + i))[0]

    a = fresh(cfg_on, 3)
    for i in range(2):
        a = run(a, i)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, a)
        write_s = time.perf_counter() - t0
        a = run(a, 2)                     # the uninterrupted step 3
        layout = jax_layout(path)
        t0 = time.perf_counter()
        loaded = load_checkpoint(tmp, 2, fresh(cfg_on, 4))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        saved = {k: v.clone() for k, v in loaded.model.state_dict().items()}
        c = run(loaded, 2)
        sa, sc = a.model.state_dict(), c.model.state_dict()
        equal = all(torch.equal(sa[k], sc[k]) for k in sa)
        diff = max((sa[k] - sc[k]).abs().max().item() for k in sa)
        if not (equal and a.step == c.step == 3):
            raise AssertionError(f"train resume: bit-equal {equal}, max "
                                 f"diff {diff}, steps {a.step} / {c.step}")
        # load_checkpoint held the tree to optax AdamW's layout.
        fields["resume"] = {"layout": "JAX's orbax TrainState", **layout,
                            "write_s": write_s, "read_s": read_s,
                            "saved_at_step": 2, "compared_at_step": 3,
                            "bit_equal": equal, "max_abs_diff": diff}
        del a, c, sa, sc, loaded
        fields["export_params"], fields["probe"], probe_launches = \
            probe_state(torch, port, ops, tmp, saved, cfg_on, batches[0],
                        want)
    torch.cuda.empty_cache()
    return fields, launches, probe_launches


def jax_layout(path):
    """What a checkpoint directory holds: its bytes and files, and the
    ``_METADATA`` flags of JAX's orbax layout (OCDBT on, zarr v2); raises
    where they are others. Its tree's optax AdamW layout is
    ``load_checkpoint``'s check (``train.ADAMW_LAYOUT``)."""
    from pathlib import Path

    meta = json.loads((Path(path) / "_METADATA").read_text())
    checks = {"use_ocdbt": meta.get("use_ocdbt") is True,
              "zarr2": meta.get("use_zarr3") is False}
    if not all(checks.values()):
        raise AssertionError(f"checkpoint layout {path}: {checks}")
    files = [f for f in Path(path).rglob("*") if f.is_file()]
    return {"bytes": sum(f.stat().st_size for f in files),
            "files": len(files), "leaves": len(meta["tree_metadata"]),
            "metadata": checks}


def probe_state(torch, port, ops, ckpt_dir, saved, cfg, raw, want):
    """On a flagship train state in JAX's layout (``{ckpt_dir}/step_2``,
    ``saved`` its model's tensors): ``export_params`` and its store read
    back equal to the model; then ``probe_heatmap_boxes``'s box half: the
    state read into the probe's model (K2 and K3 on, f32), its forward on
    the 8 pairs of ``raw`` with the launch counts read around it (K2 16,
    K3 1; each call against its plain version), the mIoU rows against
    their GT boxes. Returns (export fields, probe fields, launches)."""
    import os
    from pathlib import Path

    import numpy as np

    from oetr_tpu_torch.interop import convert_flax_params, read_checkpoint
    from oetr_tpu_torch.scripts import export_params
    from oetr_tpu_torch.scripts import probe_heatmap_boxes as probe

    out_dir = os.path.join(ckpt_dir, "export")
    t0 = time.perf_counter()
    step, store, n = export_params.export(
        ckpt_dir, out_dir, export_params.parse_args([ckpt_dir, out_dir]))
    export_s = time.perf_counter() - t0
    exported = convert_flax_params(read_checkpoint(store), cfg)
    equal = sorted(exported) == sorted(saved) and all(
        torch.equal(exported[k], saved[k].cpu()) for k in saved)
    if not (equal and step == 2):
        raise AssertionError(f"export_params: step {step}, store equal to "
                             f"the model {equal}")
    export = {"step": step, "params": n, "seconds": export_s,
              "store_bytes": sum(f.stat().st_size for f in
                                 Path(store).rglob("*") if f.is_file()),
              "equal_to_model": equal}

    t0 = time.perf_counter()
    args = probe.parse_args(["--ckpt_dir", ckpt_dir, "--step", "2",
                             "--data_dir", ckpt_dir, "--hw", str(IMAGE_HW),
                             "--depth", "50", "--d_model", "256",
                             "--layers", "4", "--device", DEV])
    model = probe.load_model(args, DEV)
    load_s = time.perf_counter() - t0
    state = model.state_dict()
    if not all(torch.equal(state[k], saved[k]) for k in saved):
        raise AssertionError("probe: the model read back differs from the "
                             "state saved")
    img1, img2 = (raw[k].cpu().numpy() for k in ("image1", "image2"))
    gt1, gt2 = (raw[k].cpu().numpy().astype(np.float64)
                for k in ("overlap_box1", "overlap_box2"))
    reset_counts(ops)
    with recorded_kernel_calls() as calls:
        out = probe.forward(model, img1, img2)
        torch.cuda.synchronize()
    launches = launch_counts(ops)
    if launches != want:
        raise AssertionError(f"probe launches {launches} != {want}")
    with torch.no_grad():
        checks = recorded_kernel_errors(torch, ops, calls, "probe")
    rows, best_q, best = probe.box_rows(out, gt1, gt2, IMAGE_HW)
    if not all(np.isfinite(v) for r in rows.values() for v in r.values()):
        raise AssertionError(f"probe rows not finite: {rows}")
    return export, {"pairs": len(img1), "image_hw": IMAGE_HW,
                    "dtype": "float32", "load_s": load_s,
                    "launches": {k: n for k, n in launches.items() if n},
                    "kernels_vs_plain": checks, "best_q": best_q,
                    "best_miou": best, "rows": rows}, launches



# ------------------------------------------------------------------ multi --

MULTI_STEPS = 2          # steps of each layout against the one-process run
MULTI_SMALL_HW = 160     # the FSDP2 / TP check's images (10 x 10 tokens)
MULTI_SMALL_LR = 1e-2    # large enough that bf16 weights move each step
MULTI_BA_COST_RTOL = 2e-7   # BA with a group against local, of cost0
MULTI_BA_CAMS_TOL = 1e-3


def multi_small_config(port, dtype_name, attention):
    return port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, stop_layer="layer3",
                                     last_layer=256, fused_stem=True),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, max_shape=(10, 10),
                             attention=attention),
        dtype=dtype_name)


def layouts_vs_local(torch, local, other, lr, steps, loss_rtol):
    """Two runs' step metrics and parameters: losses relative to the
    local run's, the largest parameter difference against ``steps`` Adam
    steps of ``lr`` each, and whether every parameter is bit-equal."""
    (st_a, ms_a, norm_a), (st_b, ms_b, norm_b) = local, other
    rel = max(abs(b["loss"].item() - a["loss"].item())
              / max(abs(a["loss"].item()), 1e-12)
              for a, b in zip(ms_a, ms_b))
    pa = dict(st_a.model.named_parameters())
    diff, equal = 0.0, True
    for name, p in st_b.model.named_parameters():
        p = p.full_tensor() if hasattr(p, "full_tensor") else p
        d = (p.detach() - pa[name].detach()).abs().max().item()
        diff, equal = max(diff, d), equal and d == 0.0
    return {"loss_rel_diff_max": rel, "loss_rtol": loss_rtol,
            "grad_norm_local": norm_a, "grad_norm": norm_b,
            "grad_norm_rel_diff": abs(norm_b - norm_a) / norm_a,
            "grad_norm_rtol": TRAIN_NORM_RTOL,
            "param_max_abs_diff": diff, "param_bound": 2 * lr * steps,
            "bit_equal": equal and all(
                torch.equal(a["loss"], b["loss"]) for a, b in zip(ms_a, ms_b))}


def run_multi(torch, port, ops):
    """The parallel layer on the card, one rank under NCCL (the machine
    has one H100; NCCL takes one rank a device). (1) The flagship f32 train
    step (8 pairs of 640², K2 and K3 on, cuDNN deterministic, seeded
    weights) through DDP for MULTI_STEPS steps against the one-process
    step on the same weights, batches and generators: losses, gradient
    norm, parameters (``layouts_vs_local``), every K2 and K3 call of the
    DDP steps against its plain version, launches, ms a step of each,
    traced device -> host copies. (2) FSDP2 ({"data": 1, "fsdp": 1}) on a
    small config in bf16 with K2 on, lr MULTI_SMALL_LR, against local:
    each K2 call against its plain version shows that K2 never reads a
    stale bf16 weight after FSDP's gathers. (3) TP ({"data": 1, "model":
    1}) on the small config in f32, attention 'linear'. (4) bundle_adjust
    at Dubrovnik-16's counts with a group of one against local. Returns
    (fields, the launches of (1))."""
    import tempfile

    import torch.distributed as dist

    from oetr_tpu_torch.parallel import initialize_distributed, make_mesh
    from oetr_tpu_torch.sfm import bundle_adjust
    from oetr_tpu_torch.training import (create_train_state,
                                         global_grad_norm, make_train_step)
    from oetr_tpu_torch.training.train import shard_train_state

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/rendezvous", 1, 0, device=DEV)
    backend = dist.get_backend()
    if DEV == "cuda" and backend != "nccl":
        raise AssertionError(f"multi: backend {backend}, not nccl")
    fields = {"backend": backend, "world_size": dist.get_world_size(),
              "steps": MULTI_STEPS}
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    gen = lambda seed: torch.Generator(device=DEV).manual_seed(seed)

    def run(state, step, batches, seed=180):
        metrics = [step(state, b, gen(seed + i))[1]
                   for i, b in enumerate(batches)]
        return state, metrics, global_grad_norm(state.model).item()

    def check(tag, res):
        if not (res["loss_rel_diff_max"] <= res["loss_rtol"]
                and res["grad_norm_rel_diff"] <= TRAIN_NORM_RTOL
                and res["param_max_abs_diff"] <= res["param_bound"]):
            raise AssertionError(f"multi, {tag} against local: {res}")

    # (1) DDP on the flagship.
    tcfg = port.TrainConfig()
    b = tcfg.batch_size
    synth = port.make_device_generator(IMAGE_HW, b, scale_range=(1.8, 3.2),
                                       p_translate=0.0, device=DEV)
    batches = [synth(gen(170 + i)) for i in range(MULTI_STEPS)]
    cfg = port.oetr_r50_kernels_config("float32")

    def fresh(c, lr=tcfg.lr):
        return create_train_state(c, port.replace(tcfg, lr=lr),
                                  torch.Generator().manual_seed(5),
                                  device=DEV)[1]

    local_step = make_train_step(cycle=True)
    local = run(fresh(cfg), local_step, batches)
    mesh = make_mesh({"data": 1}, DEV)
    ddp, _ = shard_train_state(fresh(cfg), mesh, rules=[])
    fields["ddp_module"] = type(ddp.module).__name__
    ddp_step = make_train_step(cycle=True, group=mesh["data"].get_group())
    reset_counts(ops)
    with recorded_kernel_calls() as calls:
        ddp_run = run(ddp, ddp_step, batches)
        torch.cuda.synchronize()
    launches = launch_counts(ops)
    want = {name: 0 for name in KERNELS}
    want.update(linear_encoder_attention=4 * cfg.neck.num_layers
                * MULTI_STEPS, groupnorm_relu_maxpool=MULTI_STEPS)
    if launches != want:
        raise AssertionError(f"multi DDP launches {launches} != {want}")
    with torch.no_grad():
        kernel_errs = recorded_kernel_errors(torch, ops, calls, "multi")
    del calls
    res = layouts_vs_local(torch, local, ddp_run, tcfg.lr, MULTI_STEPS,
                           TRAIN_LOSS_RTOL)
    check("DDP", res)
    g = gen(190)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False):
        ms_local = time_ms(torch, lambda: local_step(local[0], batches[0],
                                                     g), reps=2, warmup=1)
        ms_ddp = time_ms(torch, lambda: ddp_step(ddp, batches[0], g),
                         reps=2, warmup=1)
        stats = traced_stats(torch, lambda: ddp_step(ddp, batches[0], g),
                             reps=1, names=("linear_encoder_kernel",
                                            "gn_apply_pool_kernel", "nccl"),
                             cpu=False)
    fields["ddp_flagship"] = {
        "model": "oetr_r50_kernels_config('float32')", "pairs": b,
        "image_hw": IMAGE_HW, **res,
        "launches": {k: n for k, n in launches.items() if n},
        "path_kernels_vs_plain": kernel_errs,
        "ms_per_step": ms_ddp, "ms_per_step_local": ms_local,
        "timing": "median of 2 CUDA-event steps after 1 warm-up, cuDNN's "
                  "defaults (as the train phase)",
        "traced_per_step": {k: stats[k] for k in (
            "wall_ms", "device_busy_ms", "idle_share", "launches_per_call",
            "dtoh_copies_per_call", "linear_encoder_kernel_per_call",
            "gn_apply_pool_kernel_per_call", "nccl_per_call")}}
    del local, ddp, ddp_run
    torch.cuda.empty_cache()

    # (2) FSDP2 in bf16 with K2 on; (3) TP in f32.
    synth = port.make_device_generator(MULTI_SMALL_HW, b, device=DEV)
    small = [synth(gen(175 + i)) for i in range(MULTI_STEPS)]
    for tag, dtype_name, attention, axes, fsdp in (
            ("fsdp2", "bfloat16", "linear:cuda", {"data": 1, "fsdp": 1},
             "fsdp"),
            ("tp", "float32", "linear", {"data": 1, "model": 1}, None)):
        c = multi_small_config(port, dtype_name, attention)
        step = make_train_step(cycle=True)
        base = run(fresh(c, MULTI_SMALL_LR), step, small)
        sub = make_mesh(axes, DEV)
        st, specs = shard_train_state(fresh(c, MULTI_SMALL_LR), sub,
                                      rules=None if "model" in axes else [],
                                      fsdp_axis=fsdp)
        step = make_train_step(cycle=True, group=sub["data"].get_group())
        reset_counts(ops)
        with recorded_kernel_calls() as calls:
            other = run(st, step, small)
            torch.cuda.synchronize()
        with torch.no_grad():
            errs = recorded_kernel_errors(torch, ops, calls, f"multi {tag}")
        del calls
        res = layouts_vs_local(torch, base, other, MULTI_SMALL_LR,
                               MULTI_STEPS, TRAIN_LOSS_RTOL)
        check(tag, res)
        fields[tag] = {"mesh": axes, "dtype": dtype_name,
                       "attention": attention, "image_hw": MULTI_SMALL_HW,
                       "pairs": b, "lr": MULTI_SMALL_LR, **res,
                       "split_over_model": sum("model" in v
                                               for v in specs.values()),
                       "launches": {k: n for k, n in
                                    launch_counts(ops).items() if n},
                       "path_kernels_vs_plain": errs}
        del base, st, other
    torch.cuda.empty_cache()

    # (4) BA with the observations over a group of one.
    args, _ = bal_problem()
    on_card = [a.to(DEV) for a in args]
    kw = dict(iters=BAL_ITERS, cg_iters=BAL_CG_ITERS, huber_delta=BAL_HUBER)
    ms = {}
    out = {}
    for tag, extra in (("local", {}), ("group", {"group": dist.group.WORLD})):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out[tag] = bundle_adjust(*on_card, **kw, **extra)
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - start) * 1e3
    cost_rel = abs(out["group"]["cost"].item() - out["local"]["cost"].item()
                   ) / out["local"]["cost0"].item()
    cams = (out["group"]["cams"] - out["local"]["cams"]).abs().max().item()
    if not (cost_rel <= MULTI_BA_COST_RTOL and cams <= MULTI_BA_CAMS_TOL):
        raise AssertionError(f"multi BA with a group: cost {cost_rel}, "
                             f"cams {cams}")
    fields["ba_group"] = {
        "counts": [BAL_CAMS, BAL_POINTS, BAL_OBS],
        "cost_rel_diff_of_cost0": cost_rel, "cost_rtol": MULTI_BA_COST_RTOL,
        "cams_max_abs_diff": cams, "cams_tol": MULTI_BA_CAMS_TOL,
        "ms_group_first_call": ms["group"], "ms_local": ms["local"]}
    dist.destroy_process_group()
    return fields, launches


# -------------------------------------------------------------------- api --

API_WARMUP, API_REPS = 1, 2
API_SMALL_HW = 256           # card against CPU, per extractor and COTR
API_COTR_HW = 256            # COTR's pair (its paper's input size)
API_COTR_QUERIES = 1024
API_PHASE_S = 40.0
IDENTITY_PX = 1.5            # tests/test_runner_and_utils.py:70-73
API_CPU_TOL = 1e-4           # dense scores (of the largest), descriptors
API_KEYPOINTS_MIN = 0.99     # valid keypoints equal as sets, card vs CPU
# Keypoint slots equal, card vs CPU. Rounding alone trades slots between
# keypoints of near-equal scores: the phase reads the CPU's own trades on
# images nudged by one f32 ulp (cpu_ulp_slots_equal) beside the card's.
API_SLOTS_MIN = 0.98
API_SG_SLOTS = 512           # SuperGlue card vs CPU: the first K slots
API_SG_RTOL = 1e-4           # its log assignment, of max(1, |largest|)
API_MATCH_MIN = 0.99         # NN / disk matches equal, valid keypoints
API_TIE = 1e-5               # rows whose top two similarities are closer
POSE_TRANSFER_PX = 1.0
POSE_OUTLIERS = 0.3
API_NN_COMBOS = (("d2net-ss", "NN"), ("r2d2-desc", "NN"),
                 ("aslfeat-desc", "NN"), ("disk-desc", "disk"),
                 ("disk-desc", "superglue_disk"))


def api_images(torch, hw, seed):
    """One scene pair of hw² from the port's generator, as a decoder gives
    images: RGB float32 numpy [hw, hw, 3] in [0, 1]."""
    from oetr_tpu_torch import profile_forward as pf

    raw = pf.scene_pairs(hw, 1, seed, device=DEV)
    return [raw[k][0].float().cpu().numpy() for k in ("image1", "image2")]


def identity_settings(model, trained_loftr=None):
    """The matcher settings the identity check runs with, as (object,
    attribute, value). Seeded SuperGlue's assignment is not dominated by
    each keypoint's own copy (at threshold 0 its mutual argmaxes lie a
    median 3-4.5 px apart on an identical pair, CPU rehearsal at 128²), so
    the check matches those pipelines' keypoints with NN; a LoFTR pipeline
    takes ``trained_loftr``, the committed ``.ckpt_loftr_r5`` weights at
    their own threshold (0.2) and fine window (5), as users run it (seeded
    LoFTR keeps no match over 0.2)."""
    from oetr_tpu_torch.models import registry

    pipe = model[0]
    if hasattr(pipe, "loftr"):
        return [(pipe, "loftr", trained_loftr)]
    if hasattr(pipe.match_fn, "match_threshold"):
        return [(pipe, "match_fn", registry.build("NN", device=DEV))]
    return []


def api_case(torch, model, img0, img1, names=(), trained_loftr=None):
    """One combination through ``get_matches``'s helper below the decode:
    pairs/s (median of API_REPS calls after API_WARMUP), traced device
    time and idle share, keypoints and matches of the pair, the identity
    check (img0 against itself, with ``identity_settings``: the matched
    keypoints' median distance in the original frame), and ``get_pose``
    on the pair's matches. Returns (fields, the pair's result,
    failures)."""
    import numpy as np

    from oetr_tpu_torch.pipelines import api

    t0 = time.perf_counter()
    call = lambda: api._match_images(model, img0, img1)
    with torch.inference_mode():
        for _ in range(API_WARMUP):
            call()
        wall = []
        for _ in range(API_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
        stats = traced_stats(torch, call, reps=1, names=names, warmup=0,
                             cpu=False)
        settings = identity_settings(model, trained_loftr)
        kept = [getattr(obj, attr) for obj, attr, _ in settings]
        for obj, attr, value in settings:
            setattr(obj, attr, value)
        ident = api._match_images(model, img0, img0)
        for (obj, attr, _), value in zip(settings, kept):
            setattr(obj, attr, value)
    m = ident["matches"]
    dist = np.linalg.norm(ident["kpts0"][m[0]] - ident["kpts1"][m[1]],
                          axis=-1)
    ident_px = float(np.median(dist)) if len(dist) else None
    pose = api.get_pose(res, device=DEV)
    fields = {
        "pairs_per_s": 1.0 / statistics.median(wall),
        "wall_ms": statistics.median(wall) * 1e3,
        "device_busy_ms": stats["device_busy_ms"],
        "idle_share": stats["idle_share"],
        "launches_per_call": stats["launches_per_call"],
        "dtoh_copies_per_call": stats["dtoh_copies_per_call"],
        "device_ms_by_category": stats["device_ms_by_category"],
        **{k: v for k, v in stats.items() if k.endswith("_per_call")
           and k not in ("launches_per_call", "dtoh_copies_per_call")},
        "keypoints": [int(res[f"all_valid{s}"].sum()) for s in "01"]
        if "all_valid0" in res else None,
        "matches": int(res["matches"].shape[1]),
        "identity_matches": int(m.shape[1]),
        "identity_settings": {attr: "NN" if attr == "match_fn" else {
            "weights": ".ckpt_loftr_r5",
            "match_threshold": value.match_threshold,
            "fine_window": value.fine_window} for _, attr, value in settings},
        "identity_median_px": ident_px,
        "pose_H_finite": bool(np.isfinite(pose["H"]).all()),
        "pose_ok": pose["ok"], "case_s": time.perf_counter() - t0}
    failed = []
    if ident_px is None or not ident_px < IDENTITY_PX:
        failed.append(f"identity: {m.shape[1]} matches, median {ident_px}")
    if not fields["pose_H_finite"]:
        failed.append("get_pose: H not finite")
    return fields, res, failed


def api_pose(torch, port, model, seed):
    """``get_pose`` on matches from the homography pair generator's true H
    (perspective off for the similarity): 1000 points of the image mapped
    by H, POSE_OUTLIERS of them moved anywhere. Returns the largest and
    mean transfer error at the true correspondences against the truth (px),
    inliers and ok."""
    import numpy as np

    from oetr_tpu_torch.geometry.homography import apply_homography
    from oetr_tpu_torch.pipelines import api

    g = torch.Generator(device=DEV).manual_seed(seed)
    kw = {} if model == "homography" else {"max_persp": 0.0}
    _, _, H = port.make_homography_pair_generator(CANVAS_HW, 1, device=DEV,
                                                  **kw)(g)
    n = 1000
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, CANVAS_HW, (n, 2)).astype(np.float32)
    p1 = apply_homography(H[0].cpu(), torch.from_numpy(p0)).numpy()
    out = rng.random(n) < POSE_OUTLIERS
    p1[out] = rng.uniform(0, CANVAS_HW, (int(out.sum()), 2))
    res = api.get_pose({"kpts0": p0, "kpts1": p1,
                        "matches": np.stack([np.arange(n)] * 2)},
                       model=model, device=DEV)
    est = apply_homography(torch.from_numpy(res["H"]).float(),
                           torch.from_numpy(p0[~out])).numpy()
    true = apply_homography(H[0].cpu(), torch.from_numpy(p0[~out])).numpy()
    err = np.linalg.norm(est - true, axis=-1)
    return {"transfer_max_px": float(err.max()),
            "transfer_mean_px": float(err.mean()),
            "inliers": int(res["inliers"].sum()),
            "true_inliers": int((~out).sum()), "ok": res["ok"]}


def keypoint_positions(out, i=0):
    """{(x, y): slot} of the valid keypoints of image i of an extractor's
    output."""
    xy, v = out["keypoints"][i].tolist(), out["valid"][i].tolist()
    return {tuple(p): k for k, (p, ok) in enumerate(zip(xy, v)) if ok}


def keypoint_agreement(a, b):
    """Two extractor outputs of one image: (the share of the K slots with
    the same position and validity, the share of the valid keypoints
    found by both, as sets of positions)."""
    same = ((a["keypoints"] == b["keypoints"]).all(-1)
            & (a["valid"] == b["valid"]))
    pa, pb = keypoint_positions(a), keypoint_positions(b)
    return (same.float().mean().item(),
            len(set(pa) & set(pb)) / max(1, len(pa), len(pb)))


def match_data(e0, e1, dev, hw):
    """A matcher's data dict from two extractor outputs, on ``dev``."""
    data = {f"{key}{i}": e[key].to(dev) for i, e in enumerate((e0, e1))
            for key in ("keypoints", "scores", "descriptors", "valid")}
    data.update(image_hw0=(hw, hw), image_hw1=(hw, hw))
    return data


def api_vs_cpu(torch, name, matcher, model, images):
    """An extractor on the card against its copy on the CPU (same weights,
    f32) on a grayscale pair of API_SMALL_HW²: dense scores (of the largest
    entry); the valid keypoints equal as sets of positions; the keypoint
    slots equal (two keypoints whose scores differ by rounding trade
    slots), beside the CPU's own spread: the CPU on the images scaled by
    1 + one f32 ulp times a normal draw a pixel; descriptors on equal
    slots; and ``matcher``'s matches on each device's outputs, by
    position: the image-1 keypoint that each valid image-0 keypoint found
    on both devices matches (or none), over all of them (of the larger
    valid set) and, reported, over those whose CPU rows are not near-ties
    (top two similarities within API_TIE, the row's or its best
    column's)."""
    from oetr_tpu_torch.models import grayscale, registry

    t0 = time.perf_counter()
    cpu = registry.build(name, device="cpu")
    cpu.load_state_dict(model.state_dict())
    ims = [grayscale(torch.from_numpy(im)[None]) for im in images]
    g = torch.Generator().manual_seed(55)
    eps = torch.finfo(torch.float32).eps
    nudged = [im * (1 + eps * torch.randn(im.shape, generator=g))
              for im in ims]
    with torch.inference_mode():
        card_out = [{k: v.cpu() for k, v in model(im.to(DEV)).items()}
                    for im in ims]
        cpu_out = [cpu(im) for im in ims]
        cpu_nudged = [cpu(im) for im in nudged]

    fields = {"dense_err": 0.0, "slots_equal": 1.0, "keypoints_equal": 1.0,
              "desc_err": 0.0, "cpu_ulp_slots_equal": 1.0,
              "cpu_ulp_keypoints_equal": 1.0}
    for d, c, n in zip(card_out, cpu_out, cpu_nudged):
        ref = c["dense_scores"]
        fields["dense_err"] = max(fields["dense_err"], (
            (d["dense_scores"] - ref).abs().max()
            / ref.abs().max().clamp(min=1.0)).item())
        for prefix, other in (("", d), ("cpu_ulp_", n)):
            slots, sets = keypoint_agreement(other, c)
            fields[f"{prefix}slots_equal"] = min(
                fields[f"{prefix}slots_equal"], slots)
            fields[f"{prefix}keypoints_equal"] = min(
                fields[f"{prefix}keypoints_equal"], sets)
        both = ((d["keypoints"] == c["keypoints"]).all(-1)
                & (d["valid"] == c["valid"]) & c["valid"])
        fields["desc_err"] = max(fields["desc_err"], (
            d["descriptors"] - c["descriptors"]).abs()[both].max().item())

    failed = []
    if matcher in ("NN", "disk"):
        match = registry.build(matcher, device="cpu")
        with torch.inference_mode():
            md = match(match_data(*card_out, DEV, API_SMALL_HW))[
                "matches0"].cpu()[0]
            mc = match(match_data(*cpu_out, "cpu", API_SMALL_HW))[
                "matches0"][0]
        c0, c1 = cpu_out
        v0, v1 = c0["valid"], c1["valid"]
        sim = torch.einsum("bmd,bnd->bmn", c0["descriptors"].double(),
                           c1["descriptors"].double())
        sim = sim.masked_fill(~(v0[:, :, None] & v1[:, None, :]),
                              float("-inf"))
        top = sim.topk(2, dim=2).values
        topc = sim.topk(2, dim=1).values
        col_tie = (topc[:, 0] - topc[:, 1] < API_TIE).gather(
            1, sim.argmax(2))
        tie = ((top[..., 0] - top[..., 1] < API_TIE) | col_tie)[0]

        def partner(out, m, slot):
            j = int(m[slot])
            return tuple(out[1]["keypoints"][0, j].tolist()) if j > -1 \
                else None

        pd, pc = keypoint_positions(card_out[0]), keypoint_positions(
            cpu_out[0])
        common = set(pd) & set(pc)
        agree = {p: partner(card_out, md, pd[p]) == partner(cpu_out, mc,
                                                            pc[p])
                 for p in common}
        clear = [p for p in common if not tie[pc[p]]]
        fields.update(
            matcher=matcher,
            matches=[int((md > -1).sum()), int((mc > -1).sum())],
            valid_keypoints0=[len(pd), len(pc)],
            matches_agree=sum(agree.values()) / max(1, len(pd), len(pc)),
            matches_agree_clear=sum(agree[p] for p in clear)
            / max(1, len(clear)),
            near_tie_rows=len(common) - len(clear))
        if not fields["matches_agree"] >= API_MATCH_MIN:
            failed.append(f"{name}: matches agree {fields['matches_agree']}")
    fields["s"] = time.perf_counter() - t0
    if not (fields["dense_err"] <= API_CPU_TOL
            and fields["desc_err"] <= API_CPU_TOL
            and fields["keypoints_equal"] >= API_KEYPOINTS_MIN
            and fields["slots_equal"] >= API_SLOTS_MIN):
        failed.append(f"{name} card vs CPU: {fields}")
    return fields, failed


def api_matcher_vs_cpu(torch, name, pipe, image):
    """The pipeline's own matcher on the identity pair (``image`` against
    itself, grayscale, API_SMALL_HW²) on the card against its copy on the
    CPU, same weights and inputs, f32; ``name`` is its registry entry.
    SuperGlue, on the extractor's first API_SG_SLOTS slots: the matches at
    threshold 0 (the mutual argmaxes; seeded, it keeps none over 0.2)
    equal by slot on >= MATCH_AGREE_MIN of the valid keypoints, and the
    log assignment within API_SG_RTOL of max(1, its largest unmasked
    |entry|). LoFTR: ``coarse_conf`` within LOFTR_CONF_RTOL of the CPU's
    largest entry, and each row's argmax equal on >= MATCH_AGREE_MIN of
    the rows, as the loftr phase holds it. Returns (fields, failures)."""
    from oetr_tpu_torch.models import grayscale, registry
    from oetr_tpu_torch.ops.sinkhorn import extract_matches

    t0 = time.perf_counter()
    im = grayscale(torch.from_numpy(image)[None])
    card = pipe.loftr if hasattr(pipe, "loftr") else pipe.match_fn
    cpu = registry.build(name, device="cpu")
    cpu.load_state_dict(card.state_dict())
    failed = []
    with torch.inference_mode():
        if hasattr(pipe, "loftr"):
            got = card(im.to(DEV), im.to(DEV))["coarse_conf"].cpu()
            ref = cpu(im, im)["coarse_conf"]
            tol = LOFTR_CONF_RTOL * ref.max().item()
            pick = got.argmax(-1)
            fields = {"coarse_conf_max_abs_err": (got - ref).abs().max()
                      .item(), "coarse_conf_tol": tol,
                      "row_argmax_agree": (pick == ref.argmax(-1)).float()
                      .mean().item(),
                      "row_argmax_self": (pick == torch.arange(
                          pick.shape[-1])).float().mean().item()}
            ok = (fields["coarse_conf_max_abs_err"] <= tol
                  and fields["row_argmax_agree"] >= MATCH_AGREE_MIN)
        else:
            e = {k: v[:, :API_SG_SLOTS]
                 for k, v in pipe.extractor(im.to(DEV)).items()
                 if k != "dense_scores"}
            la = card(match_data(e, e, DEV, API_SMALL_HW))[
                "log_assignment"].cpu()
            la_ref = cpu(match_data(e, e, "cpu", API_SMALL_HW))[
                "log_assignment"]
            v = e["valid"].cpu()
            m0 = extract_matches(la, 0.0, v, v)[0]
            m0_ref = extract_matches(la_ref, 0.0, v, v)[0]
            unmasked = la_ref > K4_MASKED
            scale = max(1.0, la_ref[unmasked].abs().max().item())
            err = (la - la_ref)[unmasked].abs().max().item()
            fields = {"slots": API_SG_SLOTS, "valid_keypoints": int(v.sum()),
                      "log_assignment_err": err,
                      "log_assignment_tol": API_SG_RTOL * scale,
                      "matches_thr_0.0": int((m0_ref > -1).sum()),
                      "matches_agree_thr_0.0": match_agreement(m0, m0_ref,
                                                               v),
                      "self_matches_thr_0.0": int((m0 == torch.arange(
                          m0.shape[-1])).sum())}
            ok = (err <= API_SG_RTOL * scale
                  and fields["matches_agree_thr_0.0"] >= MATCH_AGREE_MIN)
    fields["s"] = time.perf_counter() - t0
    if not ok:
        failed.append(f"{name} card vs CPU on the identity pair: {fields}")
    return fields, failed


def run_api(torch, port, ops):
    """The public matching API on the card at the published widths (832²
    canvas, 640² OETR pass, each registry entry's own max_keypoints,
    seeded weights, f32, TF32 off), one pair a call through
    ``get_matches``'s helper below the decode (``api._match_images``):
      1. superpoint_aachen + superglue_outdoor + the oetr overlaper through
         ``build_model``;
      2. the same models from ``registry.build`` with K2, K3
         (``oetr_r50_kernels_config``) and K4 (``cuda_sinkhorn``) on in a
         ``SparsePipeline`` (retry off): the main path, its launch counts
         read around one call (16/1/1) and traced, and its outputs against
         the same weights with the switches off;
      3. d2net-ss, r2d2-desc and aslfeat-desc with NN, disk-desc with disk
         and with superglue_disk; each extractor also on the card against
         the CPU at API_SMALL_HW²;
      4. loftr with the oetr overlaper (dense);
      5. COTR through ``cotr_match`` on a scene pair of API_COTR_HW²,
         API_COTR_QUERIES queries, against the CPU;
      6. ``get_pose`` (homography, similarity) on matches from the
         homography pair generator's true H with 30% outliers;
      7. the keypoint selection's tie-breaking top-k against torch.topk.
    Each combination: pairs/s, traced device ms and idle share, keypoints
    and matches, the identity check and get_pose on its own matches; the
    superglue_disk and LoFTR combinations also their matcher on the card
    against the CPU on an identity pair (``api_matcher_vs_cpu``; the
    trained SuperGlue's is the shipped phase's; the
    identity check runs SuperGlue's keypoints through NN and LoFTR with the
    committed weights at their own threshold, ``identity_settings``). The main path (2) has every K2, K3 and K4 output held
    to its plain version on the same inputs, and SuperGlue's log
    assignment with K4 against K4 off on the same inputs.
    Returns (fields, the main path's launches)."""
    from oetr_tpu_torch.models import cotr as cotr_mod
    from oetr_tpu_torch.models import registry
    from oetr_tpu_torch.ops.nms import topk_stable
    from oetr_tpu_torch.ops.sinkhorn import extract_matches
    from oetr_tpu_torch.pipelines import api
    from oetr_tpu_torch.pipelines.runner import run_batch

    t0 = time.perf_counter()
    split = {}
    mark = lambda name: split.__setitem__(name, time.perf_counter() - t0)
    seeded = lambda s: torch.Generator().manual_seed(s)
    img0, img1 = api_images(torch, CANVAS_HW, seed=41)
    cfg = port.PipelineConfig(canvas_hw=(CANVAS_HW, CANVAS_HW),
                              oetr_hw=(IMAGE_HW, IMAGE_HW))
    fields, failed = {"canvas_hw": CANVAS_HW, "oetr_hw": IMAGE_HW,
                      "dtype": "float32", "pairs_per_call": 1}, []
    combos = fields["combinations"] = {}

    # 1. The README's quick start through build_model.
    model = api.build_model("superpoint_aachen", "superglue_outdoor",
                            "oetr", cfg=cfg, device=DEV)
    combos["superpoint_aachen+superglue_outdoor+oetr"], _, f = api_case(
        torch, model, img0, img1)
    failed += f
    small = api_images(torch, API_SMALL_HW, seed=42)
    # (The seeded superglue_outdoor's card-vs-CPU check at threshold 0 went
    # to the shipped phase, where the trained SuperGlue keeps matches at
    # 0.2: shipped_card_vs_cpu.)
    matchers_vs_cpu = fields["matcher_vs_cpu"] = {}
    del model
    mark("build_model_superglue")

    # 2. The same from the registry with K2, K3, K4 on: the main path.
    oetr = registry.build("oetr", device=DEV, generator=seeded(50),
                          cfg=port.oetr_r50_kernels_config("float32"))
    sp = registry.build("superpoint_aachen", device=DEV,
                        generator=seeded(51))
    sg = registry.build("superglue_outdoor", device=DEV,
                        generator=seeded(52), cuda_sinkhorn=True)
    cfg0 = port.replace(cfg, fallback_min_matches=0)
    on = (port.SparsePipeline(sp, sg, oetr, cfg0), {"config": cfg0})
    prep = [api.prepare_image(im, cfg.canvas_hw, cfg.oetr_hw, 1024)
            for im in (img0, img1)]
    batch = api.batch_pairs(prep[:1], prep[1:])
    sg_off = registry.build("superglue_outdoor", device=DEV)
    sg_off.load_state_dict(sg.state_dict())
    cap_on, cap_off = Capture(sg), Capture(sg_off)
    with torch.inference_mode():
        # The main path once, its launches counted and every K2, K3 and
        # K4 call recorded, then the same with only K4 off.
        with recorded_kernel_calls(sinkhorn=True) as calls:
            reset_counts(ops)
            out = run_batch(port.SparsePipeline(sp, cap_on, oetr, cfg0),
                            batch)
            torch.cuda.synchronize()
            launches = launch_counts(ops)
        k4_off = run_batch(port.SparsePipeline(sp, cap_off, oetr, cfg0),
                           batch)
    want = {name: 0 for name in KERNELS}
    want.update(linear_encoder_attention=16, groupnorm_relu_maxpool=1,
                log_sinkhorn_cuda=1)
    if launches != want:
        raise AssertionError(f"api launches {launches} != {want}")
    path_kernels = recorded_kernel_errors(torch, ops, calls, path="api")
    for key in ("bbox0", "bbox1", "keypoints0", "keypoints1", "valid0",
                "valid1"):
        if not torch.equal(out[key], k4_off[key]):
            raise AssertionError(f"api: {key} differs with K4 off")
    la_on, la_off = cap_on.last["log_assignment"], cap_off.last[
        "log_assignment"]
    la_err, la_worst = k4_compare(torch, la_on, la_off)
    v0, v1 = out["valid0"], out["valid1"]
    m0_on = extract_matches(la_on, 0.0, v0, v1)[0]
    m0_off = extract_matches(la_off, 0.0, v0, v1)[0]
    k4_vs_off = {
        "log_assignment_err": la_err, "log_assignment_err_over_tol":
        la_worst, "matches_agree_thr_0.2": match_agreement(
            out["matches0"], k4_off["matches0"], v0),
        "matches_agree_thr_0.0": match_agreement(m0_on, m0_off, v0),
        "matches_thr_0.0": int(((m0_on > -1) & v0).sum()),
        "valid_keypoints0": int(v0.sum())}
    del cap_on, cap_off, la_on, la_off, k4_off
    oetr_off = registry.build("oetr", device=DEV, generator=seeded(50),
                              cfg=port.oetr_r50_config())
    oetr_off.load_state_dict(oetr.state_dict())
    with torch.inference_mode():
        ref = run_batch(port.SparsePipeline(sp, sg_off, oetr_off, cfg0),
                        batch)
    box = max((out[k] - ref[k]).abs().max().item() for k in ("bbox0",
                                                             "bbox1"))
    same_kp = ((out["keypoints0"] == ref["keypoints0"]).all(-1)
               & (out["valid0"] == ref["valid0"]))
    agree = match_agreement(out["matches0"], ref["matches0"],
                            out["valid0"] & same_kp)
    case, _, f = api_case(torch, on, img0, img1,
                          names=("linear_encoder_kernel",
                                 "gn_apply_pool_kernel", "sinkhorn_kernel"))
    failed += f
    traced = {"linear_encoder_attention": case.pop(
                  "linear_encoder_kernel_per_call") / 2,
              "groupnorm_relu_maxpool": case.pop(
                  "gn_apply_pool_kernel_per_call"),
              "log_sinkhorn_cuda": case.pop("sinkhorn_kernel_per_call")}
    case.update(launches_per_call={k: n for k, n in launches.items() if n},
                traced_launches_per_call=traced,
                path_kernels_vs_plain=path_kernels, k4_vs_off=k4_vs_off,
                vs_plain={"box_max_diff_px": box,
                          "box_tol_px": BOX_TOL_PX["float32"],
                          "used_overlap_equal": torch.equal(
                              out["used_overlap"], ref["used_overlap"]),
                          "keypoints0_equal": same_kp.float().mean().item(),
                          "matches0_agree": agree,
                          "agree_min": MATCH_AGREE_MIN})
    combos["registry:oetr(K2,K3)+superpoint_aachen+superglue_outdoor(K4)"] \
        = case
    if traced != {"linear_encoder_attention": 16,
                  "groupnorm_relu_maxpool": 1, "log_sinkhorn_cuda": 1}:
        failed.append(f"api: traced launches a call {traced}")
    if not (la_worst <= 1.0
            and k4_vs_off["matches_agree_thr_0.2"] >= MATCH_AGREE_MIN
            and k4_vs_off["matches_agree_thr_0.0"] >= MATCH_AGREE_MIN):
        failed.append(f"api K4 on vs off: {k4_vs_off}")
    if not (box <= BOX_TOL_PX["float32"] and agree >= MATCH_AGREE_MIN
            and case["vs_plain"]["used_overlap_equal"]):
        failed.append(f"api on vs off: {case['vs_plain']}")
    del on, oetr, oetr_off, sg, sg_off, sp, out, ref
    mark("registry_kernels")

    # 3. The other extractors and matchers; each extractor on the card
    # against the CPU.
    vs_cpu = fields["card_vs_cpu"] = {}
    for extractor, matcher in API_NN_COMBOS:
        model = api.build_model(extractor, matcher, cfg=cfg, device=DEV)
        key = f"{extractor}+{matcher}"
        combos[key], _, f = api_case(torch, model, img0, img1)
        failed += f
        if extractor not in vs_cpu or matcher in ("NN", "disk"):
            vs_cpu[extractor], f = api_vs_cpu(torch, extractor, matcher,
                                              model[0].extractor, small)
            failed += f
        if matcher == "superglue_disk":
            matchers_vs_cpu[matcher], f = api_matcher_vs_cpu(
                torch, matcher, model[0], small[0])
            failed += f
        del model
        mark(f"{extractor}+{matcher}")

    # 4. Dense: LoFTR with the overlaper; its identity check with the
    # committed LoFTR (read by build_shipped_model) at its own threshold.
    model = api.build_model("superpoint_aachen", "loftr", "oetr", cfg=cfg,
                            device=DEV)
    trained_loftr = api.build_shipped_model("loftr", device=DEV)[0].loftr
    combos["loftr+oetr"], _, f = api_case(torch, model, img0, img1,
                                          trained_loftr=trained_loftr)
    failed += f
    matchers_vs_cpu["loftr"], f = api_matcher_vs_cpu(torch, "loftr",
                                                     model[0], small[0])
    failed += f
    del model, trained_loftr
    torch.cuda.empty_cache()
    mark("loftr")

    # 5. COTR on a scene pair, card against CPU.
    cotr = registry.build("cotr", device=DEV, generator=seeded(53))
    pair = [torch.from_numpy(im)[None]
            for im in api_images(torch, API_COTR_HW, seed=43)]
    q = torch.rand(1, API_COTR_QUERIES, 2, generator=seeded(54)) * 0.9 + 0.05
    pair_d, q_d = [p.to(DEV) for p in pair], q.to(DEV)
    call = lambda: cotr_mod.cotr_match(cotr, pair_d[0], pair_d[1], q_d)
    with torch.inference_mode():
        for _ in range(API_WARMUP):
            call()
        ms = time_ms(torch, call, reps=API_REPS, warmup=0)
        stats = traced_stats(torch, call, reps=1, warmup=0, cpu=False)
        got = {k: v.cpu() for k, v in call().items()}
    cpu = registry.build("cotr", device="cpu")
    cpu.load_state_dict(cotr.state_dict())
    ref = cotr_mod.cotr_match(cpu, pair[0], pair[1], q)
    errs = {k: (got[k] - ref[k]).abs().max().item()
            for k in ("mkpts1", "cycle_error")}
    near = (ref["cycle_error"] - 0.02).abs() < 1e-3
    valid_agree = ((got["valid"] == ref["valid"]) | near).float().mean()
    combos["cotr"] = {
        "hw": API_COTR_HW, "queries": API_COTR_QUERIES,
        "pairs_per_s": 1e3 / ms, "ms": ms,
        "device_busy_ms": stats["device_busy_ms"],
        "idle_share": stats["idle_share"],
        "launches_per_call": stats["launches_per_call"],
        "valid": int(got["valid"].sum()), "vs_cpu_max_err": errs,
        "valid_agree_away_from_threshold": valid_agree.item()}
    if not (max(errs.values()) <= API_CPU_TOL and valid_agree == 1.0):
        failed.append(f"cotr card vs CPU: {combos['cotr']}")
    del cotr, cpu
    mark("cotr")

    # 6. get_pose against the generator's truth.
    poses = fields["get_pose"] = {}
    for pose_model, seed in (("homography", 44), ("similarity", 45)):
        poses[pose_model] = api_pose(torch, port, pose_model, seed)
        p = poses[pose_model]
        if not (p["ok"] and p["transfer_max_px"] <= POSE_TRANSFER_PX):
            failed.append(f"get_pose {pose_model}: {p}")
    fields.update(pose_transfer_tol_px=POSE_TRANSFER_PX,
                  identity_tol_px=IDENTITY_PX, cpu_tol=API_CPU_TOL,
                  keypoints_min=API_KEYPOINTS_MIN,
                  slots_min=API_SLOTS_MIN, match_min=API_MATCH_MIN,
                  sg_slots=API_SG_SLOTS, sg_rtol=API_SG_RTOL,
                  tie=API_TIE)
    mark("get_pose")

    # 7. The tie-breaking top-k against torch.topk (no order among ties)
    # at the keypoint selection's shapes at 832²: SuperPoint's tile maxima
    # (the sparse phase's 16 images, radius 4: 5² tiles; the quick start's
    # pair, radius 3: 4² tiles) and every pixel of a dense extractor's
    # pair.
    g = torch.Generator(device=DEV).manual_seed(56)
    topk = fields["topk_stable_vs_topk"] = {}
    for rows, n in ((16, (-(-CANVAS_HW // 5)) ** 2),
                    (2, (CANVAS_HW // 4) ** 2), (2, CANVAS_HW ** 2)):
        x = torch.rand(rows, n, generator=g, device=DEV)
        topk[f"{rows}x{n}"] = {
            "k": SPARSE_K,
            "topk_stable_ms": time_ms(torch, lambda: topk_stable(x,
                                                                 SPARSE_K)),
            "torch_topk_ms": time_ms(torch, lambda: torch.topk(x, SPARSE_K,
                                                               dim=1))}
    mark("topk")
    fields["split_s"] = split
    fields["api_phase_s"] = time.perf_counter() - t0
    if fields["api_phase_s"] > API_PHASE_S:
        failed.append(f"api phase took {fields['api_phase_s']:.1f} s > "
                      f"{API_PHASE_S}")
    fields["failures"] = failed
    return fields, launches


# ---------------------------------------------------------------- shipped --

# The trained-weights path: the committed matching stores
# (.ckpt_matching_r5/superpoint and superglue, the one store the chip copy
# takes) read by the port's own reader (interop/orbax_read.py: OCDBT, zarr
# and zstd, no orbax), then build_shipped_model("superglue") at JAX's
# shipped widths: 832² canvas, SuperPoint k 2048 (threshold 0, descriptor
# 128), SuperGlue descriptor 128, 9 layers, K4 on.
SHIPPED_PAIRS = 8
SHIPPED_REPS = 3
SHIPPED_MATCHES_MIN = 64     # matches over 0.2: the path's, the gate's, the
                             # identity check's (not vacuous)
SHIPPED_THRESHOLD = 0.2      # SuperGlue's own match threshold
# tests/test_shipped_matcher_gate.py: 8 held-out device-generator pairs of
# 256² (key 990 there, seed 990 here), k 512, NN at ratio 0.95 on the same
# keypoints; SuperGlue's exact-assignment precision >= NN's.
SHIPPED_GATE_HW, SHIPPED_GATE_K, SHIPPED_GATE_SEED = 256, 512, 990
SHIPPED_NN_RATIO = 0.95
SHIPPED_PHASE_S = 15.0


def shipped_gate(torch, port, sp_state, sg):
    """JAX's matcher gate on the card through the port: SuperPoint at k
    SHIPPED_GATE_K with the trained state, the trained SuperGlue and NN on
    the same keypoints of SHIPPED_PAIRS device-generator pairs of
    SHIPPED_GATE_HW², GT by depth and pose. Returns (fields, the first
    pair's extractor outputs)."""
    from oetr_tpu_torch.models.matchers import nearest_neighbor_match
    from oetr_tpu_torch.training.superglue import gt_matches_batch

    hw = SHIPPED_GATE_HW
    gen = port.make_device_generator(hw, SHIPPED_PAIRS, scale_range=(1.0, 2.0),
                                     p_translate=0.5, device=DEV)
    raw = gen(torch.Generator(device=DEV).manual_seed(SHIPPED_GATE_SEED))
    sp = port.build_superpoint(device=DEV, max_keypoints=SHIPPED_GATE_K,
                               keypoint_threshold=0.0, descriptor_dim=128)
    sp.load_state_dict(sp_state)
    lum = torch.tensor([0.299, 0.587, 0.114], device=DEV)
    with torch.inference_mode():
        e0 = sp((raw["image1"] @ lum)[..., None])
        e1 = sp((raw["image2"] @ lum)[..., None])
        T = raw["pose2"] @ torch.linalg.inv(raw["pose1"])
        gt = gt_matches_batch(e0["keypoints"], e0["valid"], e1["keypoints"],
                              e1["valid"], raw["depth1"], raw["K1"], T,
                              raw["K2"], depth1=raw["depth2"])
        sg_m = sg(match_data(e0, e1, DEV, hw))["matches0"]
        nn_m = nearest_neighbor_match(
            e0["descriptors"], e1["descriptors"], e0["valid"], e1["valid"],
            ratio_threshold=SHIPPED_NN_RATIO)["matches0"]
    v0 = e0["valid"]

    def precision(m):
        sel = (m > -1) & v0
        return (((m == gt) & sel).sum() / sel.sum().clamp(min=1)).item()

    fields = {"hw": hw, "k": SHIPPED_GATE_K, "pairs": SHIPPED_PAIRS,
              "valid_keypoints": int(v0.sum()),
              "gt_matches": int(((gt > -1) & v0).sum()),
              "superglue_precision": precision(sg_m),
              "nn_precision": precision(nn_m),
              "superglue_matches": int(((sg_m > -1) & v0).sum()),
              "nn_matches": int(((nn_m > -1) & v0).sum())}
    first = [{k: v[:1] for k, v in e.items() if k != "dense_scores"}
             for e in (e0, e1)]
    return fields, first


def shipped_card_vs_cpu(torch, port, sg, e0, e1, hw):
    """The trained SuperGlue on the card against its copy on the CPU on one
    pair's first API_SG_SLOTS slots (extractor outputs ``e0``, ``e1`` on
    the card): matches0 at its threshold (0.2) equal by slot on >=
    MATCH_AGREE_MIN of the valid keypoints, the log assignment within
    API_SG_RTOL of max(1, its largest unmasked |entry|), and the matches
    over 0.2 counted. Returns (fields, failures)."""
    e0, e1 = ({k: v[:, :API_SG_SLOTS] for k, v in e.items()}
              for e in (e0, e1))
    cpu = port.build_superglue(device="cpu", descriptor_dim=sg.descriptor_dim)
    cpu.load_state_dict(sg.state_dict())
    with torch.inference_mode():
        got = sg(match_data(e0, e1, DEV, hw))
        want = cpu(match_data(e0, e1, "cpu", hw))
    la, la_ref = got["log_assignment"].cpu(), want["log_assignment"]
    m0, m0_ref = got["matches0"].cpu(), want["matches0"]
    v = e0["valid"].cpu()
    unmasked = la_ref > K4_MASKED
    scale = max(1.0, la_ref[unmasked].abs().max().item())
    fields = {"slots": API_SG_SLOTS, "valid_keypoints": int(v.sum()),
              "log_assignment_err": (la - la_ref)[unmasked].abs().max()
              .item(), "log_assignment_tol": API_SG_RTOL * scale,
              "log_assignment_largest": scale,
              f"matches_thr_{SHIPPED_THRESHOLD}": int(((m0_ref > -1) & v)
                                                      .sum()),
              f"matches_agree_thr_{SHIPPED_THRESHOLD}": match_agreement(
                  m0, m0_ref, v)}
    failed = []
    if not (fields["log_assignment_err"] <= fields["log_assignment_tol"]
            and fields[f"matches_agree_thr_{SHIPPED_THRESHOLD}"]
            >= MATCH_AGREE_MIN):
        failed.append(f"trained SuperGlue card vs CPU: {fields}")
    return fields, failed


def store_stats(tree, path):
    """Arrays, their bytes and dtypes of a checkpoint tree read from the
    store at ``path`` (a pathlib.Path), beside the store's bytes on disk."""
    leaves, stack = [], [tree]
    while stack:
        for v in stack.pop().values():
            (stack if isinstance(v, dict) else leaves).append(v)
    return {"arrays": len(leaves),
            "array_bytes": sum(a.nbytes for a in leaves),
            "bytes_on_disk": sum(f.stat().st_size for f in path.rglob("*")
                                 if f.is_file()),
            "dtypes": sorted({str(a.dtype) for a in leaves})}


def run_shipped(torch, port, ops, decoder_record):
    """The trained-weights path on the card:
      1. read both matching stores with ``read_checkpoint`` (the port's
         OCDBT, zarr and zstd code; a missing store fails the phase): bytes
         on disk and read, arrays, seconds; the zstd decoder's build
         (``decoder_record``, made while nvcc built the kernels);
      2. ``build_shipped_model("superglue", device="cuda")`` at JAX's
         shipped widths;
      3. SHIPPED_PAIRS device-generator pairs of 832² through it: pairs/s
         (median of SHIPPED_REPS calls), busy ms and idle share of one
         traced call, K4's launches counted around one call, every K4 call
         of that call held to its plain version on the same inputs through
         the transport (``recorded_kernel_errors``), K4 on against K4 off
         (matches0 at 0.2 agree on >= MATCH_AGREE_MIN of the valid
         keypoints), and >= SHIPPED_MATCHES_MIN matches over 0.2;
      4. JAX's matcher gate (``shipped_gate``): SuperGlue's precision >=
         NN's, >= SHIPPED_MATCHES_MIN SuperGlue matches;
      5. the trained SuperGlue on the card against the CPU on the gate's
         first pair (``shipped_card_vs_cpu``);
      6. the identity check with the real SuperGlue at 0.2 through
         ``api._match_images``: a scene image against itself, the matched
         keypoints' median distance < IDENTITY_PX, >= SHIPPED_MATCHES_MIN
         matches.
    Returns (fields, the path's launches, {store: the tree read})."""
    from pathlib import Path

    import numpy as np

    from oetr_tpu_torch.interop.orbax_read import read_checkpoint
    from oetr_tpu_torch.pipelines import api
    from oetr_tpu_torch.pipelines.api import SHIPPED_SG, SHIPPED_SP

    t0 = time.perf_counter()
    split = {}
    mark = lambda name: split.__setitem__(name, time.perf_counter() - t0)
    failed = []
    root = Path(port.__file__).resolve().parents[1]
    stores, trees = {}, {}
    for name in ("superpoint", "superglue"):
        path = root / ".ckpt_matching_r5" / name
        if not path.is_dir():
            raise AssertionError(f"shipped: store {path} missing (the chip "
                                 "copy must take .ckpt_matching_r5)")
        t = time.perf_counter()
        trees[name] = read_checkpoint(path)
        stores[name] = {"read_s": time.perf_counter() - t,
                        **store_stats(trees[name], path)}
    mark("read")

    t = time.perf_counter()
    model = api.build_shipped_model("superglue", device=DEV)
    pipe, conf = model
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    sp, sg = pipe.extractor, pipe.match_fn
    mark("build")

    raw = port.make_device_generator(CANVAS_HW, SHIPPED_PAIRS, device=DEV)(
        torch.Generator(device=DEV).manual_seed(61))
    hw = torch.full((SHIPPED_PAIRS, 2), CANVAS_HW, dtype=torch.int32,
                    device=DEV)
    sc = torch.ones(SHIPPED_PAIRS, 2, device=DEV)
    args = (raw["image1"], raw["image2"], hw, hw, raw["image1"],
            raw["image2"], sc, sc)
    sg_off = port.build_superglue(device=DEV, **SHIPPED_SG)
    sg_off.load_state_dict(sg.state_dict())
    cap_on, cap_off = Capture(sg), Capture(sg_off)
    cfg = conf["config"]
    with torch.inference_mode():
        with recorded_kernel_calls(sinkhorn=True) as calls:
            reset_counts(ops)
            out = port.SparsePipeline(sp, cap_on, None, cfg)(*args)
            torch.cuda.synchronize()
            launches = launch_counts(ops)
        out_off = port.SparsePipeline(sp, cap_off, None, cfg)(*args)
        call = lambda: pipe(*args)
        wall_ms = timed_calls(torch, call, SHIPPED_REPS)
        stats = traced_stats(torch, call, reps=1, names=("sinkhorn",),
                             warmup=0, cpu=False)
    want = {name: 0 for name in KERNELS}
    want["log_sinkhorn_cuda"] = 1
    if launches != want:
        raise AssertionError(f"shipped launches {launches} != {want}")
    path_kernels = recorded_kernel_errors(torch, ops, calls, path="shipped")
    for key in ("keypoints0", "keypoints1", "valid0", "valid1"):
        if not torch.equal(out[key], out_off[key]):
            raise AssertionError(f"shipped: {key} differs with K4 off")
    v0 = out["valid0"]
    m_on, m_off = cap_on.last["matches0"], cap_off.last["matches0"]
    per_pair = ((m_on > -1) & v0).sum(-1).tolist()
    la_err, la_worst = k4_compare(torch, cap_on.last["log_assignment"],
                                  cap_off.last["log_assignment"])
    path = {
        "pairs": SHIPPED_PAIRS, "canvas_hw": CANVAS_HW,
        "k": SHIPPED_SP["max_keypoints"],
        "descriptor_dim": SHIPPED_SG["descriptor_dim"],
        "gnn_layers": sg.gnn_layers, "dtype": "float32",
        "pairs_per_s": SHIPPED_PAIRS / wall_ms * 1e3, "wall_ms": wall_ms,
        "timing": f"median of {SHIPPED_REPS} calls, host clock around a "
                  "synchronized call",
        "device_busy_ms": stats["device_busy_ms"],
        "idle_share": stats["idle_share"],
        "traced_wall_ms": stats["wall_ms"],
        "launches_per_call": stats["launches_per_call"],
        "traced_sinkhorn_launches_per_call": stats["sinkhorn_per_call"],
        "device_ms_by_category": stats["device_ms_by_category"],
        "launches": launches, "kernel_outputs_vs_plain": path_kernels,
        "valid_keypoints": [int(x) for x in v0.sum(-1).tolist()],
        f"matches_thr_{SHIPPED_THRESHOLD}": int(sum(per_pair)),
        f"matches_thr_{SHIPPED_THRESHOLD}_per_pair": per_pair,
        f"k4_on_vs_off_agree_thr_{SHIPPED_THRESHOLD}": match_agreement(
            m_on, m_off, v0),
        "k4_on_vs_off_log_assignment_err": la_err,
        "k4_on_vs_off_err_over_tol": la_worst}
    if path[f"k4_on_vs_off_agree_thr_{SHIPPED_THRESHOLD}"] < MATCH_AGREE_MIN:
        failed.append(f"shipped: K4 on vs off agree on "
                      f"{path[f'k4_on_vs_off_agree_thr_{SHIPPED_THRESHOLD}']}")
    if not la_worst <= 1.0:
        failed.append(f"shipped: K4 on vs off log assignment {la_worst:.2f}"
                      " x its tolerance")
    if sum(per_pair) < SHIPPED_MATCHES_MIN:
        failed.append(f"shipped: {sum(per_pair)} matches over "
                      f"{SHIPPED_THRESHOLD} on {SHIPPED_PAIRS} pairs")
    del out, out_off, cap_on, cap_off, calls, args, raw
    mark("path")

    gate, first = shipped_gate(torch, port, sp.state_dict(), sg)
    if not (gate["superglue_precision"] >= gate["nn_precision"]
            and gate["superglue_matches"] >= SHIPPED_MATCHES_MIN):
        failed.append(f"shipped: matcher gate {gate}")
    mark("gate")
    vs_cpu, f = shipped_card_vs_cpu(torch, port, sg, *first, SHIPPED_GATE_HW)
    failed += f
    mark("card_vs_cpu")

    img = api_images(torch, CANVAS_HW, seed=43)[0]
    with torch.inference_mode():
        ident = api._match_images(model, img, img)
    m = ident["matches"]
    dist = np.linalg.norm(ident["kpts0"][m[0]] - ident["kpts1"][m[1]],
                          axis=-1)
    identity = {"matches": int(m.shape[1]),
                "median_px": float(np.median(dist)) if len(dist) else None,
                "threshold": sg.match_threshold}
    if not (m.shape[1] >= SHIPPED_MATCHES_MIN
            and identity["median_px"] < IDENTITY_PX):
        failed.append(f"shipped: identity check {identity}")
    mark("identity")

    phase_s = time.perf_counter() - t0
    if phase_s > SHIPPED_PHASE_S:
        failed.append(f"shipped phase took {phase_s:.1f} s > "
                      f"{SHIPPED_PHASE_S}")
    fields = {"stores": stores, "decoder": decoder_record,
              "build_shipped_model_s": build_s, "path": path,
              "matcher_gate": gate, "card_vs_cpu": vs_cpu,
              "identity": identity, "split_s": split,
              "shipped_phase_s": phase_s, "failures": failed}
    return fields, launches, trees


# ---------------------------------------------------------------- trained --

# The all-trained main path: bench stage 5 (bench.py:298-400) with every
# weight trained. The flagship OETR from .ckpt_oetr_r5/params in bf16 with
# K2 and K3 on (heatmap boxes on bilinear 640² copies, scales 832/640),
# SuperPoint (k 2048, descriptor 128, threshold 0) and SuperGlue
# (descriptor 128, K4 on) from .ckpt_matching_r5 in bf16,
# fallback_min_matches 30, on 8 generator pairs of 832² with stage 5's
# settings (profile_forward.SCENE_KW). Then the trained dense path,
# build_shipped_model("loftr", with_overlap=True), and JAX's LoFTR gate.
TRAINED_PAIRS = 8
TRAINED_SEED = 7             # bench.py:380's jax.random.key(7)
TRAINED_REPS = 3
TRAINED_MIN_MATCHES = 30     # bench.py:374
TRAINED_DENSE_PAIRS = 4
TRAINED_DENSE_SEED = 9
# The trained OETR in f32 on the card (K2, K3 on, TF32 off) against the
# port on the CPU on the path's 640² copies of TRAINED_CPU_PAIRS pairs: the
# tlbr outputs within VARIANT_TLBR_TOL, the heat maps within
# VARIANT_PROB_RTOL of their largest entry, both box decodes within the f32
# slice's BOX_TOL_PX. The CPU's own spread under a one-ulp nudge of the
# images, read on three generator pairs of 640² before the first chip run:
# tlbr and both boxes 0, heat maps 6.4e-7 to 1.3e-6 of their largest entry
# (each bound ~75x that); the phase reads it again on the card's inputs.
TRAINED_CPU_PAIRS = 1
# tests/test_shipped_loftr_gate.py: 4 held-out generator pairs of 256²
# (key 991 there, seed 991 here), scale_range (1.0, 2.0), p_translate 0.5;
# >= 100 valid matches a pair on average, and the median endpoint error
# against the depth and pose warp (training/loftr.py's
# warp_cell_centers_batch) < 2.5 px.
LOFTR_GATE_HW, LOFTR_GATE_PAIRS, LOFTR_GATE_SEED = 256, 4, 991
LOFTR_GATE_MATCHES = 100
LOFTR_GATE_MEDIAN_PX = 2.5
TRAINED_PHASE_S = 20.0


def trained_stores(names):
    """The committed stores ``names`` (keys of ``api.SHIPPED_CKPTS``) read
    by ``api.shipped_tree`` (the port's reader, as build_shipped_model reads
    them). Returns ({name: flax tree}, {name: seconds, arrays, bytes}); a
    missing store fails the phase with its path."""
    from pathlib import Path

    from oetr_tpu_torch.pipelines import api

    root = Path(api.__file__).resolve().parents[2]
    trees, stats = {}, {}
    for name in names:
        t = time.perf_counter()
        try:
            trees[name] = api.shipped_tree(name)
        except FileNotFoundError as e:
            raise AssertionError(f"trained: {e} (the chip copy must take "
                                 "every committed store)") from None
        stats[name] = {"read_s": time.perf_counter() - t, **store_stats(
            trees[name], root / api.SHIPPED_CKPTS[name])}
    return trees, stats


def stage5_models(torch, port, trees, dtype_name, kernels=True,
                  device=None):
    """bench stage 5's models (bench.py:306-373) from the committed trees,
    on ``device`` (DEV by default): the flagship OETR
    (``oetr_r50_kernels_config`` with the switches on, ``oetr_r50_config``
    off), SuperPoint and SuperGlue at the shipped widths (K4 with the
    switches), all computing in ``dtype_name``. The parameters stay float32
    and each op casts them, as flax does."""
    from oetr_tpu_torch.interop import (convert_flax_params,
                                        convert_superglue_params,
                                        convert_superpoint_params)
    from oetr_tpu_torch.pipelines.api import SHIPPED_SG, SHIPPED_SP

    dev = device or DEV
    dt = getattr(torch, dtype_name)
    cfg = (port.oetr_r50_kernels_config(dtype_name) if kernels
           else port.replace(port.oetr_r50_config(), dtype=dtype_name))

    def load(module, state):
        module.load_state_dict(state)
        return module

    return (load(port.build_oetr(cfg, device=dev),
                 convert_flax_params(trees["oetr"], cfg)),
            load(port.build_superpoint(device=dev, dtype=dt, **SHIPPED_SP),
                 convert_superpoint_params(trees["superpoint"],
                                           **SHIPPED_SP)),
            load(port.build_superglue(device=dev, dtype=dt,
                                      cuda_sinkhorn=kernels, **SHIPPED_SG),
                 convert_superglue_params(trees["superglue"],
                                          **SHIPPED_SG)))


def trained_on_vs_off(torch, port, trees, models, first, first_m0, args):
    """Stage 5's first pass with every switch on (``first``, its SuperGlue
    matches ``first_m0``, from ``models``) against the same weights with
    every switch off on the same arguments: OETR's boxes on the OETR copies
    within the bf16 BOX_TOL_PX, ``used_overlap`` equal, and on the pairs
    whose two first passes cropped the same boxes, the same keypoints and
    ``matches0`` at 0.2 equal on >= MATCH_AGREE_MIN of the valid keypoints;
    the other pairs' agreement is reported apart. Returns (fields,
    failures)."""
    hw = int(args[4].shape[1])
    off = stage5_models(torch, port, trees, "bfloat16", kernels=False,
                        device=args[0].device)
    cap_off = Capture(off[2])
    pipe_off = pipeline(port, (off[0], models[1], off[2]), cap_off,
                        TRAINED_MIN_MATCHES)
    with torch.inference_mode():
        first_off = pipe_off._run(*args, use_overlap=True)
        m0_off = cap_off.last["matches0"]
        raw_on = models[0](args[4], args[5])
        raw_off = off[0](args[4], args[5])
    check_outputs(torch, port.oetr_r50_kernels_config("bfloat16"), raw_on,
                  int(args[4].shape[0]), hw, "trained OETR")
    oetr_px = box_diff_px(port, raw_on, raw_off, hw)
    same_crop = ((first["bbox0"] == first_off["bbox0"]).all(-1)
                 & (first["bbox1"] == first_off["bbox1"]).all(-1)).tolist()
    failed, agree, apart = [], {}, {}
    for i, same in enumerate(same_crop):
        a = match_agreement(first_m0[i], m0_off[i], first["valid0"][i])
        if not same:
            apart[i] = a
            continue
        agree[i] = a
        if not torch.equal(first["keypoints0"][i],
                           first_off["keypoints0"][i]):
            failed.append(f"trained on vs off: pair {i}'s keypoints differ "
                          "on equal crops")
    fields = {
        "oetr_box_max_diff_px": oetr_px,
        "oetr_box_tol_px": BOX_TOL_PX["bfloat16"],
        "used_overlap_equal": torch.equal(first["used_overlap"],
                                          first_off["used_overlap"]),
        "pairs_same_crops": sum(same_crop),
        "matches_agree_thr_0.2_same_crops": agree,
        "matches_agree_thr_0.2_other_pairs": apart,
        "agree_min": MATCH_AGREE_MIN,
        "matches_thr_0.2_off": first_off["num_matches"].tolist()}
    if not oetr_px <= BOX_TOL_PX["bfloat16"]:
        failed.append(f"trained OETR on vs off: {oetr_px} px")
    if not fields["used_overlap_equal"]:
        failed.append("trained on vs off: used_overlap differs")
    if any(a < MATCH_AGREE_MIN for a in agree.values()):
        failed.append(f"trained on vs off: matches agree {agree}")
    return fields, failed


def trained_card_vs_cpu(torch, port, card, o0, o1):
    """The trained OETR in f32 on the card (``card``, K2 and K3 on) against
    its copy on the CPU (plain versions) on the OETR copies ``o0``, ``o1``,
    and the CPU against itself with the images nudged up by one ulp.
    Returns (fields, failures)."""
    import copy

    cpu = copy.deepcopy(card).to("cpu")
    c0, c1 = o0.float().cpu(), o1.float().cpu()
    ones = torch.ones_like(c0)
    with torch.inference_mode():
        a = card(o0.float(), o1.float())
        r = cpu(c0, c1)
        nudged = cpu(torch.nextafter(c0, ones), torch.nextafter(c1, ones))
    hw = tuple(c0.shape[1:3])

    def gaps(x, y):
        out = {}
        for key in ("tlbr1", "tlbr2", "prob_map1", "prob_map2",
                    "pred_bbox1", "pred_bbox2"):
            d = (x[key].float().cpu() - y[key]).abs().max().item()
            out[key] = d / y[key].abs().max().item() \
                if key.startswith("prob") else d
        hx = port.decode_boxes({k: v.cpu() for k, v in x.items()}, hw, hw,
                               source="heatmap")
        hy = port.decode_boxes(y, hw, hw, source="heatmap")
        out["heatmap_boxes_px"] = max((p - q).abs().max().item()
                                      for p, q in zip(hx, hy))
        return out

    tol = lambda key: (VARIANT_PROB_RTOL if key.startswith("prob")
                       else VARIANT_TLBR_TOL if key.startswith("tlbr")
                       else BOX_TOL_PX["float32"])
    fields = {"pairs": int(c0.shape[0]), "dtype": "float32", "hw": hw[0],
              "card_vs_cpu": gaps(a, r),
              "cpu_one_ulp_spread": gaps(nudged, r),
              "tlbr_tol": VARIANT_TLBR_TOL, "prob_rtol": VARIANT_PROB_RTOL,
              "box_tol_px": BOX_TOL_PX["float32"],
              "prob_max": r["prob_map1"].max().item()}
    failed = [f"trained OETR f32 card vs CPU: {key} {v} > {tol(key)}"
              for key, v in fields["card_vs_cpu"].items() if not v <= tol(key)]
    return fields, failed


def loftr_gate(torch, port, loftr):
    """JAX's LoFTR gate (tests/test_shipped_loftr_gate.py:27-68) through the
    port's trained LoFTR on the card. Returns the fields."""
    import numpy as np

    from oetr_tpu_torch.training.loftr import warp_cell_centers_batch

    b = LOFTR_GATE_PAIRS
    gen = port.make_device_generator(LOFTR_GATE_HW, b, scale_range=(1.0, 2.0),
                                     p_translate=0.5, device=DEV)
    raw = gen(torch.Generator(device=DEV).manual_seed(LOFTR_GATE_SEED))
    lum = torch.tensor([0.299, 0.587, 0.114], device=DEV)
    with torch.inference_mode():
        out = loftr((raw["image1"] @ lum)[..., None],
                    (raw["image2"] @ lum)[..., None])
        T = raw["pose2"] @ torch.linalg.inv(raw["pose1"])
        gt_xy1, gt_ok = warp_cell_centers_batch(
            out["mkpts0"], raw["depth1"], raw["K1"], T, raw["K2"],
            depth1=raw["depth2"])
    valid = out["valid"] & gt_ok
    err = (out["mkpts1"] - gt_xy1).norm(dim=-1)[valid].cpu().numpy()
    return {"hw": LOFTR_GATE_HW, "pairs": b, "seed": LOFTR_GATE_SEED,
            "valid_matches_per_pair": valid.sum(-1).tolist(),
            "matches_min_mean": LOFTR_GATE_MATCHES,
            "median_endpoint_px": float(np.median(err)) if len(err) else None,
            "median_max_px": LOFTR_GATE_MEDIAN_PX,
            "p90_endpoint_px": (float(np.percentile(err, 90)) if len(err)
                                else None)}


def run_trained(torch, port, ops, matching):
    """The all-trained main path on the card:
      (a) the OETR and LoFTR stores read by the port's reader (a missing
          store fails the phase; no seeded or CPU fallback): seconds,
          arrays, bytes;
      (b) bench stage 5 (``stage5_models`` in bf16, K2, K3, K4 on, 832²
          canvases, 640² OETR copies, fallback 30, heatmap boxes) on
          TRAINED_PAIRS generator pairs: pairs/s (median of TRAINED_REPS
          calls), busy ms, idle share and launches of one traced call, the
          kernels' calls a call (16 / 1 / 1 + one K4 a retry chunk),
          matches over 0.2 a pair, ``used_overlap``, the pairs retried and
          each pair's first-pass box IoU against the generator's GT boxes;
          then the retry forced (fallback one above the most matches a
          pair reached): K4 1 + one a chunk, no pair left on its crops,
          each pair's matches equal to its chunk's run alone;
      (c) every K2, K3 and K4 call of that call against its plain version
          on the same inputs; the same weights with every switch off:
          OETR's boxes on the 640² copies within the bf16 16 px,
          ``used_overlap`` equal, and where both first passes cropped the
          same boxes, ``matches0`` at 0.2 equal on >= MATCH_AGREE_MIN of
          the valid keypoints (the other pairs reported apart); the OETR in
          f32 on the card against the CPU (``trained_card_vs_cpu``, on the
          dense path's OETR);
      (d) ``build_shipped_model("loftr", with_overlap=True)`` (its stores
          handed over from (a)) on TRAINED_DENSE_PAIRS pairs of 832²:
          pairs/s, busy ms, idle share, K2 32 and K3 1 CUDA launches in its
          trace, every K2 and K3 call against its plain version; JAX's
          LoFTR gate (``loftr_gate``); stage 5's
          matches scored with ``estimate_pose``, guided and direct
          (``with_overlap=False``) on the same pairs (a reading: 8 pairs
          are too few to gate an AUC).
    ``matching``: the SuperPoint and SuperGlue trees the ``shipped`` phase
    read. Returns (fields, the launches of the stage-5 and dense calls)."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.geometry.boxes import bbox_overlaps_aligned
    from oetr_tpu_torch.pipelines import api

    t0 = time.perf_counter()
    split = {}
    mark = lambda name: split.__setitem__(name, time.perf_counter() - t0)
    failed = []

    # (a) The stores.
    trees, stores = trained_stores(("oetr", "loftr"))
    trees.update(matching)
    mark("read")

    # (b) Stage 5, every weight trained.
    models = stage5_models(torch, port, trees, "bfloat16")
    cap = Capture(models[2])
    pipe = pipeline(port, models, cap, TRAINED_MIN_MATCHES)
    args, raw = scene_inputs(TRAINED_PAIRS, TRAINED_SEED)
    with torch.inference_mode():
        # The first pass (OETR, gate, crops, SuperPoint, SuperGlue) alone,
        # then one stage-5 call with every kernel call recorded.
        first = pipe._run(*args, use_overlap=True)
        first_m0 = cap.last["matches0"]
        need = ((first["num_matches"] < TRAINED_MIN_MATCHES)
                & first["used_overlap"]).cpu()
        with recorded_kernel_calls(sinkhorn=True) as calls:
            reset_counts(ops)
            out = pipe(*args)
            torch.cuda.synchronize()
            launches = launch_counts(ops)
    n_retry = int(need.sum())
    chunks = -(-n_retry // pipe.cfg.retry_batch)
    want = {name: 0 for name in KERNELS}
    want.update(linear_encoder_attention=16, groupnorm_relu_maxpool=1,
                log_sinkhorn_cuda=1 + chunks)
    recorded = {name: len(c) for name, c in calls.items()}
    if launches != want or recorded != {
            "linear_encoder_attention": 16, "groupnorm_relu_maxpool": 1,
            "log_optimal_transport": 1 + chunks}:
        raise AssertionError(f"trained stage 5: launches {launches} != "
                             f"{want}, recorded calls {recorded}")
    used_want = first["used_overlap"].cpu() & ~need
    if not torch.equal(out["used_overlap"].cpu(), used_want):
        failed.append(f"trained stage 5: used_overlap {out['used_overlap']}"
                      f" after the retry, not {used_want}")
    path_kernels = recorded_kernel_errors(torch, ops, calls,
                                          path="trained stage 5")
    del calls
    mark("stage5")
    with torch.inference_mode():
        wall_ms = timed_calls(torch, lambda: pipe(*args), TRAINED_REPS)
        stats = traced_stats(torch, lambda: pipe(*args), reps=1, names=(
            "linear_encoder_kernel", "gn_apply_pool_kernel", "sinkhorn"),
                             warmup=0, cpu=False)
    gt0, gt1 = raw["overlap_box1"].float(), raw["overlap_box2"].float()
    iou = torch.stack([bbox_overlaps_aligned(first["bbox0"], gt0),
                       bbox_overlaps_aligned(first["bbox1"], gt1)], -1)
    stage5 = {
        "pairs": TRAINED_PAIRS, "canvas_hw": CANVAS_HW, "oetr_hw": IMAGE_HW,
        "dtype": "bfloat16", "keypoints": models[1].max_keypoints,
        "descriptor_dim": models[2].descriptor_dim,
        "keypoint_threshold": models[1].keypoint_threshold,
        "fallback_min_matches": TRAINED_MIN_MATCHES,
        "generator": {**pf.SCENE_KW, "seed": TRAINED_SEED,
                      "scale": [round(v, 4) for v in raw["scale"].tolist()]},
        "pairs_per_s": TRAINED_PAIRS / wall_ms * 1e3, "wall_ms": wall_ms,
        "timing": f"median of {TRAINED_REPS} calls, host clock around a "
                  "synchronized call",
        "device_busy_ms": stats["device_busy_ms"],
        "idle_share": stats["idle_share"],
        "traced_wall_ms": stats["wall_ms"],
        "launches_per_call_traced": stats["launches_per_call"],
        "cuda_launches_per_call_traced": {
            k: stats[f"{k}_per_call"] for k in (
                "linear_encoder_kernel", "gn_apply_pool_kernel",
                "sinkhorn")},
        "device_ms_by_category": stats["device_ms_by_category"],
        "kernel_calls": {k: n for k, n in launches.items() if n},
        "kernel_outputs_vs_plain": path_kernels,
        "matches_thr_0.2_first_pass": first["num_matches"].tolist(),
        "matches_thr_0.2": out["num_matches"].tolist(),
        "used_overlap_first_pass": first["used_overlap"].tolist(),
        "used_overlap": out["used_overlap"].tolist(),
        "pairs_retried": n_retry, "retry_chunks": chunks,
        "box_iou_first_pass": [[round(v, 4) for v in p]
                               for p in iou.tolist()],
        "gt_overlap_valid": raw["overlap_valid"].tolist(),
        "bbox0_first_pass": [[round(v, 1) for v in p]
                             for p in first["bbox0"].tolist()],
        "gt_box1": raw["overlap_box1"].tolist()}
    mark("stage5_timed")

    # The retry forced with the trained weights: fallback_min_matches one
    # above the most matches a pair reached, so every pair that took its
    # crops is re-run on the full images in chunks of retry_batch (the last
    # padded with the first pair), each pair's result scattered back: equal
    # to its chunk's run alone. (Against one direct call on all 8 pairs the
    # counts move by a few matches: bf16 rounds with the batch's size.)
    forced_min = int(first["num_matches"].max()) + 1
    forced_pipe = pipeline(port, models, models[2], forced_min)
    idx = first["used_overlap"].nonzero().flatten()
    r = pipe.cfg.retry_batch
    padded = torch.cat([idx, idx[:1].repeat((-len(idx)) % r)])
    with torch.inference_mode():
        reset_counts(ops)
        forced_out = forced_pipe(*args)
        torch.cuda.synchronize()
        forced_launches = launch_counts(ops)
        alone = [pipe._run(*(a[padded[c:c + r]] for a in args[:4]))
                 for c in range(0, len(padded), r)]
    chunk_m0 = torch.cat([c["matches0"] for c in alone])[:len(idx)]
    forced = {"fallback_min_matches": forced_min, "pairs_retried": len(idx),
              "kernel_calls": {k: n for k, n in forced_launches.items()
                               if n},
              "matches_thr_0.2": forced_out["num_matches"].tolist(),
              "scattered_equal_chunks": torch.equal(
                  forced_out["matches0"][idx], chunk_m0)}
    if (forced_launches != dict(want, log_sinkhorn_cuda=1 + len(alone))
            or forced_out["used_overlap"].any()
            or not forced["scattered_equal_chunks"]):
        failed.append(f"trained forced retry: {forced}")
    del forced_pipe, forced_out, alone
    mark("forced_retry")

    # (c) The same weights with every switch off (the f32 card vs CPU check
    # comes after the dense path, whose OETR it takes).
    on_off, f = trained_on_vs_off(torch, port, trees, models, first,
                                  first_m0, args)
    failed += f
    mark("on_vs_off")
    # (d) The trained dense path, JAX's LoFTR gate, stage 5's poses.
    read = api.shipped_tree
    api.shipped_tree = lambda name, ckpt_root=None: trees[name]
    try:
        dense, _ = api.build_shipped_model("loftr", with_overlap=True,
                                           device=DEV)
    finally:
        api.shipped_tree = read
    dargs, _ = scene_inputs(TRAINED_DENSE_PAIRS, TRAINED_DENSE_SEED)
    with torch.inference_mode():
        dense(*dargs)       # cuDNN picks LoFTR's convolutions at 832²
        with recorded_kernel_calls() as dcalls:
            reset_counts(ops)
            dout = dense(*dargs)
            torch.cuda.synchronize()
            dense_launches = launch_counts(ops)
        dense_want = {name: 0 for name in KERNELS}
        dense_want.update(linear_encoder_attention=16,
                          groupnorm_relu_maxpool=1)
        if dense_launches != dense_want:
            raise AssertionError(f"trained dense: launches {dense_launches}"
                                 f" != {dense_want}")
        dense_kernels = recorded_kernel_errors(torch, ops, dcalls,
                                               path="trained dense")
        del dcalls
        dense_ms = timed_calls(torch, lambda: dense(*dargs), TRAINED_REPS)
        dstats = traced_stats(torch, lambda: dense(*dargs), reps=1, names=(
            "linear_encoder_kernel", "gn_apply_pool_kernel"), warmup=0,
                              cpu=False)
    # K2 is two CUDA launches a call, K3 three (statistics, fold, apply).
    traced = {k: dstats[f"{k}_per_call"] for k in (
        "linear_encoder_kernel", "gn_apply_pool_kernel")}
    if traced != {"linear_encoder_kernel": 32, "gn_apply_pool_kernel": 1}:
        failed.append(f"trained dense: traced launches a call {traced}")
    dense_fields = {
        "pairs": TRAINED_DENSE_PAIRS, "canvas_hw": CANVAS_HW,
        "oetr_hw": IMAGE_HW, "dtype": "float32",
        "config": {k: getattr(dense.cfg, k) for k in (
            "fallback_min_matches", "retry_batch", "box_source")},
        "pairs_per_s": TRAINED_DENSE_PAIRS / dense_ms * 1e3,
        "wall_ms": dense_ms,
        "device_busy_ms": dstats["device_busy_ms"],
        "idle_share": dstats["idle_share"],
        "launches_per_call_traced": dstats["launches_per_call"],
        "cuda_launches_per_call_traced": traced,
        "device_ms_by_category": dstats["device_ms_by_category"],
        "kernel_calls": {k: n for k, n in dense_launches.items() if n},
        "kernel_outputs_vs_plain": dense_kernels,
        "matches_per_pair": dout["num_matches"].tolist(),
        "used_overlap": dout["used_overlap"].tolist()}
    mark("dense")
    # The dense path's OETR is the trained flagship in f32 (K2, K3 on).
    vs_cpu, f = trained_card_vs_cpu(torch, port, dense.oetr,
                                    args[4][:TRAINED_CPU_PAIRS],
                                    args[5][:TRAINED_CPU_PAIRS])
    failed += f
    mark("card_vs_cpu")
    gate = loftr_gate(torch, port, dense.loftr)
    n_valid = gate["valid_matches_per_pair"]
    if not (sum(n_valid) >= LOFTR_GATE_MATCHES * len(n_valid)
            and gate["median_endpoint_px"] is not None
            and gate["median_endpoint_px"] < LOFTR_GATE_MEDIAN_PX):
        failed.append(f"trained LoFTR gate: {gate}")
    del dense, dout, dargs
    mark("loftr_gate")
    with torch.inference_mode():
        direct = pipe(*args, with_overlap=False)
        reset_counts(ops)
        poses = {"guided": score_matches(torch, port, out, raw),
                 "direct": score_matches(torch, port, direct, raw)}
        torch.cuda.synchronize()
    poses["eigh_launches"] = launch_counts(ops)["eigh"]
    mark("pose")

    phase_s = time.perf_counter() - t0
    if phase_s > TRAINED_PHASE_S:
        failed.append(f"trained phase took {phase_s:.1f} s > "
                      f"{TRAINED_PHASE_S}")
    total = collections.Counter(launches)
    total.update(dense_launches)
    fields = {"weights": {"oetr": ".ckpt_oetr_r5/params",
                          "superpoint": ".ckpt_matching_r5/superpoint",
                          "superglue": ".ckpt_matching_r5/superglue",
                          "loftr": ".ckpt_loftr_r5/loftr"},
              "stores": stores, "stage5": stage5, "forced_retry": forced,
              "on_vs_off": on_off,
              "oetr_f32_card_vs_cpu": vs_cpu, "dense": dense_fields,
              "loftr_gate": gate, "pose": poses, "split_s": split,
              "trained_phase_s": phase_s, "failures": failed}
    return fields, dict(total)


# -------------------------------------------------------------------- sfm --

# Part (a): the SfM demo's rig at scripts/sfm_demo.py's defaults (12 views
# of 320², a 45° arc, pixel noise 6, seed 3, pairs within 3 views: 30
# edges, BA 20 steps), its correspondences from the rendered depths (no
# cv2 for SIFT and no trained matcher weights on the card's machine): a
# grid every 8 px, 0.5 px noise, 20% outliers.
SFM_VIEWS, SFM_HW, SFM_ARC_DEG, SFM_NOISE = 12, 320, 45.0, 6.0
SFM_SEED, SFM_SPAN, SFM_BA_ITERS = 3, 3, 20
# The card's triangulated points against the CPU's from the same cameras:
# each valid track's largest reprojection error, in px (AᵀA is badly
# scaled, so a narrow-baseline track's raw coordinates follow the
# eigensolver's last bits; its reprojection error much less). The phase
# reads beside it the CPU against itself with the cameras nudged by one
# ulp (``cpu_spread_px_valid``: 0.0048-0.0083 px on the H100 runs).
SFM_REPROJ_PX = 0.05
# Part (b): bundle adjustment at the counts of BAL's Dubrovnik-16 (Agarwal
# et al., "Bundle Adjustment in the Large", 2010): 16 cameras, 22,106
# points, 83,718 observations, with reconstruct's settings (15 steps, 40
# CG iterations, Huber 4 px); seeded points seen by a ring of pinhole
# cameras, in float32. Only the counts are BAL's, not its camera model.
BAL_CAMS, BAL_POINTS, BAL_OBS = 16, 22106, 83718
BAL_ITERS, BAL_CG_ITERS, BAL_HUBER = 15, 40, 4.0
SFM_REPS = 2
# The traced call's LM steps: a trace of all 15 (~31k launches) took ~15 s
# of host time to read. Its fields are a 3-step call's; ``ba_trace_steps.py``
# holds them against a traced 15-step call's.
BAL_TRACE_ITERS = 3
# The CPU's BA runs in a child process beside part (a), on 4 of the
# machine's 8 cores (its index_add_s slow down with more threads).
CPU_BA_THREADS = 4
# BA on the card against the port on the CPU, same inputs: the final cost
# within BAL_COST_RTOL of cost0, the cameras within BAL_CAMS_TOL and the ATE
# against the truth within BAL_ATE of the CPU's. The CPU against itself
# with obs_uv nudged by one ulp moved them by 3.7e-9 of cost0, 2.0e-5 and
# 2.7e-8 (points 1.5e-5; the cost history by up to 1.9e-6 of cost0;
# ``python3 sfm_spread.py``); the card sums in other orders (atomic adds),
# so each bound leaves ~50x over that spread.
BAL_COST_RTOL = 2e-7
BAL_CAMS_TOL = 1e-3
BAL_ATE = 1.5e-6
BAL_SEED = 21


def bal_problem(full_ring=False):
    """A BA problem of Dubrovnik-16's counts: cameras on a half ring of
    radius 10 around the origin (yaw -90° to 90°, none at zero rotation),
    each looking at it, f = 500 on 640x480; points in a ball of radius 2;
    each point seen by 3 or 4 cameras in a row (17,400 of them by 4),
    pixels with 0.5 px noise. Half a ring, not a whole one: JAX's BA takes
    its Jacobian in the so3 log but applies the step on the right of the
    rotation, which agree near zero rotation only, and with cameras near
    180° it stalls after one step (JAX and the port alike; ``full_ring``
    puts the 16 cameras all around, at yaws off the axes by half a step,
    to show it: sfm_spread.py). Returns (the
    arguments of bundle_adjust as CPU tensors: initial cameras 0.01 rad /
    0.05 off, points 0.05 off, camera 0 exact; the true cameras [C, 6]
    float64)."""
    import numpy as np
    import torch

    from oetr_tpu_torch.evalx.trajectory import so3_exp_np
    from oetr_tpu_torch.sfm.demo import _log_so3

    rng = np.random.default_rng(BAL_SEED)
    cams = []
    yaws = ((np.arange(BAL_CAMS) + 0.5) / BAL_CAMS * 2 * np.pi if full_ring
            else np.deg2rad(np.linspace(-90.0, 90.0, BAL_CAMS)))
    for a in yaws:
        c = np.array([10 * np.sin(a), 0.5 * np.sin(3 * a), -10 * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        cams.append(np.concatenate([_log_so3(R), -R @ c]))
    cams = np.stack(cams)
    pts = rng.normal(size=(BAL_POINTS, 3))
    pts *= 2 * rng.random((BAL_POINTS, 1)) ** (1 / 3) / np.linalg.norm(
        pts, axis=1, keepdims=True)
    per = np.full(BAL_POINTS, 3)
    per[rng.permutation(BAL_POINTS)[:BAL_OBS - 3 * BAL_POINTS]] = 4
    op = np.repeat(np.arange(BAL_POINTS), per)
    start = np.repeat(rng.integers(0, BAL_CAMS, BAL_POINTS), per)
    rank = np.arange(len(op)) - np.repeat(np.cumsum(per) - per, per)
    oc = (start + rank) % BAL_CAMS
    K = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]]),
                (BAL_CAMS, 1, 1))
    R = np.stack([so3_exp_np(c[:3]) for c in cams])
    x = np.einsum("oij,oj->oi", R[oc], pts[op]) + cams[oc, 3:]
    uv = np.einsum("oij,oj->oi", K[oc], x / x[:, 2:])[:, :2]
    uv += rng.normal(0, 0.5, uv.shape)
    init = cams + np.concatenate([rng.normal(0, 0.01, (BAL_CAMS, 3)),
                                  rng.normal(0, 0.05, (BAL_CAMS, 3))], 1)
    init[0] = cams[0]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return [f32(init), f32(pts + rng.normal(0, 0.05, pts.shape)), f32(K),
            torch.as_tensor(oc), torch.as_tensor(op), f32(uv),
            torch.ones(len(op), dtype=torch.bool)], cams


def triangulation_vs_cpu(torch, recon, K):
    """The tracks of ``recon`` triangulated on the card and on the CPU from
    its cameras (float32), and on the CPU from the cameras nudged by one
    ulp: each track's largest reprojection error from each. Returns the
    fields: the largest gap card vs CPU over the valid tracks (bounded by
    SFM_REPROJ_PX) and over all, beside the CPU's own under the nudge."""
    import numpy as np

    from oetr_tpu_torch.sfm import ba
    from oetr_tpu_torch.sfm.reconstruct import _tracks_to_view_arrays

    tracks = recon["tracks"]
    cam_tbl, uv_tbl, valid_tbl = _tracks_to_view_arrays(tracks, SFM_SPAN + 1)
    n = len(recon["cams"])
    nudged = np.nextafter(recon["cams"], np.float32(np.inf))
    err = {}
    for name, dev, cams in ((str(DEV), DEV, recon["cams"]),
                            ("cpu", "cpu", recon["cams"]),
                            ("cpu_nudged", "cpu", nudged)):
        to = lambda a: torch.as_tensor(a, device=dev)
        cams = to(cams)
        Kt = to(np.tile(K[None], (n, 1, 1)).astype(np.float32))
        tbl = to(cam_tbl).long()
        pts = ba.triangulate_points(cams[tbl], Kt[tbl], to(uv_tbl),
                                    to(valid_tbl))
        r = ba.residuals(cams, pts, Kt, to(tracks.obs_cam).long(),
                         to(tracks.obs_pt).long(), to(tracks.obs_uv),
                         torch.ones(len(tracks.obs_cam), device=dev))
        e = np.zeros(tracks.num_tracks)
        np.maximum.at(e, tracks.obs_pt, r.norm(dim=-1).cpu().numpy())
        err[name] = e
    pv = recon["point_valid"]
    gap = np.abs(err[str(DEV)] - err["cpu"])
    spread = np.abs(err["cpu_nudged"] - err["cpu"])
    return {"tracks": tracks.num_tracks, "valid_tracks": int(pv.sum()),
            "max_gap_px_valid": float(gap[pv].max()),
            "max_gap_px_all": float(gap.max()),
            "cpu_spread_px_valid": float(spread[pv].max()),
            "cpu_spread_px_all": float(spread.max()),
            "median_reproj_px_valid": float(np.median(err[str(DEV)][pv])),
            "bound_px_valid": SFM_REPROJ_PX,
            "within": bool(gap[pv].max() <= SFM_REPROJ_PX)}


def run_sfm_rig(torch, port, ops):
    """Part (a): the demo's rig on the card (``oetr_tpu_torch.sfm.demo``'s
    steps: ``two_view`` per edge, ``chain_init``, both ``reconstruct_rows``,
    the exports read back with ``read_model``), every eigh call of the
    path recorded and held to LAPACK. Returns (fields, the eigh inputs of
    the path, the eigh launches of the path)."""
    import os
    import tempfile

    from oetr_tpu_torch.sfm import demo, read_model

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())

    images, K, gt, depths = demo.render_rig(SFM_VIEWS, SFM_HW, SFM_SEED,
                                            arc_deg=SFM_ARC_DEG,
                                            noise=SFM_NOISE)
    edges = demo.edges_within(SFM_VIEWS, SFM_SPAN)
    kps, cands = demo.depth_candidates(depths, K, gt, edges, seed=SFM_SEED)
    lap("render_and_correspondences")
    reset_counts(ops)
    with recorded_eigh_inputs() as calls:
        matches, rel = demo.two_view(cands, K, DEV)
        lap("two_view")
        init = demo.chain_init(kps, matches, rel, K, SFM_VIEWS, DEV)
        lap("chain_init")
        recon, rec2, ate = demo.reconstruct_rows(
            kps, matches, K, gt, init, demo.odometry_init(gt, SFM_SEED),
            SFM_SPAN, SFM_BA_ITERS, DEV)
        torch.cuda.synchronize()
    launches = launch_counts(ops)
    lap("reconstruct_rows")
    if launches["eigh"] == 0 or any(n for k, n in launches.items()
                                    if k != "eigh"):
        raise AssertionError(f"sfm launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        exported = demo.export(tmp, kps, matches, K, recon)
        cams_r, images_r, points_r = read_model(tmp)
        db_bytes = os.path.getsize(os.path.join(tmp, "database.db"))
    if not (exported and len(cams_r) == len(images_r) == SFM_VIEWS
            and len(points_r) == int(recon["point_valid"].sum())):
        raise AssertionError("sfm export: the model read back differs")
    lap("export")
    summary = demo.summary(recon, ate)
    chain_h, odo_h = recon["cost_history"], rec2["cost_history"]
    fields = {
        "views": SFM_VIEWS, "hw": SFM_HW, "arc_deg": SFM_ARC_DEG,
        "noise": SFM_NOISE, "seed": SFM_SEED, "max_span": SFM_SPAN,
        "ba_iters": SFM_BA_ITERS, "correspondences": "rendered depths",
        "keypoints_per_view": [len(k) for k in kps],
        "edges": len(edges), "edges_kept": len(matches),
        "inliers_per_edge": [int(m.shape[1]) for m in matches.values()],
        **summary,
        "chain_cost": [float(chain_h[0]), float(chain_h[-1])],
        "odometry_cost": [float(odo_h[0]), float(odo_h[-1])],
        "chain_ba_noop": bool((chain_h == chain_h[0]).all()),
        "chain_ba_noop_expected": "camera 0 at exactly zero rotation: "
                                  "JAX's f32 NaN Jacobian, every step "
                                  "rejected",
        "odometry_gate": summary["ate_rmse_odometry_ba"]
        < 0.5 * summary["ate_rmse_odometry_init"],
        "export": {"points3D": len(points_r), "images": len(images_r),
                   "database_bytes": db_bytes},
        "launches": {k: n for k, n in launches.items() if n}}
    fields["triangulation_vs_cpu"] = triangulation_vs_cpu(torch, rec2, K)
    lap("triangulation_vs_cpu")
    fields["seconds"] = seconds
    return fields, calls, launches["eigh"]


CPU_BA_CHILD = """
import sys, time
import numpy as np
import torch
import torch._dynamo  # forward-mode AD imports it on first use
import chip_smoke as cs
from oetr_tpu_torch.sfm import bundle_adjust
torch.set_num_threads(cs.CPU_BA_THREADS)
args, _ = cs.bal_problem()
path = sys.stdin.readline().strip()
if not path:  # the parent ended without the sfm phase
    sys.exit(0)
with torch.inference_mode():
    t0 = time.perf_counter()
    r = bundle_adjust(*args, iters=cs.BAL_ITERS, cg_iters=cs.BAL_CG_ITERS,
                      huber_delta=cs.BAL_HUBER)
np.savez(path, cams=r["cams"].numpy(), pts=r["pts"].numpy(),
         cost_history=r["cost_history"].numpy(),
         seconds=time.perf_counter() - t0)
"""


def start_cpu_ba():
    """A child process for the port's BA of ``bal_problem()`` on the CPU
    (not a thread: torch's forward-AD levels are global to a process). It
    imports torch, the port and torch._dynamo and builds the problem at
    once (started while nvcc builds), then waits for an npz path on its
    stdin before it computes; the sfm phase sends the path and runs the
    card meanwhile. Stopped at exit if it is still running."""
    import atexit
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    child = subprocess.Popen([sys.executable, "-c", CPU_BA_CHILD], cwd=root,
                             env=env, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)

    def stop():
        if child.poll() is None:
            child.kill()
            child.wait()

    atexit.register(stop)
    return child


def cpu_ba_result(torch, child, path):
    """Waits for ``start_cpu_ba``'s child; raises if it failed."""
    import numpy as np

    out, _ = child.communicate(timeout=300)
    if child.returncode != 0:
        raise RuntimeError(f"the CPU's bundle_adjust failed:\n{out[-4000:]}")
    with np.load(path) as f:
        return {k: torch.as_tensor(f[k]) for k in f.files}


def run_sfm_bal(torch):
    """Part (b) on the card: ``bundle_adjust`` at Dubrovnik-16's counts:
    ms a call and a step, and from a traced call of BAL_TRACE_ITERS LM
    steps busy ms, idle share, launches and device -> host copies (none
    allowed) a call and a step; peak memory, a second run against the
    first. Returns (fields, the first run's result, the problem's true
    cameras and initial ones)."""
    from oetr_tpu_torch.sfm import bundle_adjust

    args, truth = bal_problem()
    on_card = [a.to(DEV) for a in args]
    kw = dict(iters=BAL_ITERS, cg_iters=BAL_CG_ITERS, huber_delta=BAL_HUBER)
    call = lambda: bundle_adjust(*on_card, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = call()                       # the first of the warm-up calls
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    again = call()                      # the second
    ms = time_ms(torch, call, reps=SFM_REPS, warmup=0)
    stats = traced_stats(torch, lambda: bundle_adjust(
        *on_card, **dict(kw, iters=BAL_TRACE_ITERS)), reps=1, warmup=0,
        cpu=False)
    if stats["dtoh_copies_per_call"] != 0:
        raise AssertionError(f"bundle_adjust: device -> host copies {stats}")
    fields = {
        "cameras": BAL_CAMS, "points": BAL_POINTS, "observations": BAL_OBS,
        "source": "BAL Dubrovnik-16's counts (Agarwal et al. 2010)",
        "iters": BAL_ITERS, "cg_iters": BAL_CG_ITERS,
        "huber_delta": BAL_HUBER, "dtype": "float32",
        "ms_per_call": ms, "ms_per_lm_step": ms / BAL_ITERS,
        "timing": f"median of {SFM_REPS} CUDA-event calls after 2 "
                  f"warm-ups",
        f"traced_call_{BAL_TRACE_ITERS}_lm_steps": {
            k: stats[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                  "launches_per_call",
                                  "dtoh_copies_per_call",
                                  "device_ms_by_category")},
        f"busy_ms_per_lm_step_of_{BAL_TRACE_ITERS}": stats["device_busy_ms"]
        / BAL_TRACE_ITERS,
        f"launches_per_lm_step_of_{BAL_TRACE_ITERS}":
        stats["launches_per_call"] / BAL_TRACE_ITERS,
        "peak_memory_bytes": peak,
        "card_vs_card_cams_max_abs": float(
            (card["cams"] - again["cams"]).abs().max())}
    return fields, card, truth, args[0]


def bal_vs_cpu(card, cpu, truth, init):
    """The card's BA result against the CPU's (``cpu_ba_result``): final
    cost, cameras, points, ATE against the truth. Returns (fields,
    failures)."""
    from oetr_tpu_torch.evalx.trajectory import absolute_trajectory_error

    h_card, h_cpu = card["cost_history"].cpu(), cpu["cost_history"]
    ate = {name: absolute_trajectory_error(c.cpu().numpy(), truth)
           for name, c in (("card", card["cams"]), ("cpu", cpu["cams"]),
                           ("init", init))}
    cost_rel = abs(float(h_card[-1] - h_cpu[-1])) / float(h_cpu[0])
    ate_gap = abs(ate["card"]["ate_rmse"] - ate["cpu"]["ate_rmse"])
    gaps = {"final_cost_rel": cost_rel, "ate_rmse_gap": ate_gap,
            "cams_max_abs": float((card["cams"].cpu() - cpu["cams"])
                                  .abs().max()),
            "pts_max_abs": float((card["pts"].cpu() - cpu["pts"])
                                 .abs().max())}
    fields = {"cost": [float(h_card[0]), float(h_card[-1])],
              "cpu_cost": [float(h_cpu[0]), float(h_cpu[-1])],
              "ate_rmse": {k: v["ate_rmse"] for k, v in ate.items()},
              "card_vs_cpu": gaps, "cpu_s": float(cpu["seconds"]),
              "cpu_threads": CPU_BA_THREADS,
              "bounds": {"final_cost_rel": BAL_COST_RTOL,
                         "cams": BAL_CAMS_TOL, "ate_rmse": BAL_ATE}}
    failures = []
    if not cost_rel <= BAL_COST_RTOL:
        failures.append(f"BA final cost card vs CPU {cost_rel}")
    if not gaps["cams_max_abs"] <= BAL_CAMS_TOL:
        failures.append(f"BA cameras card vs CPU {gaps}")
    if not ate_gap <= BAL_ATE:
        failures.append(f"BA ATE card vs CPU {ate_gap}")
    if not (float(h_card[-1]) < 0.05 * float(h_card[0])
            and ate["card"]["ate_rmse"] < 0.5 * ate["init"]["ate_rmse"]):
        failures.append(f"BA cost {h_card[0]} -> {h_card[-1]}, ATE {ate}")
    return fields, failures


def run_sfm(torch, port, ops, child):
    """Reconstruction on the card: part (b), BA at Dubrovnik-16's size,
    timed first, with nothing else on the host; then the CPU's run of the
    same BA starts (``child``, from ``start_cpu_ba``) and part (a), the
    demo's rig, runs on the card meanwhile; last, the card's BA against the
    CPU's. Returns (fields; ``failures`` lists what is out of bounds, the
    odometry row's gate among them; the eigh row's additions: launches and
    the 4x4 shapes)."""
    import tempfile

    with torch.inference_mode():
        bal, card, truth, init = run_sfm_bal(torch)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/cpu_ba.npz"
        child.stdin.write(path + "\n")
        child.stdin.flush()
        try:
            with torch.inference_mode():
                rig, calls, eigh_launches = run_sfm_rig(torch, port, ops)
                t0 = time.perf_counter()
                rig["eigh"] = eigh_errors(torch, ops, calls)
                quads = [a for a in calls if a.shape[-1] == 4]
                by_shape = eigh_by_shape(torch, ops.eigh, quads, reps=5)
                rig["seconds"]["eigh_checks"] = time.perf_counter() - t0
                del calls
            t0 = time.perf_counter()
            cpu = cpu_ba_result(torch, child, path)
            rig["seconds"]["waiting_for_the_cpu_ba"] = (time.perf_counter()
                                                        - t0)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    fields, failures = bal_vs_cpu(card, cpu, truth, init)
    bal.update(fields)
    if not rig["odometry_gate"]:
        failures.append("the odometry row's ATE after BA is not below half "
                        "its start's")
    if not rig["triangulation_vs_cpu"]["within"]:
        failures.append(f"triangulation card vs CPU "
                        f"{rig['triangulation_vs_cpu']}")
    return {"bal": bal, "rig": rig, "failures": failures}, {
        "launches": eigh_launches,
        "launches_4x4": len(quads), "by_shape": by_shape}


# ------------------------------------------------------------ match_train --

# The matching trainers and the FCOS head at the JAX package's demo sizes
# and each model's full width (scripts/train_matching_demo.py,
# train_loftr_demo.py; tests/test_extractors_extra.py's ContextDesc step;
# the flagship neck's 40 x 40 map for FCOS), f32, TF32 off, seeded weights.
MT_SP_BATCH, MT_SP_HW, MT_SP_HOMO = 32, 128, 6
MT_SG_BATCH, MT_SG_HW, MT_SG_KEYPOINTS = 8, 256, 512
MT_LOFTR_BATCH = 4                  # at LOFTR_HW, profile_forward.LOFTR_KW
MT_CD_BATCH, MT_CD_HW, MT_CD_KEYPOINTS = 8, 128, 128
MT_FCOS_SHAPE = (8, 40, 40, 256)    # stride 16 at 640²
# One step on the card against one on the CPU from the same weights and
# inputs, on the first MT_CPU_ITEMS of the step's batch (the widths are the
# model's; a smaller batch keeps the CPU's step within the run's budget):
# the loss within TRAIN_LOSS_RTOL, the global gradient norm (before the
# clip) within TRAIN_NORM_RTOL, every parameter within 2·lr (+1e-6 of |p|
# for the update's rounding) of the CPU's after the update (Adam's first
# update, lr·g/(|g| + eps), moves no entry by more than lr), and within
# MT_FIRM_LR·lr where the CPU's gradient is above MT_FIRM_G of the
# parameter's largest, above 1e-6 and above MT_FIRM_AGREE times the card's
# difference from it: there the two gradients share their sign, so Adam
# takes the same step on both. (A gradient that is 0 but for rounding,
# such as a bias before ContextDesc's context normalisation, is left out
# by the last condition.)
MT_CPU_ITEMS = {"superpoint": 8, "superglue": 2, "loftr": 1,
                "contextdesc": 8, "fcos": 8}
MT_FIRM_LR = 0.1
MT_FIRM_G = 0.1
MT_FIRM_AGREE = 10.0
MT_HA_CELLS = 96            # make_ha_labeler's default label budget
MT_HA_AGREE_MIN = 0.99      # HA labels, card vs CPU on the same draws
MT_TIE = 1e-5               # a near-tie: within this of the map's largest
MT_WARMUP, MT_REPS = 1, 3


def host_shapes(rng, b, hw):
    """Synthetic-shape images without cv2: 2-4 filled rectangles an image,
    each of one grey, later ones over earlier ones; its corners' pixels
    (the corners a later rectangle covers or shares included, as cv2's
    batch keeps hidden polygon vertices). Returns (images [b, hw, hw, 1]
    float32, corners [b, 16, 2], counts [b])."""
    import numpy as np

    images = np.zeros((b, hw, hw, 1), np.float32)
    corners = np.full((b, 16, 2), -1.0, np.float32)
    counts = np.zeros(b, np.int32)
    for i in range(b):
        img = np.full((hw, hw), rng.uniform(0.0, 0.3), np.float32)
        pts = []
        for _ in range(int(rng.integers(2, 5))):
            x0, y0 = rng.integers(8, hw // 2, 2)
            x1 = int(rng.integers(x0 + 8, hw - 8))
            y1 = int(rng.integers(y0 + 8, hw - 8))
            img[y0:y1 + 1, x0:x1 + 1] = rng.uniform(0.5, 1.0)
            pts += [(x0, y0), (x1, y0), (x0, y1), (x1, y1)]
        counts[i] = len(pts)
        corners[i, :len(pts)] = pts
        images[i, :, :, 0] = img
    return images, corners, counts


@contextlib.contextmanager
def pre_clip_norms():
    """The global gradient norms that ``training.optim.apply_update`` clips
    (before the clip), one tensor a step, while the context is open."""
    from oetr_tpu_torch.training import optim

    seen, clip = [], optim.clip_by_global_norm_

    def record(grads, max_norm):
        norm = clip(grads, max_norm)
        seen.append(norm)
        return norm

    optim.clip_by_global_norm_ = record
    try:
        yield seen
    finally:
        optim.clip_by_global_norm_ = clip


def mt_optimizer(torch, model, lr, steps, clip):
    """Adam at ``lr`` over ``model``; with ``steps`` the demos' schedule
    (x0.1 from 70% of ``steps``, optax's piecewise-constant) and their
    clip; returns (optimizer, scheduler or None, clip or None)."""
    from oetr_tpu_torch.training import (StepScheduler,
                                         piecewise_constant_schedule)

    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    if not steps:
        return opt, None, None
    sched = StepScheduler(opt, piecewise_constant_schedule(
        lr, {int(steps * 0.7): 0.1}))
    return opt, sched, clip


def to_cpu(torch, value, n):
    """``value`` (a tensor, a dict of them, or anything else) on the CPU,
    tensors cut to their first ``n`` items."""
    if isinstance(value, dict):
        return {k: to_cpu(torch, v, n) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value[:n].cpu() if value.dim() else value.cpu()
    return value


def to_device(torch, value, dev):
    """``value`` (a tensor, a dict of them, or anything else) on ``dev``."""
    if isinstance(value, dict):
        return {k: to_device(torch, v, dev) for k, v in value.items()}
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    return value


def card_vs_cpu(torch, name, build, make_step, model, args, lr, steps,
                clip, n):
    """One step on the card and one on the CPU from ``model``'s weights on
    the first ``n`` items of ``args``: the bounds of MT_CPU_ITEMS'
    comment. The card's model is left as it was."""
    from oetr_tpu_torch.training import global_grad_norm

    t0 = time.perf_counter()
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    results = {}
    for dev in (DEV, "cpu"):
        net = build(dev)
        net.load_state_dict({k: v.to(dev) for k, v in start.items()})
        opt, sched, cl = mt_optimizer(torch, net, lr, steps, clip)
        step = make_step(net, opt, sched, cl)
        dev_args = [to_cpu(torch, a, n) for a in args]
        if dev != "cpu":
            dev_args = [to_device(torch, a, dev) for a in dev_args]
        with pre_clip_norms() as norms:
            metrics = step(*dev_args)
        norm = (norms[0] if norms else global_grad_norm(net)).item()
        results[dev] = ({k: v.item() for k, v in metrics.items()}, norm,
                        {k: p.detach().cpu()
                         for k, p in net.named_parameters()},
                        {k: p.grad.detach().cpu()
                         for k, p in net.named_parameters()})
        del net, opt, step
    (m_c, n_c, p_c, g_c), (m_h, n_h, p_h, g_h) = results[DEV], results["cpu"]
    loss_rel = abs(m_c["loss"] - m_h["loss"]) / max(abs(m_h["loss"]), 1e-12)
    norm_rel = abs(n_c - n_h) / max(n_h, 1e-12)
    worst_p = worst_firm = worst_g = over_p = 0.0
    for k in p_h:
        diff = (p_c[k] - p_h[k]).abs()
        worst_p = max(worst_p, diff.max().item())
        over_p = max(over_p, (diff - 1e-6 * p_h[k].abs()).max().item())
        g = g_h[k].abs()
        firm = ((g > max(MT_FIRM_G * g.max().item(), 1e-6))
                & (g > MT_FIRM_AGREE * (g_c[k] - g_h[k]).abs()))
        if firm.any():
            worst_firm = max(worst_firm, diff[firm].max().item())
        worst_g = max(worst_g, (g_c[k] - g_h[k]).abs().max().item()
                      / max(1.0, g.max().item()))
    fields = {"items": n, "loss_card": m_c["loss"], "loss_cpu": m_h["loss"],
              "loss_rel_diff": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
              "metrics_cpu": m_h, "grad_norm_card": n_c,
              "grad_norm_cpu": n_h, "grad_norm_rel_diff": norm_rel,
              "grad_norm_rtol": TRAIN_NORM_RTOL,
              "max_rel_grad_diff": worst_g,
              "params_max_abs_diff": worst_p,
              "params_tol": "2·lr + 1e-6·|p|", "lr": lr,
              "firm_params_max_abs_diff": worst_firm,
              "firm_params_tol": MT_FIRM_LR * lr,
              "seconds": time.perf_counter() - t0}
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL
            and over_p <= 2 * lr and worst_firm <= MT_FIRM_LR * lr
            and math.isfinite(m_c["loss"])):
        raise AssertionError(f"match_train {name}, card vs CPU: {fields}")
    return fields


def mt_row(torch, ops, name, model, build, make_step, args, lr, steps=0,
           clip=None, widths=None):
    """One trainer: (1) the main path, one step with the kernels' counts
    read around it (none of the port's kernels is on these paths), every
    parameter requiring grad and given a nonzero gradient; (2) card vs CPU
    (``card_vs_cpu``); (3) MT_REPS CUDA-event steps after MT_WARMUP and the
    peak memory; (4) one traced step: CUDA launches, device -> host copies
    (none allowed), busy ms, idle share."""
    t0 = time.perf_counter()
    opt, sched, cl = mt_optimizer(torch, model, lr, steps, clip)
    step = make_step(model, opt, sched, cl)
    if not all(p.requires_grad for p in model.parameters()):
        raise AssertionError(f"match_train {name}: a parameter without grad")
    reset_counts(ops)
    metrics = step(*args)
    torch.cuda.synchronize()
    launches = launch_counts(ops)
    dead = [k for k, p in model.named_parameters()
            if not p.grad.abs().max().item() > 0]
    losses = {k: v.item() for k, v in metrics.items()}
    if any(launches.values()) or dead or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"match_train {name}: kernel launches "
                             f"{launches}, parameters with a zero gradient "
                             f"{dead[:5]}, metrics {losses}")
    cmp = card_vs_cpu(torch, name, build, make_step, model, args, lr, steps,
                      clip, MT_CPU_ITEMS[name])
    seen = []
    call = lambda: seen.append(step(*args))
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, call, reps=MT_REPS, warmup=MT_WARMUP)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = traced_stats(torch, call, reps=1, warmup=0, cpu=False,
                         top_kernels=6)
    if stats["dtoh_copies_per_call"] != 0 or not all(
            all(math.isfinite(v.item()) for v in m.values()) for m in seen):
        raise AssertionError(f"match_train {name}: traced step {stats}, or "
                             "a timed step's loss not finite")
    return {"trainer": name, "widths": widths or {}, "lr": lr,
            "schedule_steps": steps, "clip": clip, "metrics_step1": losses,
            "kernel_launches": {k: n for k, n in launches.items() if n},
            "ms_per_step": ms, "steps_timed": MT_REPS,
            "peak_mem_gb": peak_gb,
            "launches_per_step": stats["launches_per_call"],
            "dtoh_copies_per_step": stats["dtoh_copies_per_call"],
            "device_busy_ms": stats["device_busy_ms"],
            "idle_share": stats["idle_share"],
            "traced_wall_ms": stats["wall_ms"],
            "busy_ms_by_category": stats["device_ms_by_category"],
            "top_kernels_ms": stats["top_kernels_ms"],
            "card_vs_cpu": cmp,
            "row_s": time.perf_counter() - t0}


def ha_vs_cpu(torch, tr, net, build, images, Hs, n):
    """The HA labels of the first ``n`` images on the card against the
    CPU's on the same draws ``Hs`` and weights: the share of equal cells,
    the differing cells that are near-ties in the CPU's own score map (its
    best two scores in the cell, or its maximum and the image's threshold,
    within MT_TIE of the map's largest) read apart."""
    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    im, H = images[:n], Hs[:, :n]
    card = tr.ha_labels(net, im, H, max_cells=MT_HA_CELLS).cpu()
    ref = tr.ha_labels(cpu, im.cpu(), H.cpu(), max_cells=MT_HA_CELLS)
    nmsed = tr.ha_scores(cpu, im.cpu(), H.cpu())
    b, hw = nmsed.shape[:2]
    hc = hw // 8
    cells = nmsed.reshape(b, hc, 8, hc, 8).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, hc, hc, 64).sort(dim=-1).values
    cmax = cells[..., -1]
    kth = cmax.reshape(b, -1).sort(dim=-1, descending=True).values[
        :, MT_HA_CELLS - 1]
    thr = torch.clamp(kth, min=1e-3)[:, None, None]   # ha_labels' floor
    scale = MT_TIE * nmsed.abs().max().item()
    tie = ((cells[..., -1] - cells[..., -2] <= scale)
           | ((cmax - thr).abs() <= scale))
    diff = card != ref
    agree = 1.0 - diff.float().mean().item()
    fields = {"images": n, "n_homo": Hs.shape[0], "cells": diff.numel(),
              "agree": agree, "agree_min": MT_HA_AGREE_MIN,
              "differing_near_ties": int((diff & tie).sum()),
              "differing_other": int((diff & ~tie).sum()),
              "labelled_cells_card": int((card != 64).sum()),
              "labelled_cells_cpu": int((ref != 64).sum())}
    if agree < MT_HA_AGREE_MIN:
        raise AssertionError(f"match_train HA labels card vs CPU: {fields}")
    return fields


def run_match_train(torch, port, ops):
    """The matching trainers and the FCOS head on the card (``mt_row``
    each), at the demos' sizes and full widths, f32, seeded weights:
    SuperPoint's joint step with homographic adaptation (its labeler also
    held to the CPU on the same draws), SuperGlue on the port's SuperPoint
    keypoints with GT from depth and pose, LoFTR with the fine loss,
    ContextDesc on host-drawn keypoints with the exact homography's GT, and
    FCOS through ``fcos_losses``. Yields one field dict a trainer."""
    import numpy as np

    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch import training as tr
    from oetr_tpu_torch.geometry.boxes import compute_locations
    from oetr_tpu_torch.models import fcos
    from oetr_tpu_torch.models.sift_based import build_contextdesc
    from oetr_tpu_torch.training.optim import apply_update

    gen = lambda seed: torch.Generator(device=DEV).manual_seed(seed)
    seeded = lambda seed: torch.Generator().manual_seed(seed)
    lum = torch.tensor([0.299, 0.587, 0.114], device=DEV)

    # SuperPoint: the joint step with HA labels (scripts/train_matching_
    # demo.py --teacher ha, past its warm-up: ha_w 1).
    t0 = time.perf_counter()
    build_sp = lambda dev: port.build_superpoint_net(device=dev,
                                                     generator=seeded(101))
    net = build_sp(DEV)
    rng = np.random.default_rng(102)
    shapes, corners, counts = host_shapes(rng, MT_SP_BATCH, MT_SP_HW)
    labels = tr.corners_to_cell_labels(corners, (MT_SP_HW,) * 2, counts)
    im0, im1, H = port.make_homography_pair_generator(
        MT_SP_HW, MT_SP_BATCH, scale_range=(0.55, 1.8), device=DEV)(gen(103))
    Hs = tr.draw_ha_homographies(gen(104), MT_SP_HOMO, MT_SP_BATCH, MT_SP_HW)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ha = tr.ha_labels(net, im0, Hs, max_cells=MT_HA_CELLS)
    torch.cuda.synchronize()
    label_ms = (time.perf_counter() - t1) * 1e3
    t2 = time.perf_counter()
    ha_check = ha_vs_cpu(torch, tr, net, build_sp, im0, Hs,
                         MT_CPU_ITEMS["superpoint"])
    ha_check["seconds"] = time.perf_counter() - t2
    args = (torch.from_numpy(shapes).to(DEV),
            torch.from_numpy(labels).to(DEV), im0, im1, H, ha,
            torch.tensor(1.0, device=DEV))
    make = lambda m, o, s, c: tr.make_superpoint_joint_ha_train_step(
        m, o, scheduler=s, clip_norm=c)
    row = mt_row(torch, ops, "superpoint", net, build_sp, make, args, 5e-4,
                 2000, 1.0, {"descriptor_dim": 256, "batch": MT_SP_BATCH,
                             "hw": MT_SP_HW, "n_homo": MT_SP_HOMO})
    row.update(ha_labeler={"ms_first_call": label_ms,
                           "labelled_cells_per_image":
                               (ha != 64).sum().item() / MT_SP_BATCH,
                           "card_vs_cpu": ha_check},
               data_s=t1 - t0)
    yield row
    del net, args, ha, im0, im1, H, Hs
    torch.cuda.empty_cache()

    # SuperGlue on the port's SuperPoint (512 keypoints, threshold 0),
    # GT by depth and pose with the occlusion check (the demo's sg_prep).
    t0 = time.perf_counter()
    raw = port.make_device_generator(MT_SG_HW, MT_SG_BATCH,
                                     scale_range=(1.0, 2.0), p_translate=0.5,
                                     device=DEV)(gen(110))
    sp = port.build_superpoint(device=DEV, generator=seeded(111),
                               max_keypoints=MT_SG_KEYPOINTS,
                               keypoint_threshold=0.0)
    with torch.no_grad():
        e0 = sp((raw["image1"] @ lum)[..., None])
        e1 = sp((raw["image2"] @ lum)[..., None])
        T = raw["pose2"] @ torch.linalg.inv_ex(raw["pose1"])[0]
        gt = tr.gt_matches_batch(e0["keypoints"], e0["valid"],
                                 e1["keypoints"], e1["valid"], raw["depth1"],
                                 raw["K1"], T, raw["K2"],
                                 depth1=raw["depth2"])
    batch = {"keypoints0": e0["keypoints"], "keypoints1": e1["keypoints"],
             "scores0": e0["scores"], "scores1": e1["scores"],
             "descriptors0": e0["descriptors"],
             "descriptors1": e1["descriptors"], "valid0": e0["valid"],
             "valid1": e1["valid"], "gt_matches0": gt,
             "image_hw0": (MT_SG_HW,) * 2, "image_hw1": (MT_SG_HW,) * 2}
    del sp, raw, e0, e1
    build_sg = lambda dev: port.build_superglue(device=dev,
                                                generator=seeded(112))
    model = build_sg(DEV)
    make = lambda m, o, s, c: tr.make_superglue_train_step(
        m, o, scheduler=s, clip_norm=c)
    data_s = time.perf_counter() - t0
    row = mt_row(torch, ops, "superglue", model, build_sg, make, (batch,),
                 1e-4, 1500, 1.0, {"descriptor_dim": 256, "gnn_layers": 9,
                                   "batch": MT_SG_BATCH, "hw": MT_SG_HW,
                                   "keypoints": MT_SG_KEYPOINTS,
                                   "sinkhorn": "plain, 30 iterations"})
    row.update(gt_per_pair=(gt >= 0).sum(-1).tolist(), data_s=data_s)
    yield row
    del model, batch
    torch.cuda.empty_cache()

    # LoFTR (the loftr phase's model) with the fine loss, GT by depth and
    # pose from the cell centres (train_loftr_demo.py's prep).
    t0 = time.perf_counter()
    raw = port.make_device_generator(LOFTR_HW, MT_LOFTR_BATCH,
                                     scale_range=(1.0, 2.0), p_translate=0.5,
                                     device=DEV)(gen(120))
    hc = LOFTR_HW // 8
    u = torch.arange(hc, dtype=torch.float32, device=DEV) * 8 + 3.5
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    ctr = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).expand(
        MT_LOFTR_BATCH, -1, -1).contiguous()
    ones = torch.ones(ctr.shape[:2], dtype=torch.bool, device=DEV)
    T = raw["pose2"] @ torch.linalg.inv_ex(raw["pose1"])[0]
    with torch.no_grad():
        lgt = tr.gt_matches_batch(ctr, ones, ctr, ones, raw["depth1"],
                                  raw["K1"], T, raw["K2"],
                                  depth1=raw["depth2"], radius=6.0)
        gt_xy1, gt_ok1 = tr.warp_cell_centers_batch(
            ctr, raw["depth1"], raw["K1"], T, raw["K2"],
            depth1=raw["depth2"])
    args = ((raw["image1"] @ lum)[..., None], (raw["image2"] @ lum)[..., None],
            lgt, gt_xy1, gt_ok1)
    del raw
    def build_lt(dev):
        # Seeded, no proposal passes 0.2, and the fine loss would then
        # supervise nothing: threshold 0, as the api phase's identity check.
        m = pf.loftr_model(dev)
        m.match_threshold = 0.0
        return m

    model = build_lt(DEV)
    make = lambda m, o, s, c: tr.make_loftr_train_step(
        m, o, fine_weight=1.0, scheduler=s, clip_norm=c)
    data_s = time.perf_counter() - t0
    row = mt_row(torch, ops, "loftr", model, build_lt, make, args, 2e-4,
                 6000, 1.0, dict(pf.LOFTR_KW, match_threshold=0.0,
                                 batch=MT_LOFTR_BATCH, hw=LOFTR_HW,
                                 fine_weight=1.0))
    row.update(gt_per_pair=(lgt >= 0).sum(-1).tolist(), data_s=data_s)
    yield row
    del model, args
    torch.cuda.empty_cache()

    # ContextDesc: keypoints, scores and RootSIFT-like descriptors drawn on
    # the host (no cv2 for SIFT here) on homography pairs from the device
    # generator, GT from the exact H (contextdesc_pairs_batch's rule).
    t0 = time.perf_counter()
    b, k, hw = MT_CD_BATCH, MT_CD_KEYPOINTS, MT_CD_HW
    g0, g1, Hc = port.make_homography_pair_generator(
        hw, b, scale_range=(0.7, 1.4), device=DEV)(gen(130))
    Hn = Hc.double().cpu().numpy()
    rng = np.random.default_rng(131)
    cd = {key: [] for key in ("desc0", "desc1", "xy0", "xy1", "scores0",
                              "scores1", "valid0", "valid1", "gt_matches0")}
    for i in range(b):
        xy0 = rng.uniform(4, hw - 4, (k, 2)).astype(np.float32)
        p = np.concatenate([xy0, np.ones((k, 1), np.float32)], -1) @ Hn[i].T
        xy1 = (p[:, :2] / p[:, 2:]).astype(np.float32)
        keep = ((xy1 >= 0) & (xy1 <= hw - 1)).all(-1) & (rng.random(k) < 0.7)
        xy1 = np.where(keep[:, None], xy1 + rng.normal(0, 0.5, (k, 2)),
                       rng.uniform(4, hw - 4, (k, 2))).astype(np.float32)
        perm = rng.permutation(k)
        d0 = rng.random((k, 128)) ** 4
        d1 = np.where(keep[:, None], d0 * rng.uniform(0.8, 1.2, (k, 128)),
                      rng.random((k, 128)) ** 4)
        root = lambda d: np.sqrt(d / d.sum(-1, keepdims=True)).astype(
            np.float32)
        valid = np.arange(k) < k - 8           # SIFT's padded slots
        v0, v1 = valid, valid[perm]
        x1, dd1 = xy1[perm], root(d1)[perm]
        cd["desc0"].append(root(d0) * v0[:, None])
        cd["desc1"].append(dd1 * v1[:, None])
        cd["xy0"].append(xy0 * v0[:, None])
        cd["xy1"].append(x1 * v1[:, None])
        cd["scores0"].append(rng.uniform(0.01, 0.1, k).astype(np.float32)
                             * v0)
        cd["scores1"].append(rng.uniform(0.01, 0.1, k).astype(np.float32)
                             * v1)
        cd["valid0"].append(v0)
        cd["valid1"].append(v1)
        cd["gt_matches0"].append(tr.homography_gt_matches(
            xy0 * v0[:, None], v0, x1 * v1[:, None], v1, Hn[i]))
    batch = {key: torch.from_numpy(np.stack(v)).to(DEV)
             for key, v in cd.items()}
    batch.update(image0=g0, image1=g1)
    build_cd = lambda dev: build_contextdesc(device=dev,
                                             generator=seeded(132))
    model = build_cd(DEV)
    make = lambda m, o, s, c: tr.make_contextdesc_train_step(
        m, o, scheduler=s, clip_norm=c)
    data_s = time.perf_counter() - t0
    row = mt_row(torch, ops, "contextdesc", model, build_cd, make, (batch,),
                 1e-3, 0, None, {"out_dim": 128, "regional_dim": 64,
                                 "hidden": 128, "batch": b, "hw": hw,
                                 "keypoints": k})
    row.update(gt_per_pair=(batch["gt_matches0"] >= 0).sum(-1).tolist(),
               data_s=data_s)
    yield row
    del model, batch
    torch.cuda.empty_cache()

    # FCOS: the head on the flagship neck's map, forward and backward
    # through fcos_losses, one box an image.
    bsz, h, w, c = MT_FCOS_SHAPE
    x = torch.randn(MT_FCOS_SHAPE, generator=gen(140), device=DEV)
    side = w * 16.0                      # 640 px
    lo = torch.rand((bsz, 2), generator=gen(141), device=DEV) * side / 2
    size = side * (0.1 + 0.4 * torch.rand((bsz, 2), generator=gen(142),
                                          device=DEV))
    boxes = torch.cat([lo, torch.clamp(lo + size, max=side)], dim=-1)
    build_fc = lambda dev: fcos.build_fcos_head(device=dev, in_channels=c,
                                                generator=seeded(143))
    model = build_fc(DEV)

    def make(m, o, s, cl):
        def step(feat, targets):
            o.zero_grad(set_to_none=True)
            cls, reg, cent = m(feat)
            locs = compute_locations(h, w, 16, device=feat.device)
            losses = fcos.fcos_losses(locs, cls, reg, cent, targets)
            loss = (losses["cls_loss"] + losses["reg_loss"]
                    + losses["centerness_loss"])
            loss.backward()
            apply_update(m.parameters(), o, s, cl)
            return {"loss": loss.detach(),
                    **{k: v.detach() for k, v in losses.items()}}
        return step

    row = mt_row(torch, ops, "fcos", model, build_fc, make, (x, boxes), 1e-4,
                 0, None, {"in_channels": c, "shape": list(MT_FCOS_SHAPE),
                           "stride": 16})
    yield row
    del model, x
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- demos --

# The demos phase: the programs of oetr_tpu_torch.scripts at their JAX
# defaults' widths, through their phase functions, on the on-device
# generators' pairs. Each trainer: one checked step (its K2/K3 launches
# read around it), DEMO_TIMED_STEPS CUDA-event steps, peak memory, one
# traced step (no device -> host copy). Each program's evaluate function
# on DEMO_EVAL_PAIRS generator pairs.
DEMO_TIMED_STEPS = 2
DEMO_EVAL_PAIRS = 8


def demo_timing(torch, call):
    """ms a step (median of DEMO_TIMED_STEPS CUDA-event calls), peak
    memory over them, and one traced call: launches, device -> host copies
    (none allowed), busy ms and idle share."""
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(torch, call, reps=DEMO_TIMED_STEPS, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    stats = traced_stats(torch, call, reps=1, warmup=0, cpu=False)
    if stats["dtoh_copies_per_call"] != 0:
        raise AssertionError(f"demos: device -> host copies in a step "
                             f"{stats}")
    return {"ms_per_step": ms, "steps_timed": DEMO_TIMED_STEPS,
            "peak_mem_gb": peak,
            "launches_per_step": stats["launches_per_call"],
            "dtoh_copies_per_step": stats["dtoh_copies_per_call"],
            "device_busy_ms": stats["device_busy_ms"],
            "idle_share": stats["idle_share"],
            "traced_wall_ms": stats["wall_ms"]}


def finite_metrics(metrics) -> dict:
    """The step's metrics as numbers; raises where one is not finite."""
    if not finite(metrics):
        raise AssertionError(f"demos: a metric not finite: {metrics}")
    return {k: v.item() for k, v in metrics.items()}


def demo_state_round_trip(torch, md, common, args, sg, opt, sched, step):
    """The matching demo's SuperGlue segment state written in JAX's orbax
    layout (``common.saver``) and read (``common.restore``) into a fresh
    SuperGlue and optimizer: (the fresh SuperGlue, fields). Raises unless
    the parameters, Adam's moments and steps, the schedule and the step
    come back bit-equal."""
    import os
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "superglue_state")
        t0 = time.perf_counter()
        common.saver(path, sg, opt, sched)(step)
        write_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                     if f.is_file())
        back = md.build_sg(args, DEV, torch.Generator().manual_seed(12))
        opt2, sched2 = common.adam(back, args.sg_lr, args.sg_steps)
        t0 = time.perf_counter()
        got = common.restore(path, back, opt2, sched2)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    mine = dict(sg.named_parameters())
    same = got == step and sched2.count == sched.count
    for name, p in back.named_parameters():
        a, b = opt2.state[p], opt.state[mine[name]]
        same &= torch.equal(p, mine[name]) and all(
            torch.equal(a[k], b[k]) for k in ("step", "exp_avg",
                                               "exp_avg_sq"))
    if not same:
        raise AssertionError("demos: SuperGlue's segment state read back "
                             "differs from the state written")
    return back, {"layout": "JAX's orbax (EmptyState, (ScaleByAdamState, "
                  "ScaleByScheduleState))", "bytes": nbytes,
                  "write_s": write_s, "read_s": read_s, "step": got,
                  "bit_equal": same}


def run_demos(torch, port, ops, launches):
    """The demo programs (``python -m oetr_tpu_torch.scripts.*``) on the
    card, f32, seeded weights, through their own phase functions on the
    device generators' pairs: (1) ``train_demo``'s OETR (ResNet18 to
    layer3, d 64, 8 heads, 2 + 2 layers) with the fused stem (K3) and
    ``'linear:cuda'`` (K2), 16 pairs of 160² a step, its recall table
    before and after on 8 pairs; (2) ``train_matching_demo --device_data``
    (teacher ``corner``): SuperPoint (32 x 128², D 128), then SuperGlue on
    its keypoints (8 pairs x 512 at 256², the batch made on the card), then
    its ``evaluate`` on 8 pairs with ``cuda_sinkhorn`` (K4 on [8, 513,
    513]): the SP + NN and SP + SG rows, repeatability, the assignment
    quality and the gate (the SIFT rows need cv2, which this machine
    lacks); (3) ``train_loftr_demo``: LoFTR (192/96, 4 layers, fine loss),
    4 pairs of 256², its ``loftr`` row on 8 pairs. Every K2, K3 and K4 call
    of the phase is held to its plain version on the same inputs
    (``recorded_kernel_errors``); the checked step of (1) launches K2 8
    and K3 1 times. Yields one field dict a program; adds the phase's
    wrapper launches to ``launches``."""
    import copy
    import itertools

    import numpy as np

    from oetr_tpu_torch.scripts import common
    from oetr_tpu_torch.scripts import train_demo as td
    from oetr_tpu_torch.scripts import train_loftr_demo as ld
    from oetr_tpu_torch.scripts import train_matching_demo as md
    from oetr_tpu_torch.training import create_train_state

    gen = lambda seed: torch.Generator(device=DEV).manual_seed(seed)
    seeded = lambda seed: torch.Generator().manual_seed(seed)
    scenes = lambda hw, seed, **kw: port.make_device_generator(
        hw, DEMO_EVAL_PAIRS, device=DEV, **kw)(gen(seed))
    reset_counts(ops)
    with recorded_kernel_calls(sinkhorn=True) as calls:
        # (1) train_demo, its pairs pure translations (generate_scene's
        # default).
        t0 = time.perf_counter()
        args = td.parse_args(["--device", DEV])
        cfg = td.model_config(fused_stem=True, attention="linear:cuda")
        _, state = create_train_state(cfg, td.train_config(args), seeded(0),
                                      device=DEV)
        synth = port.make_device_generator(args.hw, args.batch,
                                           scale_range=(1.0, 1.0),
                                           p_translate=1.0, device=DEV)
        data, drop = gen(200), gen(1)
        stream = iter(lambda: synth(data), None)
        val = {k: v.cpu().numpy() for k, v in scenes(
            args.hw, 201, scale_range=(1.0, 1.0), p_translate=1.0).items()}
        r_init = td.evaluate(state.model, [val])
        losses = []
        one = lambda: losses.extend(td.train_oetr(state, stream, 1, drop))
        before = launch_counts(ops)
        one()
        torch.cuda.synchronize()
        step_launches = {k: n - before[k] for k, n in
                         launch_counts(ops).items() if n - before[k]}
        want = {"linear_encoder_attention": 4 * cfg.neck.num_layers,
                "groupnorm_relu_maxpool": 1}
        if step_launches != want:
            raise AssertionError(f"demos train_demo: launches a step "
                                 f"{step_launches} != {want}")
        timing = demo_timing(torch, one)
        r_final = td.evaluate(state.model, [val])
        done = copy.copy(args)
        done.steps = len(losses)
        summary = td.summary(done, losses, r_init, r_final, t0)
        summary.pop("wall_s")
        yield {"program": "train_demo", "widths": {
            "depth": 18, "d_model": 64, "nhead": 8, "layers": "2 + 2",
            "batch": args.batch, "hw": args.hw, "eval_pairs":
                DEMO_EVAL_PAIRS}, "switches": "fused_stem, linear:cuda",
            "launches_checked_step": step_launches, **timing,
            "json": summary, "program_s": time.perf_counter() - t0}
        del state, synth, stream

        # (2) train_matching_demo --device_data: SuperPoint, SuperGlue,
        # then its evaluate with K4 on.
        t0 = time.perf_counter()
        args = md.parse_args(["--device_data", "--device", DEV])
        net = port.build_superpoint_net(device=DEV, generator=seeded(10),
                                        descriptor_dim=args.desc_dim)
        opt, sched = common.adam(net, md.SP_LR, args.sp_steps)
        pairs = md.device_pair_batch(args.sp_hw, args.sp_batch, DEV)
        rng, count, sp_metrics = np.random.default_rng(0), \
            itertools.count(), []

        def sp_step():
            it = next(count)
            sp_metrics.append(md.train_superpoint(net, opt, sched, args, rng,
                                                  pairs, it, it + 1))

        sp_step()
        sp_timing = demo_timing(torch, sp_step)
        sp = md.extractor(net, args)
        sg = md.build_sg(args, DEV, seeded(11)).train()
        opt, sched = common.adam(sg, args.sg_lr, args.sg_steps)
        batches = md.device_sg_batches(sp, args, DEV)
        count, sg_metrics = itertools.count(), []

        def sg_step():
            it = next(count)
            sg_metrics.append(md.train_superglue(sg, opt, sched, batches,
                                                 it + 1, it))

        sg_step()
        sg_timing = demo_timing(torch, sg_step)
        # Its segment state in JAX's layout, read back into a fresh
        # SuperGlue and optimizer: what the evaluate below runs.
        sg, sg_state = demo_state_round_trip(torch, md, common, args, sg,
                                             opt, sched, len(sg_metrics))
        sg.eval()
        sg.cuda_sinkhorn = True
        k4_before = ops.log_sinkhorn_cuda.launches
        t1 = time.perf_counter()
        fields = md.evaluate(sp, sg, common.items_of(scenes(
            args.hw, 210, scale_range=(1.0, 2.0), p_translate=0.5)),
            args, DEV, sift=False)
        eval_s = time.perf_counter() - t1
        if ops.log_sinkhorn_cuda.launches == k4_before:
            raise AssertionError("demos: SuperGlue's evaluate launched no K4")
        yield {"program": "train_matching_demo", "flags": "--device_data "
               "--teacher corner", "widths": {
                   "sp_batch": args.sp_batch, "sp_hw": args.sp_hw,
                   "desc_dim": args.desc_dim, "sg_batch": args.sg_batch,
                   "topk": args.topk, "hw": args.hw,
                   "eval_pairs": DEMO_EVAL_PAIRS},
               "superpoint": {"metrics_step1": finite_metrics(
                   sp_metrics[0]), **sp_timing},
               "superglue": {"metrics_step1": finite_metrics(
                   sg_metrics[0]), **sg_timing,
                   "segment_state": sg_state},
               "json": {**fields, "sift_nn": "not run: needs cv2",
                        "repeatability@3px": dict(
                            fields["repeatability@3px"],
                            sift="not run: needs cv2")},
               "eval_s": eval_s, "program_s": time.perf_counter() - t0}
        del net, sp, sg, opt, batches

        # (3) train_loftr_demo.
        t0 = time.perf_counter()
        args = ld.parse_args(["--device", DEV])
        model = ld.build_model(args, DEV, seeded(20))
        opt, sched = common.adam(model, args.lr, args.steps)
        raw_of = ld.device_batches(args, DEV)
        count, lt_metrics = itertools.count(), []

        def loftr_step():
            it = next(count)
            lt_metrics.append(ld.train_loftr(model, opt, sched, args, raw_of,
                                             it, it + 1))

        loftr_step()
        lt_timing = demo_timing(torch, loftr_step)
        t1 = time.perf_counter()
        rows = ld.evaluate(model, common.items_of(scenes(
            args.hw, 220, scale_range=(1.0, 2.0), p_translate=0.5)), DEV,
            sift=False)
        eval_s = time.perf_counter() - t1
        phase_launches = {k: n for k, n in launch_counts(ops).items() if n}
        launches.update(phase_launches)
        with torch.no_grad():
            checks = recorded_kernel_errors(torch, ops, calls, "demos")
    if set(checks) != {"linear_encoder_attention", "groupnorm_relu_maxpool",
                       "log_optimal_transport"}:
        raise AssertionError(f"demos: kernel calls checked {checks}")
    yield {"program": "train_loftr_demo", "widths": {
               "batch": args.batch, "hw": args.hw, "d_coarse": args.d_coarse,
               "d_fine": 96, "layers": args.layers,
               "fine_weight": args.fine_weight,
               "eval_pairs": DEMO_EVAL_PAIRS},
           "metrics_step1": finite_metrics(lt_metrics[0]), **lt_timing,
           "json": {**rows, "sift_nn": "not run: needs cv2"},
           "eval_s": eval_s, "program_s": time.perf_counter() - t0,
           "phase_launches": phase_launches,
           "kernels_vs_plain": checks}


# -------------------------------------------------------------- variants --

# The OETR variants at the flagship's widths (ResNet50 to layer3, d 256, 8
# heads, 4 x (self + cross), 2 decoder layers, 640², 'linear:cuda'): the
# frozen BatchNorm backbone loaded from a reference-layout checkpoint file,
# the space-to-depth stem with GroupNorm and the fused stem, the LayerNorm
# backbone. f32 card against the CPU (BN, one pair, TF32 off): tlbr within
# VARIANT_TLBR_TOL, the heat map's probabilities within VARIANT_PROB_RTOL of
# the CPU's largest; the two sum convolutions in other orders, which the
# CPU's own spread under a one-ulp nudge of the input shows beside them
# (H100, 700 W: card 1.8e-7..3.6e-7 and 3.7e-6..4.1e-6, the CPU's own
# spread 1.8e-7..3.6e-7 and 2.8e-6..3.6e-6; the bounds ~25x those).
# The s2d backbone against the 7x7 one with the kernel mapped (f32, 2
# pairs): VARIANT_S2D_RTOL of max(1, the features' largest |entry|); only
# the stem's convolution differs, in summation order.
VARIANT_TLBR_TOL = 1e-5
VARIANT_PROB_RTOL = 1e-4
VARIANT_S2D_RTOL = 1e-4
VARIANT_REPS, VARIANT_WARMUP = 3, 1
VARIANT_TRACE_NAMES = ("linear_encoder_kernel", "gn_apply_pool_kernel")


def variant_config(port, dtype_name, **backbone):
    """The flagship with K2 and the fused-stem switch on (K3 is taken with
    norm 'gn' only, JAX's rule) and the backbone fields ``backbone``."""
    base = port.oetr_r50_kernels_config(dtype_name)
    return port.replace(base, backbone=port.replace(base.backbone,
                                                    **backbone))


def switches_off(port, cfg):
    return port.replace(cfg, backbone=port.replace(cfg.backbone,
                                                   fused_stem=False),
                        neck=port.replace(cfg.neck, attention="linear"))


def reference_checkpoint(torch, port, cfg, path, seed):
    """Write a reference-layout checkpoint of ``OETR(cfg)`` (norm 'bn')
    from ``seed`` as the reference's trainer writes one: torch key names
    under a ``state_dict`` wrapper with DataParallel's ``module.`` prefix,
    with the keys no converter reads (the ``backbone.layer0..3`` aliases,
    the classifier, ``num_batches_tracked``, the decoder layers' unused
    projections) and running variances in [0.5, 1.5]. Returns the port's
    state it holds and (keys read, keys skipped)."""
    from oetr_tpu_torch.interop import reference_state_dict
    from oetr_tpu_torch.models.resnet import FrozenBatchNorm

    g = torch.Generator().manual_seed(seed)
    model = port.build_oetr(cfg, device="cpu", generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.mean.copy_(0.1 * torch.randn(c, generator=g))
                m.var.copy_(0.5 + torch.rand(c, generator=g))
    state = model.state_dict()
    sd = reference_state_dict(state, cfg)
    extra = {}
    for key, val in sd.items():
        alias = re.match(r"backbone\.encoder\.(layer\d)\.(.*)", key)
        if alias:
            extra[f"backbone.{alias[1]}.{alias[2]}"] = val
        stem = re.match(r"backbone\.encoder\.(conv1|bn1)\.(.*)", key)
        if stem:
            extra[f"backbone.layer0.{int(stem[1] == 'bn1')}.{stem[2]}"] = val
        if key.endswith(".running_var"):
            extra[key.removesuffix("running_var") + "num_batches_tracked"] = (
                torch.tensor(0))
    extra["backbone.encoder.fc.weight"] = torch.randn(1000, 2048,
                                                      generator=g) / 45.0
    extra["backbone.encoder.fc.bias"] = torch.zeros(1000)
    d = cfg.d_model
    for j in range(cfg.neck.num_decoder_layers):
        for proj in ("q_proj", "k_proj", "v_proj", "merge"):
            extra[f"transformer.decoder.layers.{j}.{proj}.weight"] = (
                torch.randn(d, d, generator=g) / d ** 0.5)
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in {**sd, **extra}.items()},
                "epoch": 0}, path)
    return state, (len(sd), len(extra))


def variant_forward(torch, port, ops, cfg_on, state, want, tag,
                    traced=False):
    """The main path of one variant: ``OETR(cfg_on)`` with ``state`` on
    BATCH_PAIRS pairs of 640², its launch counts read around the forward,
    every K2 and K3 call of that forward held to its plain version on the
    same inputs, the outputs checked and the boxes against the switches-off
    model (same state) within BOX_TOL_PX; then pairs/s (median of
    VARIANT_REPS CUDA-event forwards after VARIANT_WARMUP) and, with
    ``traced``, one traced forward. Returns the fields and the launches."""
    dtype_name = cfg_on.dtype
    model = port.build_oetr(cfg_on, device=DEV)
    model.load_state_dict(state)
    plain = port.build_oetr(switches_off(port, cfg_on), device=DEV)
    plain.load_state_dict(state)
    b, hw = BATCH_PAIRS, IMAGE_HW
    g = torch.Generator(device=DEV).manual_seed(2)
    im1, im2 = torch.rand(2, b, hw, hw, 3, generator=g, device=DEV)
    want = {name: want.get(name, 0) for name in KERNELS}
    with torch.inference_mode():
        reset_counts(ops)
        with recorded_kernel_calls() as calls:
            out = model(im1, im2)
            torch.cuda.synchronize()
        launches = launch_counts(ops)
        if launches != want:
            raise AssertionError(f"{tag} kernel launches {launches} != "
                                 f"{want}")
        errs = recorded_kernel_errors(torch, ops, calls, path=tag)
        if {k: v["calls"] for k, v in errs.items()} != {
                k: n for k, n in want.items() if n}:
            raise AssertionError(f"{tag}: recorded kernel calls {errs}")
        del calls
        ref = plain(im1, im2)
        check_outputs(torch, cfg_on, out, b, hw, f"{tag} kernels")
        check_outputs(torch, cfg_on, ref, b, hw, f"{tag} plain")
        px = box_diff_px(port, out, ref, hw)
        if not px <= BOX_TOL_PX[dtype_name]:
            raise AssertionError(f"{tag}: boxes on vs off {px} px > "
                                 f"{BOX_TOL_PX[dtype_name]}")
        call = lambda: model(im1, im2)
        ms = time_ms(torch, call, reps=VARIANT_REPS, warmup=VARIANT_WARMUP)
        fields = {"path": tag, "dtype": dtype_name, "pairs": b,
                  "image_hw": hw, "norm": cfg_on.backbone.norm,
                  "stem_s2d": cfg_on.backbone.stem_s2d,
                  "launches": {k: n for k, n in launches.items() if n},
                  "path_kernels_vs_plain": errs,
                  "box_max_diff_px": px,
                  "box_tol_px": BOX_TOL_PX[dtype_name],
                  "ms_per_call": ms, "pairs_per_s": b / ms * 1e3}
        if traced:
            stats = traced_stats(torch, call, reps=1, warmup=0,
                                 names=VARIANT_TRACE_NAMES)
            got = [stats[f"{n}_per_call"] for n in VARIANT_TRACE_NAMES]
            if got != [2 * want["linear_encoder_attention"],
                       want["groupnorm_relu_maxpool"]]:
                raise AssertionError(f"{tag}: traced K2, K3 launches {got}")
            fields["traced"] = stats
    del model, plain
    return fields, launches


def bn_card_vs_cpu(torch, port, cfg, state):
    """f32 (TF32 off), one pair: the card (K2 on) against the port on the
    CPU (plain versions), and the CPU against itself with the images
    nudged up by one ulp. Returns the fields; raises beyond the bounds."""
    cfg32 = port.replace(cfg, dtype="float32")
    card = port.build_oetr(cfg32, device=DEV)
    card.load_state_dict(state)
    cpu = port.build_oetr(cfg32, device="cpu")
    cpu.load_state_dict(state)
    g = torch.Generator().manual_seed(5)
    im1, im2 = torch.rand(2, 1, IMAGE_HW, IMAGE_HW, 3, generator=g)
    ones = torch.ones_like(im1)
    with torch.inference_mode():
        a = card(im1.to(DEV), im2.to(DEV))
        r = cpu(im1, im2)
        nudged = cpu(torch.nextafter(im1, ones), torch.nextafter(im2, ones))
    del card, cpu

    def gap(x, y, key):
        d = (x[key].float().cpu() - y[key].float()).abs().max().item()
        return d / y[key].abs().max().item() if key.startswith("prob") \
            else d

    keys = ("tlbr1", "tlbr2", "prob_map1", "prob_map2")
    fields = {"pairs": 1, "dtype": "float32",
              "card_vs_cpu": {k: gap(a, r, k) for k in keys},
              "cpu_one_ulp_spread": {k: gap(nudged, r, k) for k in keys},
              "tlbr_tol": VARIANT_TLBR_TOL, "prob_rtol": VARIANT_PROB_RTOL,
              "prob_max": r["prob_map1"].max().item()}
    for k, v in fields["card_vs_cpu"].items():
        if not v <= (VARIANT_PROB_RTOL if k.startswith("prob")
                     else VARIANT_TLBR_TOL):
            raise AssertionError(f"variants bn card vs CPU: {fields}")
    return fields


def s2d_features(torch, port):
    """The s2d + GN + fused-stem backbone against the 7x7 one with the
    same weights (the stem's kernel mapped by ``space_to_depth_kernel``),
    f32, 2 pairs. Returns the fields and the s2d model's state."""
    from oetr_tpu_torch.models.resnet import space_to_depth_kernel

    m7 = port.build_oetr(variant_config(port, "float32"), device=DEV,
                         generator=torch.Generator().manual_seed(0))
    state = dict(m7.state_dict())
    state["backbone.Conv_0.weight"] = space_to_depth_kernel(
        state["backbone.Conv_0.weight"])
    ms2d = port.build_oetr(variant_config(port, "float32", stem_s2d=True),
                           device=DEV)
    ms2d.load_state_dict(state)
    g = torch.Generator(device=DEV).manual_seed(6)
    images = torch.rand(4, IMAGE_HW, IMAGE_HW, 3, generator=g, device=DEV)
    with torch.inference_mode():
        ref = m7.backbone(images)
        got = ms2d.backbone(images)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    fields = {"pairs": 2, "dtype": "float32", "features": list(ref.shape),
              "max_abs_diff": err, "ref_max": scale,
              "tol": VARIANT_S2D_RTOL * max(1.0, scale)}
    if not err <= fields["tol"]:
        raise AssertionError(f"variants s2d against 7x7: {fields}")
    return fields, state


def run_variants(torch, port, ops, k2_bf16, launches):
    """The OETR variants at full flagship width (see VARIANT_*): (a) the
    frozen BatchNorm backbone loaded from a reference-layout checkpoint
    file through ``load_reference_checkpoint`` (the tensors equal to the
    state written), bf16 on 8 pairs (K2 16 calls, K3 0), beside the GN
    flagship traced in the same run; its f32 card against the CPU; (b) the
    s2d stem with GroupNorm and the fused stem: the backbone against the
    7x7 one, then bf16 on 8 pairs (K2 16, K3 1, K3 on the 4x4 conv's
    output); (c) the LayerNorm backbone, bf16, 8 pairs (K2 16, K3 0); then
    ``device_memory_stats`` and K2's ``speed_of_light`` against
    ``bound()``. cuDNN's defaults (not deterministic), as in ``slice``.
    Yields one field dict a line; adds the three main paths' launches to
    the Counter ``launches``."""
    import os
    import tempfile

    from oetr_tpu_torch.interop import load_reference_checkpoint
    from oetr_tpu_torch.utils.profiling import (PEAK_OPS_PER_S,
                                                device_memory_stats,
                                                speed_of_light)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        cfg_bn = variant_config(port, "bfloat16", norm="bn")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "oetr_reference.ckpt")
            t = time.perf_counter()
            state, (n_read, n_skipped) = reference_checkpoint(
                torch, port, cfg_bn, path, seed=31)
            write_s = time.perf_counter() - t
            t = time.perf_counter()
            loaded = load_reference_checkpoint(path, cfg_bn)
            load_s = time.perf_counter() - t
            size = os.path.getsize(path)
        if set(loaded) != set(state) or not all(
                torch.equal(loaded[k], state[k]) for k in state):
            raise AssertionError("variants: the loaded checkpoint differs "
                                 "from the state written")
        fields, path_launches = variant_forward(
            torch, port, ops, cfg_bn, loaded,
            {"linear_encoder_attention": 16}, "bn_checkpoint", traced=True)
        launches.update(path_launches)
        gn_cfg = variant_config(port, "bfloat16")
        gn = port.build_oetr(gn_cfg, device=DEV,
                             generator=torch.Generator().manual_seed(0))
        g = torch.Generator(device=DEV).manual_seed(2)
        im1, im2 = torch.rand(2, BATCH_PAIRS, IMAGE_HW, IMAGE_HW, 3,
                              generator=g, device=DEV)
        with torch.inference_mode():
            call = lambda: gn(im1, im2)
            gn_ms = time_ms(torch, call, reps=VARIANT_REPS,
                            warmup=VARIANT_WARMUP)
            gn_traced = traced_stats(torch, call, reps=1, warmup=0,
                                     names=VARIANT_TRACE_NAMES)
        del gn
        fields.update(
            checkpoint={"bytes": size, "keys_read": n_read,
                        "keys_skipped": n_skipped, "write_s": write_s,
                        "load_s": load_s},
            gn_flagship_same_run={"ms_per_call": gn_ms,
                                  "pairs_per_s": BATCH_PAIRS / gn_ms * 1e3,
                                  "traced": gn_traced},
            f32_card_vs_cpu=bn_card_vs_cpu(torch, port, cfg_bn, loaded))
        yield fields
        del loaded, state
        torch.cuda.empty_cache()

        s2d_check, s2d_state = s2d_features(torch, port)
        fields, path_launches = variant_forward(
            torch, port, ops, variant_config(port, "bfloat16", stem_s2d=True),
            s2d_state, {"linear_encoder_attention": 16,
                        "groupnorm_relu_maxpool": 1}, "s2d_gn_fused")
        launches.update(path_launches)
        fields["s2d_vs_7x7_backbone"] = s2d_check
        yield fields

        cfg_ln = variant_config(port, "bfloat16", norm="ln")
        ln_state = port.build_oetr(
            cfg_ln, device="cpu",
            generator=torch.Generator().manual_seed(0)).state_dict()
        fields, path_launches = variant_forward(
            torch, port, ops, cfg_ln, ln_state,
            {"linear_encoder_attention": 16}, "ln")
        launches.update(path_launches)
        yield fields
    torch.cuda.empty_cache()

    sol = speed_of_light(k2_bf16["flops"], k2_bf16["bytes"],
                         peak_flops=PEAK_OPS_PER_S["bfloat16"])
    sol_ms = sol["t_sol_s"] * 1e3
    by = {"memory": "bytes", "compute": "operations"}[sol["bound"]]
    if not (math.isclose(sol_ms, k2_bf16["bound_ms"], rel_tol=1e-12)
            and by == k2_bf16["bound_by"]):
        raise AssertionError(f"speed_of_light {sol} against bound() "
                             f"{k2_bf16['bound_ms']} {k2_bf16['bound_by']}")
    memory = device_memory_stats("cuda")
    if not 0 <= memory["bytes_in_use"] <= memory["bytes_limit"]:
        raise AssertionError(f"device_memory_stats {memory}")
    yield {"path": "utilities", "device_memory_stats": memory,
           "k2_speed_of_light": sol, "k2_bound_ms": k2_bf16["bound_ms"],
           "k2_bound_by": k2_bf16["bound_by"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import torch.nn.functional as F

        import oetr_tpu_torch as port
        from oetr_tpu_torch import ops
        from oetr_tpu_torch.ops._build import load_library
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1
    # f32 products and convolutions in full f32 (cuDNN defaults to TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    # One query; its first two fields are the line that
    # ``--query-gpu=name,power.limit --format=csv,noheader`` prints.
    query = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0].split(", ")
    smi = ", ".join(query[:2])
    sm_mhz = float(query[2].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_CLK_PER_SM * sms * sm_mhz * 1e6
    phase("device", name=kind, nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, sms=sms, max_sm_mhz=sm_mhz)

    # The sfm phase's CPU run starts while nvcc builds, and so does the
    # import of torch._dynamo, which forward-mode AD (the sfm phase's
    # Jacobians) makes on first use: ~8 s on the card's machine.
    cpu_ba = start_cpu_ba()
    import threading

    from oetr_tpu_torch.interop import zstd
    dynamo = threading.Thread(target=__import__, args=("torch._dynamo",))
    dynamo.start()
    # The checkpoint reader's zstd decoder (g++, host code) builds beside
    # nvcc; the shipped phase reports its seconds.
    decoder = threading.Thread(target=zstd.load_decoder)
    decoder.start()
    _, record = load_library()
    dynamo.join()
    decoder.join()
    phase("build", so=record["so"], built=record["built"],
          steps_s=record["steps_s"],
          tensor_core_kernels=tensor_core_resources(record["resources"]),
          k3_k4_kernels=k3_k4_resources(record["resources"]),
          k1_kernels=k1_resources(record["resources"]),
          eigh_kernels=eigh_resources(record),
          ptxas=record["ptxas"])

    k2, k3 = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        k2[dtype_name] = check_linear_encoder(torch, F, ops, dtype_name,
                                              b=8, l=400, s=400, seed=10,
                                              q_masked=False)
        phase("kernel", **k2[dtype_name])
        phase("kernel", **check_linear_encoder(torch, F, ops, dtype_name,
                                               b=8, l=400, s=300, seed=11,
                                               q_masked=True))
        # K2 at the fc config's width: C = 512, 8 heads of 64.
        phase("kernel", **check_linear_encoder(torch, F, ops, dtype_name,
                                               b=8, l=100, s=100, seed=14,
                                               q_masked=True, c=512, nhead=8))
        # K3 at the stem's [B, 320, 320, 64]: bf16 at the flagship's 16
        # images (8 pairs), f32 at the f32 slice's 4.
        k3[dtype_name] = check_gn_pool(
            torch, F, ops, load_library, dtype_name,
            b=16 if dtype_name == "bfloat16" else 4, h=320, w=320, c=64,
            seed=12)
        phase("kernel", **k3[dtype_name])

    k4 = check_sinkhorn(torch, ops, b=BATCH_PAIRS, k=SPARSE_K,
                        iters=SINKHORN_ITERS, seed=13, sfu_per_s=sfu_per_s,
                        big_k=K4_OVER_SMEM_K)
    phase("kernel", **k4)

    # K1, K5, K6 at OETR's [8, 400, 8, 32] (and K5, K6 at the long regime's
    # [2, 4096, 8, 32]); the unmasked bf16 results go into the table.
    attn = {}
    for dtype_name in ("float32", "bfloat16"):
        for op, b, n, masks_set in (
                ("linear", 8, 400, ("none", "both")),
                ("full", 8, 400, ("none", "both", "q_only")),
                ("flash", 8, 400, ("none", "both")),
                ("flash", 2, 4096, ("both",)),
                ("full", 2, 4096, ("both",)),
                ("linear", 2, 2500, ("both",))):
            for i, masks in enumerate(masks_set):
                res = check_attention(torch, F, ops, op, dtype_name, b, n, n,
                                      masks, seed=20 + i, sfu_per_s=sfu_per_s)
                attn[op, dtype_name, n, masks] = res
                phase("kernel", **res)
        # K1 at D = 64.
        phase("kernel", **check_attention(torch, F, ops, "linear", dtype_name,
                                          8, 400, 400, "none", seed=25,
                                          sfu_per_s=sfu_per_s, h=8, d=64))
    # K5 and K6 at SuperGlue's GNN shape, 2048 keypoints, 4 heads of 64:
    # the tensor-core tile at D = 64.
    for op in ("full", "flash"):
        phase("kernel", **check_attention(torch, F, ops, op, "bfloat16", 8,
                                          2048, 2048, "both", seed=30,
                                          sfu_per_s=sfu_per_s, h=4, d=64))

    # Path 1, the OETR slice: both kernels, both dtypes; f32 at 2 pairs.
    fields, _ = run_slice(torch, port, ops, "float32", b=2, timed=False)
    phase("slice", **fields)
    fields, _ = run_slice(torch, port, ops, "bfloat16", b=BATCH_PAIRS,
                          timed=True)
    phase("slice", **fields)

    # Path 2, the sparse pipeline, whose launches the table reports for
    # K2, K3 and K4.
    fields, retry, launches = run_sparse(torch, port, ops, b=BATCH_PAIRS)
    phase("sparse", **fields)
    phase("sparse_retry", **retry)
    phase("sparse_f32", **run_sparse_f32(torch, port, b=2))

    # Path 3, OETR with full attention: K5, then K6 (with K3), in bf16 at
    # 8 pairs and f32 at 2; K6 once more at 1600x1600 (2500 tokens).
    for attention in ("full:cuda", "full:flash"):
        fields, full_launches = run_slice(torch, port, ops, "bfloat16",
                                          b=BATCH_PAIRS, timed=True,
                                          attention=attention)
        phase("full", **fields)
        name = ENCODER_KERNEL[attention]
        launches[name] = full_launches[name]
        fields, _ = run_slice(torch, port, ops, "float32", b=2, timed=False,
                              attention=attention)
        phase("full", **fields)
    fields, _ = run_slice(torch, port, ops, "bfloat16", b=2, timed=False,
                          attention="full:flash", hw=LONG_HW)
    phase("full_long", **fields)

    # Path 4, the fc config: K2 at D = 64.
    cfg_on, cfg_off = fc_configs(port, "bfloat16")
    fields, _ = run_forward(torch, port, ops, cfg_on, cfg_off,
                            {"linear_encoder_attention": 16}, BATCH_PAIRS,
                            IMAGE_HW, False, "fc")
    phase("fc", **fields)

    # Path 5, K1's module path.
    fields, k1_launches = run_linear_attend(torch, port, ops, BATCH_PAIRS)
    phase("linear_attend", **fields)
    launches["linear_attention_cuda"] = k1_launches["linear_attention_cuda"]

    # The kernels' gradients (JAX's: autograd of the plain functions), each
    # at its main path's shape in bf16, then OETR's backward in f32.
    phase("grad", **run_grad(torch, port, ops, BATCH_PAIRS))

    # Path 6, bench stage 6's LoFTR alone, then the dense pipeline, whose
    # K2 and K3 launches the table adds to the sparse path's.
    phase("loftr", **run_loftr(torch, port, ops))
    fields, retry, dense_launches = run_dense(torch, port, ops,
                                              DENSE_PAIRS)
    phase("dense", **fields)
    phase("dense_retry", **retry)
    torch.cuda.empty_cache()

    # Path 7, the scene generator (stage 5's pattern on its pairs is the
    # trained phase's).
    phase("scenes", **run_scenes(torch, port, SCENE_PAIRS))

    # Path 8, two-view pose: the estimator on general and planar scenes,
    # the card against the CPU.
    fields, eigh_row = run_pose(torch, port, ops)
    phase("pose", **fields)
    failed = [f"pose: {f}" for f in fields["failures"]]
    torch.cuda.empty_cache()

    # Path 9, OETR training: the flagship's train step in f32 through K2
    # and K3 (their backward: autograd of the plain functions), its state
    # in JAX's layout; then the probe's box half on that state (path 9b).
    fields, train_launches, probe_launches = run_train(torch, port, ops)
    phase("train", **fields)
    torch.cuda.empty_cache()

    # Path 10, the public matching API: build_model / get_matches / get_pose
    # over the registry's extractors and matchers, COTR; its registry-built
    # quick start runs K2, K3 and K4.
    fields, api_launches = run_api(torch, port, ops)
    phase("api", **fields)
    failed += [f"api: {f}" for f in fields["failures"]]
    torch.cuda.empty_cache()

    # Path 10b, the trained-weights path: the committed matching stores
    # read by the port's own reader, build_shipped_model("superglue") with
    # K4 on trained scores, JAX's matcher gate, the card against the CPU.
    fields, shipped_launches, matching = run_shipped(
        torch, port, ops, zstd.decoder_record())
    phase("shipped", **fields)
    failed += [f"shipped: {f}" for f in fields["failures"]]
    torch.cuda.empty_cache()

    # Path 10c, the all-trained main path: bench stage 5 with the trained
    # OETR (K2, K3), SuperPoint and SuperGlue (K4) in bf16, the trained
    # dense pipeline, JAX's LoFTR gate and stage 5's matches scored.
    fields, trained_launches = run_trained(torch, port, ops, matching)
    phase("trained", **fields)
    failed += [f"trained: {f}" for f in fields["failures"]]
    del matching
    torch.cuda.empty_cache()

    # Path 11, reconstruction: the SfM demo's rig (per-edge pose, the chain,
    # triangulation on the eigh kernel at n = 4, BA, the exports), then BA
    # at the counts of BAL's Dubrovnik-16.
    fields, sfm_eigh = run_sfm(torch, port, ops, cpu_ba)
    phase("sfm", **fields)
    failed += [f"sfm: {f}" for f in fields["failures"]]
    torch.cuda.empty_cache()

    # Path 12, the matching trainers (SuperPoint with homographic
    # adaptation, SuperGlue, LoFTR, ContextDesc) and the FCOS head: one
    # line each. None of the port's kernels is on these paths.
    for fields in run_match_train(torch, port, ops):
        phase("match_train", **fields)
    torch.cuda.empty_cache()

    # Path 13, the demo programs (oetr_tpu_torch.scripts) at their JAX
    # defaults' widths: train_demo (K2, K3), train_matching_demo (K4 in its
    # evaluate), train_loftr_demo.
    demo_launches = collections.Counter()
    for fields in run_demos(torch, port, ops, demo_launches):
        phase("demos", **fields)
    torch.cuda.empty_cache()

    # Path 14, the OETR variants at the flagship's widths: the frozen
    # BatchNorm backbone from a reference-layout checkpoint file, the
    # space-to-depth stem with GroupNorm and the fused stem, the LayerNorm
    # backbone; then the profiling utilities.
    variant_launches = collections.Counter()
    for fields in run_variants(torch, port, ops, k2["bfloat16"],
                               variant_launches):
        phase("variants", **fields)
    torch.cuda.empty_cache()

    # Path 15, the parallel layer at one rank under NCCL: the flagship's
    # train step through DDP, FSDP2 (K2 in bf16) and TP on a small config,
    # BA with a group, each against the one-process run.
    fields, multi_launches = run_multi(torch, port, ops)
    phase("multi", **fields)

    phase("kernels", ported=["linear_attention_cuda<-K1",
                             "linear_encoder_attention<-K2",
                             "groupnorm_relu_maxpool<-K3",
                             "log_sinkhorn_cuda<-K4",
                             "full_attention_cuda<-K5",
                             "flash_attention_cuda<-K6"],
          also=["eigh<-jnp.linalg.eigh (no pallas_call), "
                "oetr_tpu/geometry/ransac.py:52 and oetr_tpu/sfm/ba.py:247"])
    main_dtype = "bfloat16"
    pallas = "oetr_tpu/ops/pallas_attention.py"
    table = []
    # (name, source, TPU kernel, kernel phase, the path of ``launches``)
    for name, src, replaces, res, path in (
            ("linear_attention_cuda",
             "oetr_tpu_torch/csrc/linear_attention.cu",
             f"{pallas}:172", attn["linear", main_dtype, 400, "none"],
             "linear_attend"),
            ("linear_encoder_attention",
             "oetr_tpu_torch/csrc/linear_encoder.cu",
             f"{pallas}:461", k2[main_dtype], "sparse"),
            ("groupnorm_relu_maxpool",
             "oetr_tpu_torch/csrc/gn_relu_maxpool.cu",
             "oetr_tpu/ops/pallas_norm.py:97", k3[main_dtype], "sparse"),
            ("log_sinkhorn_cuda", "oetr_tpu_torch/csrc/log_sinkhorn.cu",
             "oetr_tpu/ops/pallas_sinkhorn.py:53", k4, "sparse"),
            ("full_attention_cuda", "oetr_tpu_torch/csrc/full_attention.cu",
             f"{pallas}:201", attn["full", main_dtype, 400, "none"], "full"),
            ("flash_attention_cuda", "oetr_tpu_torch/csrc/flash_attention.cu",
             f"{pallas}:289", attn["flash", main_dtype, 400, "none"],
             "full")):
        by_path = {p: n for p, n in ((path, launches[name]),
                                     ("dense", dense_launches[name]),
                                     ("train", train_launches[name]),
                                     ("probe", probe_launches[name]),
                                     ("api", api_launches[name]),
                                     ("shipped", shipped_launches[name]),
                                     ("trained", trained_launches[name]),
                                     ("demos", demo_launches[name]),
                                     ("variants", variant_launches[name]),
                                     ("multi", multi_launches[name]))
                   if n}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(by_path.values()),
               "max_abs_err": res["max_abs_err"],
               "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
               "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
               "library_ms": res["library_ms"]}
        row.update(device_ms=res["device_ms"],
                   library_device_ms=res.get("library_device_ms"),
                   launches_by_path=by_path)
        table.append(row)
    # The pose path's eigensolver: not the port of a Pallas kernel (JAX's
    # estimator calls jnp.linalg.eigh), a kernel all the same.
    table.append({"name": "eigh", "route": "cuda",
                  "source": "oetr_tpu_torch/csrc/small_eigh.cu",
                  "replaces": "oetr_tpu/geometry/ransac.py:52",
                  "launches": eigh_row["launches"] + sfm_eigh["launches"],
                  "max_abs_err": eigh_row["max_abs_err"],
                  "ms": eigh_row["kernel_ms"],
                  "plain_ms": eigh_row["plain_ms"],
                  "bound_ms": eigh_row["bound_ms"],
                  "bound_by": eigh_row["bound_by"],
                  "library_ms": eigh_row["library_ms"],
                  "device_ms": eigh_row["device_ms"],
                  "library_device_ms": eigh_row["library_device_ms"],
                  "device_ms_by_shape": eigh_row["by_shape"]
                  + sfm_eigh["by_shape"],
                  "traced_pose_device_ms": eigh_row["traced_pose_device_ms"],
                  "launches_by_path": {"pose": eigh_row["launches"],
                                       "sfm": sfm_eigh["launches"]},
                  "sfm_launches_4x4": sfm_eigh["launches_4x4"],
                  "also_replaces": "oetr_tpu/sfm/ba.py:247 (triangulation, "
                                   "n = 4)"})
    if elapsed() > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"chip_smoke: out of bounds: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
