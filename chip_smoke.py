#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (oetr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``oetr_tpu_torch/csrc`` with nvcc
(reporting ptxas's registers and spills for the bf16 kernels on mma.sync:
K2, K5, K6), holds each kernel against its plain torch version at the main
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
    with OETR's switches on (K2, K3, their launches also counted in a
    trace, and every output of theirs in one OETR pass held to the plain
    version on the same inputs) against off; ``dense_retry``: one call
    whose low-match pairs take the full-image retry;
  * ``scenes``: the port's scene generator on the card (8 pairs of 832x832,
    bench stage 5's settings), its ground-truth boxes against the geometry
    path on the CPU, then bench stage 5's pattern on them: the sparse
    pipeline (descriptor 128, keypoint threshold 0, K2, K3, K4 on) with the
    < 30 matches retry;
  * ``pose``: two-view pose (``estimate_pose`` with JAX's defaults: 512
    hypotheses, 8 LO candidates, the planar fallback) on 8 pairs of 2048
    slots: general scenes (1400 true correspondences, 0.5 px noise, 30%
    outliers) held to the truth, and the scene generator's planar pairs
    with the route that won each (H, P&P or E); the 5-point stage off (the
    card's default) and on; each against the port on the CPU on the same
    inputs and draws; the eigh kernel (``csrc/small_eigh.cu``, the
    estimator's null vectors and 3x3 SVDs) on every call of the path
    against LAPACK; the scenes phase's sparse matches scored (pose AUC);
    ms a call, device busy ms, idle share, launches and device -> host
    copies a call (none with the 5-point stage off), and the host 5-point
    stage alone.
K1's lines give its cluster (blocks per batch row and head), its grid and
its device time at every cluster size.
One JSON line per phase, each with ``t_s``, seconds since start. The last
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
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
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
# scene generator's planar pairs), JAX's estimator defaults. On the
# general scenes every pair within POSE_GT_R_DEG / POSE_GT_T_DEG of the
# truth (the JAX tests' bounds at 200 points). The card against the port
# on the CPU, on the same inputs and draws: each pair's err_R and err_t
# within POSE_CPU_DEG of the CPU's, inlier counts within POSE_CPU_INLIERS
# (relative). The eigensolvers differ (the Jacobi kernel against LAPACK),
# so hypotheses differ in their last bits and a vote between two near
# equal candidates can go either way; the refinement then settles a
# rounding apart.
POSE_GT_R_DEG, POSE_GT_T_DEG = 2.0, 5.0
POSE_CPU_DEG = 0.25
POSE_CPU_INLIERS = 0.01
# The eigh kernel against LAPACK's syevd (its plain version) on the path's
# matrices: eigenvalues, the residual |A V - V diag(w)| and V's
# orthogonality, relative to each matrix's largest |eigenvalue|; both are
# backward stable, to ~n float32 ulps.
EIGH_TOL = 1e-5


def elapsed() -> float:
    return time.perf_counter() - T0


def phase(phase_name: str, /, **fields) -> None:
    if elapsed() > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget at phase "
                           f"{phase_name}")
    print(json.dumps({"phase": phase_name, "t_s": round(elapsed(), 3),
                      **fields}), flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
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


def trace_calls(torch, fn, reps: int, warmup: int = 1, sessions: int = 6,
                select=None):
    """``reps`` calls of ``fn()`` in a torch.profiler trace, after
    ``warmup`` calls: (the profile, its device events (kernels, copies,
    sets; profile_forward.device_events leaves out the pad kernels that
    open the trace and absorb the device events it can miss at its start,
    and the device-side spans of record_function ranges), the wall ms per
    call, the traces taken). ``fn`` launches the same work on every call,
    so a trace where the count of events that ``select`` keeps (all by
    default) is 0 or not a multiple of ``reps`` missed some (seen once on
    the H100 in ~100 traces, and once in two traces in a row): it is
    taken again, up to ``sessions`` traces in all."""
    from oetr_tpu_torch.profile_forward import device_events, pad_trace

    select = select or (lambda evts: evts)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
        dev, _ = device_events(prof)
        kept = select(dev)
        if kept and len(kept) % reps == 0:
            return prof, dev, wall, taken
        names = collections.Counter(e.name for e in kept)
        counts.append((len(kept), {name[:80]: n for name, n in names.items()
                                   if n % reps}))
    raise RuntimeError(f"torch.profiler recorded (device events, the names "
                       f"whose count is not a multiple of {reps}) {counts} "
                       f"for {reps} calls")


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call of ``fn()``: the summed duration of the device
    events of ``reps`` calls in a trace (``trace_calls``), over ``reps``.
    Unlike ``time_ms`` it leaves out the host's work between launches."""
    _, dev, _, _ = trace_calls(torch, fn, reps, warmup)
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def traced_launches(torch, fn, kernel_name: str, reps: int = 3) -> int:
    """Launches per call of ``fn()`` of the kernels whose name holds
    ``kernel_name``: their device events in a trace of ``reps`` calls
    (``trace_calls``), over ``reps``."""
    pick = lambda evts: [e for e in evts if kernel_name in e.name]
    _, dev, _, _ = trace_calls(torch, fn, reps, select=pick)
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
    units' rate ``sfu_per_s``."""
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
            "bound_ms": bound_ms, "bound_by": bound_by}


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
                        reps=10)
    del wide

    call = lambda: ops.log_sinkhorn_cuda(aug, mu, nu, iters)
    launches = traced_launches(torch, call, "sinkhorn_kernel")
    if launches != plan.launches:
        raise AssertionError(f"K4: {launches} sinkhorn_kernel launches a "
                             f"call in the trace, the plan has "
                             f"{plan.launches}")
    ms = time_ms(torch, call)
    dev_ms = device_ms(torch, call, reps=10)
    plain_ms = time_ms(torch, lambda: ops.log_sinkhorn(aug, mu, nu, iters),
                       reps=10)
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

    reps = 20 if b * l * s <= 8 * 400 * 400 else 5
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
    for _ in range(2):
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
        fields["pairs_per_s"] = pairs_per_s(torch, pipe_on, args, reps=5)
        fields["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del pipe_k4_off, sg_k4_off
        off = sparse_models(torch, port, "bfloat16", kernels=False, like=on)
        pipe_off = pipeline(port, off, off[2], 0)
        fields["plain_pairs_per_s"] = pairs_per_s(torch, pipe_off, args,
                                                  reps=5)
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
        ms = time_ms(torch, call, reps=10, warmup=2)
        busy = device_ms(torch, call, reps=3, warmup=1)
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
def recorded_kernel_calls():
    """Records every call OETR makes to K2's and K3's wrappers, as
    {wrapper name: [(args, kwargs, output), ...]}, passing each on."""
    from oetr_tpu_torch.models import resnet, transformer

    calls = {}
    sites = [(mod, name, getattr(mod, name)) for mod, name in (
        (transformer, "linear_encoder_attention"),
        (resnet, "groupnorm_relu_maxpool"))]

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.setdefault(name, []).append((args, kwargs, out))
            return out
        return call

    try:
        for mod, name, fn in sites:
            setattr(mod, name, recorder(name, fn))
        yield calls
    finally:
        for mod, name, fn in sites:
            setattr(mod, name, fn)


def recorded_kernel_errors(torch, ops, calls):
    """Each recorded output of K2 and K3 against the plain version on the
    same inputs, at the kernel checks' tolerances (K2: 2 bf16 ulps or 1e-4,
    K3: 1 ulp or 1e-5, of max(1, the plain output's largest magnitude)).
    Returns {name: {"calls", "max_abs_err", "max_err_over_tol"}}; raises
    where an output is outside its tolerance."""
    plain = {"linear_encoder_attention":
             (ops.linear_encoder_attention_reference, 2, 1e-4),
             "groupnorm_relu_maxpool":
             (ops.groupnorm_relu_maxpool_reference, 1, 1e-5)}
    result = {}
    for name, recorded in calls.items():
        reference, ulps, rel = plain[name]
        errs, ratios = [], []
        for args, kwargs, out in recorded:
            ref = reference(*args, **kwargs).float()
            err = (out.float() - ref).abs().max().item()
            dtype_name = str(args[0].dtype).removeprefix("torch.")
            tol = tolerance(dtype_name, ref.abs().max().item(), ulps, rel)
            if tuple(out.shape) != tuple(ref.shape) or not err <= tol:
                raise AssertionError(f"{name} on the dense path, input "
                                     f"{tuple(args[0].shape)}: max_abs_err "
                                     f"{err} > tol {tol}")
            errs.append(err)
            ratios.append(err / tol)
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
        # K2 (two CUDA launches a call) and K3 (statistics, fold, apply)
        # in a trace of the path.
        call = lambda: pipe_on(*args)
        traced = {"linear_encoder_kernel": traced_launches(
                      torch, call, "linear_encoder_kernel"),
                  "gn_apply_pool_kernel": traced_launches(
                      torch, call, "gn_apply_pool_kernel")}
        if traced != {"linear_encoder_kernel": 32,
                      "gn_apply_pool_kernel": 1}:
            raise AssertionError(f"dense: traced launches a call {traced}")
        fields = {
            "pairs": b, "canvas_hw": CANVAS_HW, "oetr_hw": IMAGE_HW,
            "oetr_dtype": "bfloat16", "loftr_dtype": "float32",
            "launches_per_call": {k: n for k, n in launches.items() if n},
            "cuda_launches_per_call_traced": traced,
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
        torch.cuda.reset_peak_memory_stats()
        fields["pairs_per_s"] = pairs_per_s(torch, pipe_on, args, reps=5)
        fields["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        fields["plain_pairs_per_s"] = pairs_per_s(torch, pipe_off, args,
                                                  reps=5)
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


def run_scenes(torch, port, ops, b):
    """The port's scene generator on the card, its ground-truth boxes
    against ``overlap_bbox_pair`` on the CPU on the same tensors, then bench
    stage 5's pattern on its pairs (seeded weights). Returns the phase
    fields, and the pipeline's output with the generator's batch (the pose
    phase scores its matches)."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.geometry.overlap import overlap_bbox_pair

    gen_ms = time_ms(torch, lambda: pf.scene_pairs(CANVAS_HW, b, 7, DEV),
                     reps=3, warmup=1)
    args, raw = scene_inputs(b, seed=7)
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

    dt = torch.bfloat16
    oetr = port.build_oetr(port.oetr_r50_kernels_config("bfloat16"),
                           device=DEV,
                           generator=torch.Generator().manual_seed(0))
    sp = port.build_superpoint(device=DEV, max_keypoints=SPARSE_K,
                               keypoint_threshold=0.0, descriptor_dim=128,
                               dtype=dt,
                               generator=torch.Generator().manual_seed(3))
    sg = port.build_superglue(device=DEV, descriptor_dim=128, dtype=dt,
                              cuda_sinkhorn=True,
                              generator=torch.Generator().manual_seed(4))
    cfg = port.PipelineConfig(canvas_hw=(CANVAS_HW, CANVAS_HW),
                              oetr_hw=(IMAGE_HW, IMAGE_HW),
                              fallback_min_matches=30, box_source="heatmap")
    pipe = port.SparsePipeline(sp, sg, oetr=oetr, cfg=cfg)
    with torch.inference_mode():
        first = pipe._run(*args, use_overlap=True)
        need = ((first["num_matches"] < 30) & first["used_overlap"]).cpu()
        n_retry = int(need.sum())
        reset_counts(ops)
        out = pipe(*args)
        torch.cuda.synchronize()
        launches = launch_counts(ops)
        want = {name: 0 for name in KERNELS}
        want.update(linear_encoder_attention=16, groupnorm_relu_maxpool=1,
                    log_sinkhorn_cuda=1 + -(-n_retry // 2))
        used = first["used_overlap"].cpu() & ~need
        if launches != want or not torch.equal(out["used_overlap"].cpu(),
                                               used):
            raise AssertionError(f"scenes: launches {launches} != {want}, "
                                 f"or used_overlap {out['used_overlap']}")
        rate = pairs_per_s(torch, pipe, args, reps=3)
    return {"weights": "seeded", "pairs": b, "canvas_hw": CANVAS_HW,
            "generator": {**pf.SCENE_KW, "ms": gen_ms,
                          "translated_pairs": int((s == 1.0).sum()),
                          "scale": [round(v, 4) for v in s.tolist()]},
            "gt_boxes_equal_cpu": gt_equal,
            "overlap_box1": raw["overlap_box1"].tolist(),
            "descriptor_dim": 128, "keypoints": SPARSE_K,
            "keypoint_threshold": 0.0, "fallback_min_matches": 30,
            "launches": {k: n for k, n in launches.items() if n},
            "matches_per_pair_first_pass": first["num_matches"].tolist(),
            "matches_per_pair": out["num_matches"].tolist(),
            "pairs_used_overlap": int(out["used_overlap"].sum()),
            "pairs_gated": int((~first["used_overlap"]).sum()),
            "pairs_retried": n_retry,
            "bbox0": [[round(v, 1) for v in row]
                      for row in first["bbox0"].tolist()],
            "pairs_per_s": rate}, {"out": out, "raw": raw}


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

    calls, real = [], small_eigh.eigh

    def recorder(A):
        calls.append(A)
        return real(A)

    sites = (small_eigh, homography, ransac)
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


def eigh_row(torch, ops, A):
    """The eigh kernel's row of the kernels line on the path's largest
    call, A [8, 512, 9, 9] (round 1's normal matrices). Its bound is the
    function's, not the Jacobi kernel's: each matrix read once and w, V
    written once, and ~9 n³ flops a matrix, what a symmetric
    eigendecomposition with vectors needs (Householder tridiagonalization
    and implicit QL, Golub & Van Loan §8.3)."""
    batch, n = A.numel() // (A.shape[-1] ** 2), A.shape[-1]
    w, V = ops.eigh(A)
    bnd, bound_by = bound(nbytes(A, w, V), batch * 9 * n ** 3, "float32")
    host = A.cpu()
    t = []
    for _ in range(3):
        t0 = time.perf_counter()
        ops.eigh_reference(host)
        t.append((time.perf_counter() - t0) * 1e3)
    return {"shape": list(A.shape), "matrices": batch,
            "kernel_ms": time_ms(torch, lambda: ops.eigh(A)),
            "device_ms": device_ms(torch, lambda: ops.eigh(A)),
            "plain_ms": statistics.median(t),
            "plain": "LAPACK syevd on the host (scipy), the CPU path",
            "library_ms": time_ms(torch, lambda: torch.linalg.eigh(A)),
            "library_device_ms": device_ms(torch,
                                           lambda: torch.linalg.eigh(A)),
            "bound_ms": bnd, "bound_by": bound_by}


def traced_stats(torch, fn, reps=3):
    """Per call of ``fn()`` in a trace of ``reps`` calls (``trace_calls``):
    wall ms, device busy ms, the idle share, kernel launches, device ->
    host copies, and the CPU ops that read a device value back."""
    prof, dev, wall, taken = trace_calls(torch, fn, reps)
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
            "device_reads": dict(readers), "traces_taken": taken}


def pose_case(torch, port, d, use_5pt, seed, device=None, replay=None):
    """estimate_pose with JAX's defaults on the problems ``d`` (on
    ``device``, DEV by default); its draws from a generator seeded
    ``seed``, or ``replay``. Returns (result, per-pair errors, the draws,
    the route whose candidate won each pair's vote: 'H' (a homography
    decomposition), 'P&P' (plane and parallax) or 'E' (the LO-RANSAC's
    pose), as the estimator's vote picked it)."""
    from oetr_tpu_torch.geometry.ransac import VOTE_ROUTES
    from oetr_tpu_torch.pose_parting import recorded

    device = device or DEV
    d = {k: v.to(device) for k, v in d.items()}
    with pose_draws(replay, device) as log, recorded() as stages:
        res = port.estimate_pose(
            d["kpts0"], d["kpts1"], d["valid"], d["K"], d["K"],
            torch.Generator(device=device).manual_seed(seed),
            use_5pt=use_5pt)
    err_t, err_R = port.pose_error(d["T_0to1"], res["R"], res["t"])
    routes = [VOTE_ROUTES[i] for i in stages["_vote"][0][1].tolist()]
    return (res, (err_R.cpu(), err_t.cpu()),
            log if replay is None else replay, routes)


def run_pose(torch, port, ops, scenes):
    """Two-view pose on the card (``estimate_pose`` with JAX's defaults,
    B = 8, N = 2048): general scenes (the ground truth within
    POSE_GT_R_DEG / POSE_GT_T_DEG, no padded slot an inlier) and the scene
    generator's planar pairs, with the 5-point stage off (the card's
    default) and on; the card against the CPU on the same inputs and
    draws; the eigh kernel on every call of the path against LAPACK; the
    scenes phase's sparse matches scored (pose AUC); times. Returns the
    phase fields and the eigh kernel's row."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.geometry import draws, normalize_keypoints
    from oetr_tpu_torch.geometry.fivepoint import five_point_hypotheses
    from oetr_tpu_torch.geometry.overlap import rigid_inverse
    from oetr_tpu_torch.geometry.homography import sample_minimal_sets

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
        row = eigh_row(torch, ops, max(eigh_calls, key=lambda a: a.numel()))
        row.update(launches=launches["eigh"],
                   max_abs_err=fields["eigh"]["max_abs_err"])
        fields["eigh_kernel"] = row
        lap("main_path_and_eigh")

        failures = []
        for name, d, seed in (("general", general, 12), ("planar", planar,
                                                          15)):
            out = {}
            for use_5pt in (False, True):
                res, (eR, et), log, route = pose_case(torch, port, d,
                                                      use_5pt, seed)
                cpu, (cR, ct), _, cpu_route = pose_case(
                    torch, port, d, use_5pt, seed, device="cpu", replay=log)
                n_card = res["num_inliers"].cpu()
                n_cpu = cpu["num_inliers"]
                padded = bool((res["inliers"] & ~d["valid"]).any())
                dR = (eR - cR).abs().max().item()
                dt = (et - ct).abs().max().item()
                dn = ((n_card - n_cpu).abs().float()
                      / n_cpu.clamp(min=1).float()).max().item()
                case = {"err_R_deg": eR.tolist(), "err_t_deg": et.tolist(),
                        "ok": res["ok"].tolist(),
                        "num_inliers": n_card.tolist(),
                        "valid": d["valid"].sum(-1).tolist(),
                        "route": route, "cpu_route": cpu_route,
                        "cpu_err_R_deg": cR.tolist(),
                        "cpu_err_t_deg": ct.tolist(),
                        "cpu_num_inliers": n_cpu.tolist(),
                        "card_vs_cpu_max_deg": max(dR, dt),
                        "card_vs_cpu_inliers_max_rel": dn,
                        "padded_inliers": padded}
                bad = padded or max(dR, dt) > POSE_CPU_DEG \
                    or dn > POSE_CPU_INLIERS
                if name == "general":
                    bad |= not (bool(res["ok"].all())
                                and eR.max().item() < POSE_GT_R_DEG
                                and et.max().item() < POSE_GT_T_DEG)
                if bad:
                    failures.append(f"{name} use_5pt={use_5pt}")
                out[f"use_5pt={use_5pt}"] = case
            fields[name] = out
        if failures:
            raise AssertionError(f"pose: {failures} out of bounds: "
                                 f"{json.dumps(fields)}")
        lap("card_vs_cpu")
        fields["bounds"] = {"gt_R_deg": POSE_GT_R_DEG,
                            "gt_t_deg": POSE_GT_T_DEG,
                            "card_vs_cpu_deg": POSE_CPU_DEG,
                            "card_vs_cpu_inliers": POSE_CPU_INLIERS}

        # The scenes phase's sparse matches, against the generator's truth.
        out, raw = scenes["out"], scenes["raw"]
        m0 = out["matches0"]
        valid = m0 > -1
        k1 = torch.gather(out["keypoints1"].float(), 1,
                          m0.clamp(min=0)[..., None].expand(-1, -1, 2))
        reset_counts(ops)
        res = port.estimate_pose(out["keypoints0"].float(), k1, valid,
                                 raw["K1"], raw["K2"],
                                 torch.Generator(device=DEV).manual_seed(16))
        torch.cuda.synchronize()
        e2e_launches = launch_counts(ops)
        T = raw["pose2"] @ rigid_inverse(raw["pose1"])
        et, eR = port.pose_error(T, res["R"], res["t"])
        err = torch.where(res["ok"], torch.maximum(et, eR), float("inf"))
        fields["scene_matches"] = {
            "matches_per_pair": valid.sum(-1).tolist(),
            "pairs_ok": int(res["ok"].sum()),
            "pose_auc@5/10/20": port.pose_auc(err.tolist(), [5, 10, 20]),
            "launches": {k: n for k, n in e2e_launches.items() if n},
            "weights": "seeded"}
        lap("scene_matches")

        # Times on the card, B = 8, N = 2048.
        timing = {}
        for use_5pt in (False, True):
            gen = torch.Generator(device=DEV)

            def call():
                gen.manual_seed(12)
                return port.estimate_pose(
                    general["kpts0"], general["kpts1"], general["valid"],
                    general["K"], general["K"], gen, use_5pt=use_5pt)

            ms = time_ms(torch, call, reps=5, warmup=2)
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
        timing["five_point_samples"] = pf.POSE_PAIRS * 128
        fields["timing"] = timing
        lap("timing")
    fields["seconds"] = seconds
    return fields, row


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sfu_per_s = SFU_PER_CLK_PER_SM * sms * sm_mhz * 1e6
    phase("device", name=kind, nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, sms=sms, max_sm_mhz=sm_mhz)

    _, record = load_library()
    phase("build", so=record["so"], built=record["built"],
          steps_s=record["steps_s"],
          tensor_core_kernels=tensor_core_resources(record["resources"]),
          k3_k4_kernels=k3_k4_resources(record["resources"]),
          k1_kernels=k1_resources(record["resources"]),
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

    # Path 7, the scene generator and bench stage 5's pattern on its pairs.
    fields, scenes = run_scenes(torch, port, ops, SCENE_PAIRS)
    phase("scenes", **fields)

    # Path 8, two-view pose: the estimator on general and planar scenes,
    # the card against the CPU, then the scenes' matches scored.
    fields, eigh_row = run_pose(torch, port, ops, scenes)
    phase("pose", **fields)

    phase("kernels", ported=["linear_attention_cuda<-K1",
                             "linear_encoder_attention<-K2",
                             "groupnorm_relu_maxpool<-K3",
                             "log_sinkhorn_cuda<-K4",
                             "full_attention_cuda<-K5",
                             "flash_attention_cuda<-K6"],
          also=["eigh<-jnp.linalg.eigh (no pallas_call), "
                "oetr_tpu/geometry/ransac.py:52"])
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
                                     ("dense", dense_launches[name])) if n}
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
                  "launches": eigh_row["launches"],
                  "max_abs_err": eigh_row["max_abs_err"],
                  "ms": eigh_row["kernel_ms"],
                  "plain_ms": eigh_row["plain_ms"],
                  "bound_ms": eigh_row["bound_ms"],
                  "bound_by": eigh_row["bound_by"],
                  "library_ms": eigh_row["library_ms"],
                  "device_ms": eigh_row["device_ms"],
                  "library_device_ms": eigh_row["library_device_ms"],
                  "launches_by_path": {"pose": eigh_row["launches"]}})
    if elapsed() > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S:.0f} s budget")
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
