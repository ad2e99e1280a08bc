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
    outside the backbone and at OETR_BACKBONE_COS inside it.
K1's lines give its cluster (blocks per batch row and head), its grid and
its device time at every cluster size.
One JSON line per phase, each with ``t_s``, seconds since start. The last
line is ``{"ok": true, "device": {...}}``; it is printed only when every
check passed. Without a CUDA card, or without the port beside it, the
script exits 1 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

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
           "full_attention_cuda", "flash_attention_cuda")
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


def device_ms(torch, fn, reps: int = 20, warmup: int = 3,
              sessions: int = 3) -> float:
    """Device time per call of ``fn()``: the summed duration of the device
    activity (kernels, copies) of ``reps`` calls in a torch.profiler trace,
    over ``reps``. Unlike ``time_ms`` it leaves out the host's work between
    launches. ``fn`` launches the same work on every call, so a trace whose
    count of device events is 0 or not a multiple of ``reps`` missed some
    (seen once on the H100 in ~100 traces): it is taken again, up to
    ``sessions`` traces in all."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [evt for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA]
        if dev and len(dev) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
        counts.append(len(dev))
    raise RuntimeError(f"torch.profiler recorded {counts} device events for "
                       f"{reps} calls")


def traced_launches(torch, fn, kernel_name: str, reps: int = 3,
                    sessions: int = 3) -> int:
    """Launches per call of ``fn()`` of the kernels whose name holds
    ``kernel_name``: their device events in a torch.profiler trace of
    ``reps`` calls, over ``reps``. A count that is not a multiple of
    ``reps`` missed an event, and is traced again as in ``device_ms``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for evt in prof.events()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and kernel_name in evt.name)
        if n % reps == 0:
            return n // reps
        counts.append(n)
    raise RuntimeError(f"torch.profiler recorded {counts} {kernel_name} "
                       f"events for {reps} calls")


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
        want = dict(zip(KERNELS, (16, 1, 1, 0, 0, 0)))
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

    phase("kernels", ported=["linear_attention_cuda<-K1",
                             "linear_encoder_attention<-K2",
                             "groupnorm_relu_maxpool<-K3",
                             "log_sinkhorn_cuda<-K4",
                             "full_attention_cuda<-K5",
                             "flash_attention_cuda<-K6"])
    main_dtype = "bfloat16"
    pallas = "oetr_tpu/ops/pallas_attention.py"
    table = []
    for name, src, replaces, res in (
            ("linear_attention_cuda",
             "oetr_tpu_torch/csrc/linear_attention.cu",
             f"{pallas}:172", attn["linear", main_dtype, 400, "none"]),
            ("linear_encoder_attention",
             "oetr_tpu_torch/csrc/linear_encoder.cu",
             f"{pallas}:461", k2[main_dtype]),
            ("groupnorm_relu_maxpool",
             "oetr_tpu_torch/csrc/gn_relu_maxpool.cu",
             "oetr_tpu/ops/pallas_norm.py:97", k3[main_dtype]),
            ("log_sinkhorn_cuda", "oetr_tpu_torch/csrc/log_sinkhorn.cu",
             "oetr_tpu/ops/pallas_sinkhorn.py:53", k4),
            ("full_attention_cuda", "oetr_tpu_torch/csrc/full_attention.cu",
             f"{pallas}:201", attn["full", main_dtype, 400, "none"]),
            ("flash_attention_cuda", "oetr_tpu_torch/csrc/flash_attention.cu",
             f"{pallas}:289", attn["flash", main_dtype, 400, "none"])):
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": res["max_abs_err"],
               "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
               "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
               "library_ms": res["library_ms"]}
        row.update(device_ms=res["device_ms"],
                   library_device_ms=res.get("library_device_ms"))
        table.append(row)
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
