#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (oetr_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``oetr_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain torch version at the flagship shapes in
float32 and bfloat16, then drives the flagship OETR forward (ResNet50 to
layer3, d_model 256, 640x640 pairs, seeded random weights) with both kernel
switches on, and checks it against the same model with both switches off.
One JSON line per phase, each with ``t_s``, seconds since start. The last
line is ``{"ok": true, "device": {...}}``; it is printed only when every
check passed. Without a CUDA card, or without the port beside it, the
script exits 1 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
BUDGET_S = 300.0
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


def nbytes(*tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def bound(byte_count: int, ops: int, dtype: str) -> tuple[float, str]:
    """Least time on the card (ms): the larger of bytes over the memory rate
    and operations over the peak rate for the dtype."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tolerance(dtype: str, ref_max: float, bf16_ulps: float,
              f32_rel: float) -> float:
    """Absolute tolerance, relative to the output's largest magnitude."""
    scale = max(1.0, ref_max)
    return (bf16_ulps * 2.0 ** -7 if dtype == "bfloat16" else f32_rel) * scale


# --------------------------------------------------------------- kernels --

def check_linear_encoder(torch, F, ops, dtype_name, b, l, s, seed,
                         q_masked):
    """K2 against its plain version; returns the phase fields."""
    dt = getattr(torch, dtype_name)
    dev = "cuda"
    c, nhead = 256, 8
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

    ms = time_ms(torch, lambda: ops.linear_encoder_attention(*args,
                                                             nhead=nhead))
    plain_ms = time_ms(torch, lambda: ops.linear_encoder_attention_reference(
        *args, nhead=nhead))
    library_ms = time_ms(torch, library)
    flops = (2 * b * (l * c * c + 2 * s * c * c)
             + 2 * b * nhead * (s * d * d + l * d * d + l * d))
    bound_ms, bound_by = bound(nbytes(*args, out), flops, dtype_name)
    return {"kernel": "linear_encoder_attention", "dtype": dtype_name,
            "shape": {"B": b, "L": l, "S": s, "C": c, "H": nhead},
            "q_mask": q_masked, "kv_masked_frac": 0.1,
            "max_abs_err": err, "tol": tol, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_gn_pool(torch, F, ops, load_library, dtype_name, b, h, w, c,
                  seed):
    """K3 against its plain version; returns the phase fields."""
    dt = getattr(torch, dtype_name)
    dev = "cuda"
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

    scale, shift = ops.gn_scale_shift(x, gamma, beta, 32, 1e-5)
    lib, _ = load_library()
    entry = getattr(lib, f"oetr_gn_relu_maxpool_"
                         f"{'f32' if dtype_name == 'float32' else 'bf16'}")
    buf = torch.empty_like(out)

    def apply_only():  # the kernel alone, statistics precomputed
        rc = entry(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                   buf.data_ptr(), b, h, w, c,
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K3 launch failed: cudaError {rc}")

    ms = time_ms(torch, lambda: ops.groupnorm_relu_maxpool(x, gamma, beta))
    apply_ms = time_ms(torch, apply_only)
    plain_ms = time_ms(torch, lambda: ops.groupnorm_relu_maxpool_reference(
        x, gamma, beta))
    library_ms = time_ms(torch, library)
    ops_count = b * (h // 2) * (w // 2) * c * 9 * 3 + 6 * b * h * w * c
    bound_ms, bound_by = bound(nbytes(x, gamma, beta, out), ops_count,
                               dtype_name)
    return {"kernel": "groupnorm_relu_maxpool", "dtype": dtype_name,
            "shape": {"B": b, "H": h, "W": w, "C": c},
            "max_abs_err": err, "tol": tol, "kernel_ms": ms,
            "apply_only_ms": apply_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# ----------------------------------------------------------------- slice --

def slice_configs(port, dtype_name):
    """(both kernel switches on, both off) for the flagship."""
    return (port.oetr_r50_kernels_config(dtype_name),
            port.replace(port.oetr_r50_config(), dtype=dtype_name))


def check_outputs(torch, out, b, hw, d, tag):
    n_tok = (hw // 32) ** 2
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


def run_slice(torch, port, ops, dtype_name, b, timed):
    """The flagship forward with the kernels, against the switches-off
    model with the same weights (and, in bf16, both against the float32
    forward); returns the phase fields and the main path's launches."""
    cfg_on, cfg_off = slice_configs(port, dtype_name)
    model = port.build_oetr(cfg_on, device="cuda",
                            generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    plain = port.build_oetr(cfg_off, device="cuda",
                            generator=torch.Generator().manual_seed(1))
    plain.load_state_dict(state)
    g = torch.Generator(device="cuda").manual_seed(2)
    im1 = torch.rand(b, IMAGE_HW, IMAGE_HW, 3, generator=g, device="cuda")
    im2 = torch.rand(b, IMAGE_HW, IMAGE_HW, 3, generator=g, device="cuda")
    d = cfg_on.d_model
    tol = BOX_TOL_PX[dtype_name]

    with torch.inference_mode():
        # The main path, once, with the launch counts read around it.
        ops.linear_encoder_attention.launches = 0
        ops.groupnorm_relu_maxpool.launches = 0
        out = model(im1, im2)
        torch.cuda.synchronize()
        launches = {"linear_encoder_attention":
                    ops.linear_encoder_attention.launches,
                    "groupnorm_relu_maxpool":
                    ops.groupnorm_relu_maxpool.launches}
        want = {"linear_encoder_attention": 4 * cfg_on.neck.num_layers,
                "groupnorm_relu_maxpool": 1}
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")
        ref = plain(im1, im2)
        check_outputs(torch, out, b, IMAGE_HW, d, "kernels")
        check_outputs(torch, ref, b, IMAGE_HW, d, "plain")
        fields = {"dtype": dtype_name, "pairs": b, "image_hw": IMAGE_HW,
                  "launches": launches,
                  "box_max_diff_px": box_diff_px(port, out, ref, IMAGE_HW),
                  "box_tol_px": tol}
        if dtype_name != "float32":
            truth_cfg = port.replace(cfg_off, dtype="float32")
            truth = port.build_oetr(truth_cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(1))
            truth.load_state_dict(state)
            f32 = truth(im1, im2)
            del truth
            fields["kernels_vs_f32_px"] = box_diff_px(port, out, f32, IMAGE_HW)
            fields["plain_vs_f32_px"] = box_diff_px(port, ref, f32, IMAGE_HW)
        for key in ("box_max_diff_px", "kernels_vs_f32_px", "plain_vs_f32_px"):
            if fields.get(key, 0.0) > tol:
                raise AssertionError(f"slice {dtype_name}: {key} "
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
            t = time.perf_counter()
            for _ in range(10):
                plain(im1, im2)
            torch.cuda.synchronize()
            fields["plain_pairs_per_s"] = 10 * b / (time.perf_counter() - t)
    return fields, launches


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
    phase("device", name=kind, nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    _, record = load_library()
    phase("build", so=record["so"], built=record["built"],
          steps_s=record["steps_s"], ptxas=record["ptxas"])

    k2, k3 = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        k2[dtype_name] = check_linear_encoder(torch, F, ops, dtype_name,
                                              b=8, l=400, s=400, seed=10,
                                              q_masked=False)
        phase("kernel", **k2[dtype_name])
        phase("kernel", **check_linear_encoder(torch, F, ops, dtype_name,
                                               b=8, l=400, s=300, seed=11,
                                               q_masked=True))
        k3[dtype_name] = check_gn_pool(torch, F, ops, load_library,
                                       dtype_name, b=16, h=320, w=320, c=64,
                                       seed=12)
        phase("kernel", **k3[dtype_name])

    # Both kernels, both dtypes, on the full path; f32 at 2 pairs.
    fields, _ = run_slice(torch, port, ops, "float32", b=2, timed=False)
    phase("slice", **fields)
    fields, launches = run_slice(torch, port, ops, "bfloat16",
                                 b=BATCH_PAIRS, timed=True)
    phase("slice", **fields)

    phase("kernels", ported=["linear_encoder_attention<-K2",
                             "groupnorm_relu_maxpool<-K3"])
    main_dtype = "bfloat16"
    table = []
    for name, src, replaces, res in (
            ("linear_encoder_attention",
             "oetr_tpu_torch/csrc/linear_encoder.cu",
             "oetr_tpu/ops/pallas_attention.py:461", k2[main_dtype]),
            ("groupnorm_relu_maxpool",
             "oetr_tpu_torch/csrc/gn_relu_maxpool.cu",
             "oetr_tpu/ops/pallas_norm.py:97", k3[main_dtype])):
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": res["max_abs_err"],
                      "ms": res["kernel_ms"], "plain_ms": res["plain_ms"],
                      "bound_ms": res["bound_ms"],
                      "bound_by": res["bound_by"],
                      "library_ms": res["library_ms"]})
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
