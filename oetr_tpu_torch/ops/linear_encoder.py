"""K2: the fused pre-norm encoder attention sublayer.

``linear_encoder_attention`` is the port of
``oetr_tpu/ops/pallas_attention.py::linear_encoder_attention_pallas``:
LayerNorm of x and of the source (eps 1e-5, f32), plus the positional
encodings, the q/k/v projections (no bias) and masked linear attention,
giving the pre-merge message [B, L, C]. On a CUDA tensor it launches the
hand-written kernel in ``csrc/linear_encoder.cu`` (two CUDA launches a
call: the source side, then the query side); on a CPU tensor it runs
``linear_encoder_attention_reference``, its plain torch version.

Weights are in torch's ``nn.Linear`` layout [C_out, C_in] (the transpose of
the flax kernels), f32; ``lnq``/``lnkv`` stack LayerNorm (weight, bias) as
[2, C] f32.

Gradients are JAX's (K2's ``custom_vjp``): when grad mode is on and an
input requires grad, the call runs through ``autograd.KernelFunction``,
whose backward is torch autograd of ``linear_encoder_attention_op``, the
port of ``linear_encoder_attention_xla``. It reaches the f32 weights and
LayerNorm parameters, not the bf16 copies the kernel reads, and sums a
positional encoding's gradient over the batch where it has a batch of 1.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ._build import check_launch, load_library
from .attention import linear_attention
from .autograd import KernelFunction, needs_grad

MAX_HEAD_WIDTH = 64   # the widest head the kernel takes

# id(weight) -> (weakref, (version, data_ptr), the weight rounded to bf16).
_ROUNDED: dict[int, tuple] = {}


def _weight_as(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` as the kernel reads it: f32 as it is; for bf16 a copy rounded
    once, kept while ``w`` lives and made anew when ``w`` changes in place
    (its version counter) or gets other storage. A write through
    ``w.data`` bumps no counter and is not seen."""
    if dtype == torch.float32:
        return w
    if w.is_inference():        # no version counter to watch
        return w.to(dtype)
    key, stamp = id(w), (w._version, w.data_ptr())
    hit = _ROUNDED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == stamp:
        return hit[2]
    rounded = w.detach().to(dtype).contiguous()
    _ROUNDED[key] = (weakref.ref(w, lambda _, k=key: _ROUNDED.pop(k, None)),
                     stamp, rounded)
    return rounded


def forget_rounded_weights() -> None:
    """Drop every cached bf16 copy. FSDP2 writes each forward's gathered
    weights into the same parameter objects without a version bump, at an
    address the allocator may give again; its models call this before each
    forward (``parallel.shard_model``)."""
    _ROUNDED.clear()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16 bytes at a time: a copy where t is not aligned."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rounded_inv(n: int, dtype: torch.dtype) -> float:
    """1/n as the I/O type holds it: the Pallas kernel multiplies V by the
    Python float 1/S, which JAX casts to the array's type."""
    return float(torch.tensor(1.0 / n, dtype=dtype))


def _elu_p1(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return torch.where(x32 > 0, x32 + 1.0, torch.exp(x32)).to(x.dtype)


def _layernorm_f32(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    t32 = t.float()
    mu = t32.mean(dim=-1, keepdim=True)
    cen = t32 - mu
    var = (cen * cen).mean(dim=-1, keepdim=True)
    return cen * torch.rsqrt(var + 1e-5) * p[0] + p[1]


def linear_encoder_attention_reference(x, source, x_pos, s_pos, lnq, lnkv,
                                       wq, wk, wv, q_mask=None, kv_mask=None,
                                       nhead: int = 8, eps: float = 1e-6):
    """Plain torch version of K2.

    The math of ``linear_encoder_attention_xla``, rounded to x's dtype at
    the points where the Pallas kernel rounds (q/kv inputs; q, k, v after
    projection; V/S; KV and ΣK before the last products), with the kernel's
    ``max(den, eps)``. In float32 the rounding is a no-op and
    ``max(den, eps)`` equals ``den + eps`` to float precision.
    """
    dt = x.dtype
    b, l, c = x.shape
    s = source.shape[1]
    d = c // nhead
    q_in = (_layernorm_f32(x, lnq) + x_pos.float()).to(dt)
    kv_in = (_layernorm_f32(source, lnkv) + s_pos.float()).to(dt)

    def proj(t, w):  # f32 accumulation, result rounded to the I/O type
        return (t.float() @ w.to(dt).float().T).to(dt)

    q = proj(q_in, wq).reshape(b, l, nhead, d)
    k = proj(kv_in, wk).reshape(b, s, nhead, d)
    v = proj(kv_in, wv).reshape(b, s, nhead, d)
    qm = (torch.ones(b, l, dtype=dt, device=x.device) if q_mask is None
          else q_mask.to(dt))[:, :, None, None]
    km = (torch.ones(b, s, dtype=dt, device=x.device) if kv_mask is None
          else kv_mask.to(dt))[:, :, None, None]
    Q = (_elu_p1(q) * qm).float()
    K = (_elu_p1(k) * km).float()
    V = ((v * km).float() * _rounded_inv(s, dt)).to(dt).float()

    kv = torch.einsum("bshd,bshe->bhde", K, V).to(dt).float()
    k_sum = K.sum(dim=1).to(dt).float()                      # [B, H, D]
    den = torch.einsum("blhd,bhd->blh", Q, k_sum)
    z = 1.0 / torch.clamp(den, min=eps)
    out = torch.einsum("blhd,bhde->blhe", Q, kv) * z[..., None] * s
    return out.to(dt).reshape(b, l, c)


def linear_encoder_attention_op(x, source, x_pos, s_pos, lnq, lnkv, wq, wk,
                                wv, q_mask=None, kv_mask=None, nhead: int = 8,
                                eps: float = 1e-6):
    """The unfused sublayer that JAX differentiates for K2 (port of
    ``linear_encoder_attention_xla``): f32 LayerNorm (eps 1e-5) plus the
    positional encoding, cast to x's dtype, the projections in that dtype,
    then the plain ``linear_attention`` (``den + eps``) with both masks
    (all true where None)."""
    dt = x.dtype
    b, l, c = x.shape
    s = source.shape[1]
    q_in = (_layernorm_f32(x, lnq) + x_pos.float()).to(dt)
    kv_in = (_layernorm_f32(source, lnkv) + s_pos.float()).to(dt)
    q = (q_in @ wq.to(dt).T).reshape(b, l, nhead, c // nhead)
    k = (kv_in @ wk.to(dt).T).reshape(b, s, nhead, c // nhead)
    v = (kv_in @ wv.to(dt).T).reshape(b, s, nhead, c // nhead)
    qm = (torch.ones(b, l, dtype=torch.bool, device=x.device)
          if q_mask is None else q_mask.to(torch.bool))
    km = (torch.ones(b, s, dtype=torch.bool, device=x.device)
          if kv_mask is None else kv_mask.to(torch.bool))
    return linear_attention(q, k, v, qm, km, eps=eps).reshape(b, l, c)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _pos_batch_stride(name, pos, b, n, c, dtype, device):
    if pos.dim() != 3 or pos.shape[0] not in (1, b):
        raise ValueError(f"{name}: expected [1 or {b}, {n}, {c}], got "
                         f"{tuple(pos.shape)}")
    _check(name, pos, (pos.shape[0], n, c), dtype, device)
    return 0 if pos.shape[0] == 1 else n * c


def _mask_ptr(name, mask, shape, device):
    if mask is None:
        return None, None
    if tuple(mask.shape) != shape or mask.device != device:
        raise ValueError(f"{name}: expected {shape} on {device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    if mask.dtype != torch.bool or not mask.is_contiguous():
        mask = mask.to(torch.bool).contiguous()
    return mask, mask.data_ptr()


def linear_encoder_attention(x, source, x_pos, s_pos, lnq, lnkv, wq, wk, wv,
                             q_mask=None, kv_mask=None, nhead: int = 8,
                             eps: float = 1e-6):
    """Fused pre-norm + PE + projections + masked linear attention (K2).

    x [B, L, C]; source [B, S, C]; x_pos/s_pos [1 or B, L/S, C] in x's
    dtype; lnq/lnkv [2, C] f32; wq/wk/wv [C, C] f32 in [out, in] layout;
    q_mask [B, L] / kv_mask [B, S] bool or None. Returns [B, L, C] in x's
    dtype. A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (float32 or bfloat16, C a multiple of 32, C/nhead <= 64) or
    raises. In bf16 the kernel reads each weight rounded to bf16 once
    (``_weight_as``). Differentiable as in JAX (module docstring).
    """
    args = (x, source, x_pos, s_pos, lnq, lnkv, wq, wk, wv, q_mask,
            kv_mask, nhead, eps)
    if needs_grad(*args):
        return KernelFunction.apply(_launch, linear_encoder_attention_op,
                                    *args)
    return _launch(*args)


def _launch(x, source, x_pos, s_pos, lnq, lnkv, wq, wk, wv, q_mask, kv_mask,
            nhead, eps):
    """K2's forward: the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return linear_encoder_attention_reference(
            x, source, x_pos, s_pos, lnq, lnkv, wq, wk, wv, q_mask, kv_mask,
            nhead, eps)
    if x.device.type != "cuda":
        raise ValueError(f"linear_encoder_attention: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"linear_encoder_attention: dtype {x.dtype}")
    if x.dim() != 3 or source.dim() != 3:
        raise ValueError("x and source must be [B, N, C]")
    b, l, c = x.shape
    s = source.shape[1]
    if c % nhead != 0 or c // nhead > MAX_HEAD_WIDTH or c % 32 != 0:
        raise ValueError(f"linear_encoder_attention: C={c}, nhead={nhead} "
                         "needs C % 32 == 0 and C / nhead <= "
                         f"{MAX_HEAD_WIDTH}")
    dev = x.device
    _check("x", x, (b, l, c), x.dtype, dev)
    _check("source", source, (b, s, c), x.dtype, dev)
    xps = _pos_batch_stride("x_pos", x_pos, b, l, c, x.dtype, dev)
    sps = _pos_batch_stride("s_pos", s_pos, b, s, c, x.dtype, dev)
    for name, t in (("lnq", lnq), ("lnkv", lnkv)):
        _check(name, t, (2, c), torch.float32, dev)
    for name, t in (("wq", wq), ("wk", wk), ("wv", wv)):
        _check(name, t, (c, c), torch.float32, dev)
    q_mask, qm_ptr = _mask_ptr("q_mask", q_mask, (b, l), dev)
    kv_mask, km_ptr = _mask_ptr("kv_mask", kv_mask, (b, s), dev)
    x, source, x_pos, s_pos, lnq, lnkv = (
        _aligned(t) for t in (x, source, x_pos, s_pos, lnq, lnkv))
    wq, wk, wv = (_aligned(_weight_as(w, x.dtype)) for w in (wq, wk, wv))

    lib, _ = load_library()
    bf16 = x.dtype == torch.bfloat16
    entry = (lib.oetr_linear_encoder_bf16 if bf16
             else lib.oetr_linear_encoder_f32)
    floats = ctypes.c_longlong()
    check_launch(lib, lib.oetr_linear_encoder_workspace(
        int(bf16), b, s, c, nhead, ctypes.byref(floats)),
        "linear_encoder_attention")
    ws = torch.empty(floats.value, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = entry(x.data_ptr(), source.data_ptr(), x_pos.data_ptr(), xps,
                   s_pos.data_ptr(), sps, lnq.data_ptr(), lnkv.data_ptr(),
                   wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), qm_ptr, km_ptr,
                   out.data_ptr(), ws.data_ptr(), ws.numel(), b, l, s, c,
                   nhead, eps, _rounded_inv(s, x.dtype), stream)
    check_launch(lib, rc, "linear_encoder_attention")
    linear_encoder_attention.launches += 1
    return out


linear_encoder_attention.launches = 0
