"""K1, K5 and K6: the bare attention kernels, with their plain versions.

Port of the first half of ``oetr_tpu/ops/pallas_attention.py``:

* ``linear_attention_cuda`` (K1, ``linear_attention_pallas``): masked
  linear attention, kernel in ``csrc/linear_attention.cu``;
* ``full_attention_cuda`` (K5, ``full_attention_pallas``): whole-row masked
  softmax attention, normalised before it is rounded, kernel in
  ``csrc/full_attention.cu``;
* ``flash_attention_cuda`` (K6, ``flash_attention_pallas``): streaming
  softmax over blocks of ``FLASH_BLOCK_K`` keys with an online max, kernel
  in ``csrc/flash_attention.cu``.

Each takes q [B, L, H, D] and k, v [B, S, H, D] of one dtype, and masks
[B, L] / [B, S] bool (True = a real token) or None. A missing mask is all
true, as ``_prep_masks`` makes it in the JAX package: so with only
``q_mask``, K5 and K6 give 0 on the masked query rows, where the plain
``ops.attention.full_attention`` applies no mask at all.

On a CPU tensor each wrapper runs its ``*_reference``, the plain torch
version of exactly what its kernel computes, rounded to the I/O dtype at
the points where the Pallas kernel rounds. On a CUDA tensor it launches the
kernel (float32 or bfloat16; contiguous; head width up to 64 for K1, 16, 32
or 64 for K5 and K6) or raises. K1 runs a cluster of blocks per (batch
row, head) (``linear_attention_cluster``). K5 and K6 have one kernel design
per dtype: bfloat16 on the tensor cores (mma.sync), float32 on the FP32
pipes. Each wrapper counts its launches in ``.launches``.

Gradients are JAX's (``_with_xla_vjp``): when grad mode is on and q, k or v
requires grad, the wrapper runs through ``autograd.KernelFunction``, whose
backward is torch autograd of the plain op, ``ops.attention.linear_attention``
(``den + eps``) for K1 or ``full_attention`` for K5 and K6, with both masks
(all true where None). The masks get no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, load_library
from .attention import full_attention, linear_attention
from .autograd import KernelFunction, needs_grad
from .linear_encoder import (MAX_HEAD_WIDTH, _check, _elu_p1, _mask_ptr,
                             _rounded_inv)

FLASH_BLOCK_K = 64          # K6's keys per block (csrc/softmax_attention.cuh)
SOFTMAX_HEAD_WIDTHS = (16, 32, 64)
MAX_CLUSTER = 8             # K1's largest cluster (the portable size)


def _masks(q, k, q_mask, kv_mask):
    """Bool [B, L] and [B, S] masks, all true where None."""
    b, l, s = q.shape[0], q.shape[1], k.shape[1]
    qm = (torch.ones(b, l, dtype=torch.bool, device=q.device)
          if q_mask is None else q_mask.to(torch.bool))
    km = (torch.ones(b, s, dtype=torch.bool, device=q.device)
          if kv_mask is None else kv_mask.to(torch.bool))
    return qm, km


def _temp(d: int) -> float:
    return 1.0 / (d ** 0.5)


# ------------------------------------------------------ plain versions --

def linear_attention_reference(q, k, v, q_mask=None, kv_mask=None,
                               eps: float = 1e-6):
    """Plain torch version of K1 (``_linear_attn_kernel``).

    Q = round(elu(q)+1)·qm, K = round(elu(k)+1)·km, V = round(v·km · 1/S)
    with 1/S as the dtype holds it; KV = KᵀV and ΣK in f32, each rounded to
    the dtype; out = round(Q·KV / max(Q·ΣK, eps) · S).
    """
    dt = q.dtype
    s = k.shape[1]
    qm, km = _masks(q, k, q_mask, kv_mask)
    qm = qm.to(dt)[:, :, None, None]
    km = km.to(dt)[:, :, None, None]
    Q = (_elu_p1(q) * qm).float()
    K = (_elu_p1(k) * km).float()
    V = ((v * km).float() * _rounded_inv(s, dt)).to(dt).float()
    kv = torch.einsum("bshd,bshe->bhde", K, V).to(dt).float()
    k_sum = K.sum(dim=1).to(dt).float()                       # [B, H, D]
    den = torch.einsum("blhd,bhd->blh", Q, k_sum)
    z = 1.0 / torch.clamp(den, min=eps)
    out = torch.einsum("blhd,bhde->blhe", Q, kv) * z[..., None] * s
    return out.to(dt)


def _logits(q, k, pair):
    """f32 logits [B, H, L, S'] times 1/sqrt(D), -inf off ``pair``."""
    logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
    logits = logits * _temp(q.shape[-1])
    return logits.masked_fill(~pair, float("-inf"))


def full_attention_reference(q, k, v, q_mask=None, kv_mask=None):
    """Plain torch version of K5 (``_full_attn_kernel``): whole-row
    softmax in f32 with the row max subtracted (0 where no key is visible),
    attn = round(p / max(Σp, 1e-30)), out = round(attn·V) with f32 sums."""
    dt = v.dtype
    qm, km = _masks(q, k, q_mask, kv_mask)
    pair = qm[:, None, :, None] & km[:, None, None, :]          # [B, 1, L, S]
    logits = _logits(q, k, pair)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(pair, torch.exp(logits - m), torch.zeros_like(logits))
    den = p.sum(dim=-1, keepdim=True)
    attn = (p / torch.clamp(den, min=1e-30)).to(dt)
    out = torch.einsum("bhls,bshd->blhd", attn.float(), v.float())
    return out.to(q.dtype)


def flash_attention_reference(q, k, v, q_mask=None, kv_mask=None,
                              block_k: int = FLASH_BLOCK_K):
    """Plain torch version of K6 (``_flash_attn_kernel``): the keys in
    blocks of ``block_k``, a running max, sum and f32 accumulator per row;
    p is rounded to v's dtype relative to the running max before p·V, and
    out = round(acc / max(sum, 1e-30)). Keys past S are simply absent,
    which is what the Pallas kernel's masked zero padding gives."""
    dt = v.dtype
    b, l, h, d = q.shape
    s = k.shape[1]
    qm, km = _masks(q, k, q_mask, kv_mask)
    acc = torch.zeros(b, h, l, d, dtype=torch.float32, device=q.device)
    run_max = torch.full((b, h, l, 1), float("-inf"), device=q.device)
    run_sum = torch.zeros(b, h, l, 1, device=q.device)
    for s0 in range(0, s, block_k):
        blk = slice(s0, min(s, s0 + block_k))
        pair = qm[:, None, :, None] & km[:, None, None, blk]
        logits = _logits(q, k[:, blk], pair)
        new_max = torch.maximum(run_max, logits.amax(dim=-1, keepdim=True))
        safe = torch.where(torch.isfinite(new_max), new_max,
                           torch.zeros_like(new_max))
        corr = torch.where(torch.isfinite(run_max), torch.exp(run_max - safe),
                           torch.zeros_like(run_max))
        p = torch.where(pair, torch.exp(logits - safe),
                        torch.zeros_like(logits))
        pv = torch.einsum("bhls,bshd->bhld", p.to(dt).float(),
                          v[:, blk].float())
        acc = acc * corr + pv
        run_sum = run_sum * corr + p.sum(dim=-1, keepdim=True)
        run_max = new_max
    out = acc / torch.clamp(run_sum, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ------------------------------------------------------------ wrappers --

def _widths_text(widths) -> str:
    if len(widths) > 3:
        return f"{widths[0]}..{widths[-1]}"
    return " or ".join(map(str, widths))


def _check_inputs(name, q, k, v, head_widths):
    """Raise unless q, k, v fit one kernel launch; returns (B, L, S, H, D)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {q.dtype}; the kernel takes float32 "
                         "or bfloat16")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be [B, N, H, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, l, h, d = q.shape
    s = k.shape[1]
    dev = q.device
    _check("q", q, (b, l, h, d), q.dtype, dev)
    _check("k", k, (b, s, h, d), q.dtype, dev)
    _check("v", v, (b, s, h, d), q.dtype, dev)
    if min(b, l, s, h) == 0:
        raise ValueError(f"{name}: empty shape q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d not in head_widths:
        raise ValueError(f"{name}: head width D={d}; the kernel takes "
                         f"{_widths_text(head_widths)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must start 16-byte aligned")
    return b, l, s, h, d


def _run(name, kind, q, k, v, q_mask, kv_mask, head_widths, *extra,
         plan=None):
    """Check, launch the C entry point of ``kind`` ('linear', 'full' or
    'flash') for q's dtype on q's CUDA device, and return the output.
    ``extra`` are the kernel's own arguments after the shape, followed by
    ``plan(B, L, S, H, D)``'s once the inputs are checked."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name}: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; all must be on one CUDA device")
    b, l, s, h, d = _check_inputs(name, q, k, v, head_widths)
    if plan is not None:
        extra += plan(b, l, s, h, d)
    # The contiguous bool masks stay referenced until the launch is queued.
    q_mask, qm_ptr = _mask_ptr("q_mask", q_mask, (b, l), dev)
    kv_mask, km_ptr = _mask_ptr("kv_mask", kv_mask, (b, s), dev)
    lib, _ = load_library()
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    # ctypes resolves the symbol at its first lookup and keeps it.
    entry = getattr(lib, f"oetr_{kind}_attention_{suffix}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), qm_ptr, km_ptr,
                   out.data_ptr(), b, l, s, h, d, *extra,
                   torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, rc, name)
    return out


def _all_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def linear_attention_cluster(bh: int, longer: int,
                             capacity: dict[int, int]) -> int:
    """K1's blocks per (batch row, head), one cluster, for ``bh`` (batch
    row, head) pairs whose longer side has ``longer`` rows: the most of 1,
    2, 4 and 8 whose clusters all fit on the card at once (``capacity``:
    cluster size -> clusters the card holds, as
    cudaOccupancyMaxActiveClusters counts them), each block keeping at
    least 16 rows; 1 where not even that fits one wave."""
    best = 1
    for nc in (2, 4, MAX_CLUSTER):
        if bh <= capacity[nc] and longer >= 16 * nc:
            best = nc
    return best


@functools.cache
def cluster_capacity(index: int, dtype: torch.dtype, d: int) -> dict:
    """Clusters of 1, 2, 4 and 8 K1 blocks at head width ``d`` that CUDA
    device ``index`` holds at once."""
    lib, _ = load_library()
    caps = {}
    with torch.cuda.device(index):
        for nc in (1, 2, 4, MAX_CLUSTER):
            n = ctypes.c_int()
            check_launch(lib, lib.oetr_linear_attention_capacity(
                int(dtype == torch.bfloat16), d, nc, ctypes.byref(n)),
                "linear_attention_cuda")
            caps[nc] = n.value
    return caps


def _linear_launch(q, k, v, q_mask, kv_mask, eps, cluster=None):
    """K1's forward: the kernel on CUDA tensors, with ``cluster`` blocks
    per (batch row, head) (``linear_attention_cluster``'s when None); the
    plain version on CPU tensors."""
    if _all_cpu(q, k, v, q_mask, kv_mask):
        return linear_attention_reference(q, k, v, q_mask, kv_mask, eps)

    def plan(b, l, s, h, d):
        if cluster is not None:
            return (cluster,)
        return (linear_attention_cluster(
            b * h, max(l, s), cluster_capacity(q.device.index or 0, q.dtype,
                                               d)),)

    out = _run("linear_attention_cuda", "linear", q, k, v, q_mask, kv_mask,
               range(1, MAX_HEAD_WIDTH + 1), eps,
               _rounded_inv(k.shape[1], q.dtype), plan=plan)
    linear_attention_cuda.launches += 1
    return out


def _linear_vjp(q, k, v, q_mask, kv_mask, eps):
    """What JAX differentiates for K1: the plain op with both masks, at
    the op's default eps whatever ``eps`` is (``_with_xla_vjp`` passes
    none)."""
    return linear_attention(q, k, v, *_masks(q, k, q_mask, kv_mask))


def _full_launch(q, k, v, q_mask, kv_mask):
    if _all_cpu(q, k, v, q_mask, kv_mask):
        return full_attention_reference(q, k, v, q_mask, kv_mask)
    out = _run("full_attention_cuda", "full", q, k, v, q_mask, kv_mask,
               SOFTMAX_HEAD_WIDTHS, _temp(q.shape[-1]))
    full_attention_cuda.launches += 1
    return out


def _flash_launch(q, k, v, q_mask, kv_mask):
    if _all_cpu(q, k, v, q_mask, kv_mask):
        return flash_attention_reference(q, k, v, q_mask, kv_mask,
                                         FLASH_BLOCK_K)
    out = _run("flash_attention_cuda", "flash", q, k, v, q_mask, kv_mask,
               SOFTMAX_HEAD_WIDTHS, _temp(q.shape[-1]))
    flash_attention_cuda.launches += 1
    return out


def _full_vjp(q, k, v, q_mask, kv_mask):
    """What JAX differentiates for K5 and K6: the plain op, both masks."""
    return full_attention(q, k, v, *_masks(q, k, q_mask, kv_mask))


def _apply(launch, vjp, q, k, v, *rest):
    """``launch(q, k, v, *rest)``, through ``KernelFunction`` when a
    gradient is wanted."""
    if needs_grad(q, k, v):
        return KernelFunction.apply(launch, vjp, q, k, v, *rest)
    return launch(q, k, v, *rest)


def linear_attention_cuda(q, k, v, q_mask=None, kv_mask=None,
                          eps: float = 1e-6):
    """Masked linear attention (K1); same contract as
    ``linear_attention_reference``, with ``max(den, eps)``."""
    return _apply(_linear_launch, _linear_vjp, q, k, v, q_mask, kv_mask, eps)


def full_attention_cuda(q, k, v, q_mask=None, kv_mask=None):
    """Whole-row masked softmax attention (K5); same contract as
    ``full_attention_reference``. bf16 runs on the tensor cores, walking
    64-key tiles twice; f32 on the FP32 pipes, with the key rows staged
    whole in shared memory when they fit its budget, else chunk by
    chunk."""
    return _apply(_full_launch, _full_vjp, q, k, v, q_mask, kv_mask)


def flash_attention_cuda(q, k, v, q_mask=None, kv_mask=None):
    """Streaming masked softmax attention (K6) over blocks of
    ``FLASH_BLOCK_K`` keys; same contract as ``flash_attention_reference``
    at that block size."""
    return _apply(_flash_launch, _full_vjp, q, k, v, q_mask, kv_mask)


linear_attention_cuda.launches = 0
full_attention_cuda.launches = 0
flash_attention_cuda.launches = 0
