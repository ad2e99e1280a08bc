"""Log-domain Sinkhorn optimal transport with dustbins, and K4.

Port of ``oetr_tpu/ops/sinkhorn.py``: SuperGlue's matching core. The score
matrix gets a dustbin row and column, padded keypoints carry the finite
``NEG_INF`` sentinel and no mass, and the iterations run in float32 whatever
the model's dtype.

``log_sinkhorn_cuda`` is the port of
``oetr_tpu/ops/pallas_sinkhorn.py::log_sinkhorn_pallas`` (K4): on a CUDA
tensor it launches the hand-written kernel in ``csrc/log_sinkhorn.cu``, one
cooperative launch per group of pairs that ``sinkhorn_plan`` fits into the
grid's shared memory; a CPU tensor runs ``log_sinkhorn``, the plain torch
version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import check_launch, load_library
from .autograd import needs_grad

NEG_INF = -1e9
NO_BACKWARD = ("log_sinkhorn_cuda: the kernel has no backward (nor has "
               "JAX's Pallas Sinkhorn); call log_sinkhorn for gradients, or "
               "run under torch.no_grad()")
# csrc/log_sinkhorn.cu's kStaticSmem: its merge step's (m, s) of 32 slices
# x 16 columns (rows padded to 17), f32.
_STATIC_SMEM = 2 * 32 * 17 * 4


class SinkhornPlan(NamedTuple):
    """How K4 lays [B, M, N] pairs over a grid of one block per SM."""
    pairs_per_launch: int
    blocks_per_pair: int
    rows_per_block: int      # the slab of rows a block owns
    resident_rows: int       # of those, the rows kept in shared memory
    launches: int
    smem_bytes: int          # shared memory a block asks for

    def workspace_floats(self, sms: int, n: int) -> int:
        """The kernel's scratch in f32 units: 8-byte words, the column
        partials [SMs, N], then v [pairs, N]."""
        return 2 * (sms + self.pairs_per_launch) * n


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def sinkhorn_smem_bytes(n: int, rows: int, resident: int) -> int:
    """Shared memory of one K4 block: v [N], u [rows], the seeds of its
    columns [N] and rows [rows], 16 bytes to align the slab with its rows in
    global memory, the resident rows, the merge's scratch. The kernel's
    ``dynamic_smem`` + ``kStaticSmem``."""
    return (2 * (_align16(4 * n) + _align16(4 * rows)) + 16
            + 4 * resident * n + _STATIC_SMEM)


@functools.cache
def sinkhorn_plan(b: int, m: int, n: int, sms: int,
                  smem_per_block: int) -> SinkhornPlan:
    """K4's launch plan for B pairs of [M, N] on ``sms`` SMs with
    ``smem_per_block`` bytes of opt-in shared memory a block.

    Pairs per launch: the most whose slabs all fit in shared memory (at
    most B and one block a pair), evened out over the launches. Each pair
    gets SMs // pairs blocks, each a slab of ceil(M / blocks) rows. Where
    even one pair does not fit, a block keeps as many of its rows as fit
    (``resident_rows``) and reads the rest from global memory on each pass.
    Raises ValueError if not even v and u fit.
    """
    def rows_for(pairs):
        return -(-m // (sms // pairs))

    fits = [p for p in range(1, min(b, sms) + 1)
            if sinkhorn_smem_bytes(n, rows_for(p), rows_for(p))
            <= smem_per_block]
    most = max(fits, default=1)
    launches = -(-b // most)
    pairs = -(-b // launches)
    rows = rows_for(pairs)
    fixed = sinkhorn_smem_bytes(n, rows, 0)
    if fixed > smem_per_block:
        raise ValueError(f"log_sinkhorn_cuda: N = {n} needs {fixed} bytes "
                         f"of shared memory a block, over {smem_per_block}")
    resident = min(rows, (smem_per_block - fixed) // (4 * n))
    return SinkhornPlan(pairs, sms // pairs, rows, resident, launches,
                        sinkhorn_smem_bytes(n, rows, resident))


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory a block) of CUDA device ``index``,
    read by the runtime (cudaDeviceGetAttribute)."""
    lib, _ = load_library()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        rc = lib.oetr_device_limits(ctypes.byref(sms), ctypes.byref(smem))
    check_launch(lib, rc, "device_limits")
    return sms.value, smem.value


def log_sinkhorn(log_cost: torch.Tensor, log_mu: torch.Tensor,
                 log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """Sinkhorn iterations in log space, plain torch.

    log_cost: [B, M, N]; log_mu: [B, M]; log_nu: [B, N]. Returns the
    [B, M, N] log transport plan C + u + v.
    """
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(log_cost + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(log_cost + u[:, :, None], dim=1)
    return log_cost + u[:, :, None] + v[:, None, :]


def log_sinkhorn_cuda(log_cost: torch.Tensor, log_mu: torch.Tensor,
                      log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """``log_sinkhorn`` as one kernel call (K4), same contract.

    A CPU tensor runs the plain version. On the card every input must be
    float32, contiguous and on the same CUDA device; anything else raises.
    The kernel has no backward, as JAX's Pallas Sinkhorn has none: on the
    card, with grad mode on and an input that requires grad, it raises
    rather than hand autograd a constant.
    """
    tensors = (log_cost, log_mu, log_nu)
    if all(t.device.type == "cpu" for t in tensors):
        return log_sinkhorn(log_cost, log_mu, log_nu, iters)
    if needs_grad(*tensors):
        raise RuntimeError(NO_BACKWARD)
    if any(t.device != log_cost.device or t.device.type != "cuda"
           for t in tensors):
        raise ValueError("log_sinkhorn_cuda: inputs on "
                         f"{[str(t.device) for t in tensors]}; all must be on "
                         "one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("log_sinkhorn_cuda: dtype "
                         f"{[t.dtype for t in tensors]}; the kernel takes "
                         "float32 only")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("log_sinkhorn_cuda: inputs must be contiguous")
    if log_cost.dim() != 3:
        raise ValueError(f"log_sinkhorn_cuda: log_cost must be [B, M, N], "
                         f"got {tuple(log_cost.shape)}")
    b, m, n = log_cost.shape
    if tuple(log_mu.shape) != (b, m) or tuple(log_nu.shape) != (b, n):
        raise ValueError(f"log_sinkhorn_cuda: log_mu {tuple(log_mu.shape)} "
                         f"and log_nu {tuple(log_nu.shape)} do not fit "
                         f"log_cost {tuple(log_cost.shape)}")
    if min(b, m, n) == 0 or iters < 0:
        raise ValueError(f"log_sinkhorn_cuda: empty shape {(b, m, n)} or "
                         f"iters {iters}")
    lib, _ = load_library()
    sms, smem = device_limits(log_cost.device.index)
    plan = sinkhorn_plan(b, m, n, sms, smem)
    out = torch.empty_like(log_cost)
    work = torch.empty(plan.workspace_floats(sms, n), dtype=torch.float32,
                       device=log_cost.device)
    stream = torch.cuda.current_stream(log_cost.device).cuda_stream
    with torch.cuda.device(log_cost.device):
        rc = lib.oetr_log_sinkhorn_f32(
            log_cost.data_ptr(), log_mu.data_ptr(), log_nu.data_ptr(),
            out.data_ptr(), work.data_ptr(), b, m, n, iters,
            plan.pairs_per_launch, plan.rows_per_block, plan.resident_rows,
            stream)
    check_launch(lib, rc, "log_sinkhorn_cuda")
    log_sinkhorn_cuda.launches += 1
    return out


log_sinkhorn_cuda.launches = 0


def augment_scores(scores: torch.Tensor, alpha, mask0=None, mask1=None):
    """The Sinkhorn problem of SuperGlue's partial transport.

    scores [B, M, N] (cast to float32); alpha the dustbin score; masks
    [B, M] / [B, N] bool. Returns (aug [B, M+1, N+1], log_mu [B, M+1],
    log_nu [B, N+1], norm [B]): masked entries hold ``NEG_INF``, each valid
    keypoint has mass 1, each dustbin the other side's count, all
    normalised by ms + ns.
    """
    b, m, n = scores.shape
    scores = scores.float()
    dev = scores.device
    if mask0 is None:
        mask0 = torch.ones((b, m), dtype=torch.bool, device=dev)
    if mask1 is None:
        mask1 = torch.ones((b, n), dtype=torch.bool, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    pair = mask0[:, :, None] & mask1[:, None, :]
    scores = torch.where(pair, scores, neg)

    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    bins0 = torch.where(mask0, alpha, neg)[:, :, None]          # [B, M, 1]
    bins1 = torch.where(mask1, alpha, neg)[:, None, :]          # [B, 1, N]
    corner = alpha.expand(b, 1, 1)
    aug = torch.cat([torch.cat([scores, bins0], dim=2),
                     torch.cat([bins1, corner], dim=2)], dim=1)

    ms = mask0.sum(dim=1).float()
    ns = mask1.sum(dim=1).float()
    norm = -torch.log(torch.clamp(ms + ns, min=1.0))
    log_mu = torch.cat([torch.where(mask0, norm[:, None], neg),
                        (torch.log(torch.clamp(ns, min=1e-9)) + norm)[:, None]],
                       dim=1)
    log_nu = torch.cat([torch.where(mask1, norm[:, None], neg),
                        (torch.log(torch.clamp(ms, min=1e-9)) + norm)[:, None]],
                       dim=1)
    return aug, log_mu, log_nu, norm


def log_optimal_transport(scores: torch.Tensor, alpha, iters: int,
                          mask0=None, mask1=None,
                          use_cuda: bool = False) -> torch.Tensor:
    """SuperGlue-style partial optimal transport with dustbins.

    scores [B, M, N]; alpha the scalar dustbin score; masks [B, M] / [B, N]
    bool. ``use_cuda`` runs the iterations through ``log_sinkhorn_cuda``
    (K4). Returns the [B, M+1, N+1] float32 log assignment.
    """
    aug, log_mu, log_nu, norm = augment_scores(scores, alpha, mask0, mask1)
    sinkhorn = log_sinkhorn_cuda if use_cuda else log_sinkhorn
    return sinkhorn(aug, log_mu, log_nu, iters) - norm[:, None, None]


def extract_matches(log_assignment: torch.Tensor, threshold: float,
                    mask0=None, mask1=None):
    """Mutual-argmax match extraction from the transport plan.

    log_assignment [B, M+1, N+1]. Returns matches0 [B, M] and matches1
    [B, N] (int64, -1 unmatched), mscores0 [B, M] and mscores1 [B, N].
    torch.argmax, like jnp.argmax, returns the first maximum.
    """
    probs = torch.exp(log_assignment[:, :-1, :-1])
    b, m, n = probs.shape
    max0 = probs.amax(dim=2)
    max1 = probs.amax(dim=1)
    idx0 = probs.argmax(dim=2)
    idx1 = probs.argmax(dim=1)
    arange_m = torch.arange(m, device=probs.device)[None, :]
    arange_n = torch.arange(n, device=probs.device)[None, :]
    mutual0 = torch.gather(idx1, 1, idx0) == arange_m
    mutual1 = torch.gather(idx0, 1, idx1) == arange_n

    valid0 = mutual0 & (max0 > threshold)
    if mask0 is not None:
        valid0 = valid0 & mask0
    valid1 = mutual1 & torch.gather(valid0, 1, idx1)
    if mask1 is not None:
        valid1 = valid1 & mask1
    minus1 = torch.tensor(-1, dtype=idx0.dtype, device=probs.device)
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)
    matches0 = torch.where(valid0, idx0, minus1)
    matches1 = torch.where(valid1, idx1, minus1)
    mscores0 = torch.where(valid0, max0, zero)
    mscores1 = torch.where(valid1, max1, zero)
    return matches0, matches1, mscores0, mscores1
