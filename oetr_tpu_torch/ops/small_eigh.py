"""Batched eigendecomposition of small symmetric matrices, and the 3x3 SVD
built on it: the linear algebra of the pose estimator.

JAX's estimator takes null vectors from ``jnp.linalg.eigh`` of 9x9 normal
matrices (``oetr_tpu/geometry/ransac.py:52``, ``homography.py:52``) and
decomposes 3x3 matrices with ``jnp.linalg.svd``. On a CUDA tensor
``torch.linalg.eigh`` and ``torch.linalg.svd`` check their status codes
with a device-to-host copy on every call (they have no ``_ex`` form), so
the estimator would wait on the card some twenty times a call. Here
``eigh`` launches ``csrc/small_eigh.cu`` instead, and reads nothing back:
parallel Jacobi in float32 with n fixed at compile time, a group of
n + n % 2 lanes a matrix for n >= 4 (one thread for n <= 3), the pairs in
a round-robin order (``jacobi_rounds``). ``eigh_jacobi_reference`` is
that algorithm in plain torch, for the tests.

On a CPU tensor both run their plain version: LAPACK's ``syevd`` and
``gesdd``, the routines JAX calls on the CPU, from the LAPACK that jaxlib
loads (scipy's). The f32 normal matrices of minimal 8-point samples are
nearly singular, so their null vectors move with the last bit of the
arithmetic: with the same routine, the CPU run gives JAX's eigenvectors
bit for bit (``torch.linalg.eigh`` on the CPU, MKL's, does not). On a CUDA
tensor ``svd3`` is ``svd3_from_eigh``: the eigenvectors of AᵀA through
the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ._build import check_launch, load_library

MAX_N = 16
# The kernel's sweep cap (``kMaxSweeps``): a NaN or an overflow ends there.
MAX_SWEEPS = 50


def _lapack(A: torch.Tensor, name: str):
    """LAPACK's ``name`` ('syevd' or 'gesdd'; s- or d- by A's dtype) on
    each matrix of a CPU tensor [..., n, n]: (w, V) or (U, S, Vh) as CPU
    tensors of A's batch shape."""
    from scipy.linalg import lapack

    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64, got {A.dtype}")
    fn = getattr(lapack, ("s" if A.dtype == torch.float32 else "d") + name)
    n, batch = A.shape[-1], A.shape[:-2]
    a = A.detach().contiguous().numpy().reshape(-1, n, n)
    if name == "syevd":
        shapes = [(n,), (n, n)]
        kwargs = {"lower": 1}
    else:
        shapes = [(n, n), (n,), (n, n)]
        kwargs = {"compute_uv": 1, "full_matrices": 1}
    outs = [np.empty((len(a),) + shape, a.dtype) for shape in shapes]
    for k, m in enumerate(a):
        *res, info = fn(m, **kwargs)
        if info != 0:
            raise RuntimeError(f"LAPACK {name}: info {info}")
        for out, r in zip(outs, res):
            out[k] = r
    return tuple(torch.from_numpy(out).reshape(batch + shape)
                 for out, shape in zip(outs, shapes))


def eigh_reference(A: torch.Tensor):
    """The plain version of ``eigh``, for a CPU tensor: LAPACK's syevd on
    the lower triangle (eigenvalues ascending, eigenvectors as V's
    columns)."""
    return _lapack(A, "syevd")


def jacobi_rounds(n: int) -> list[list[tuple[int, int]]]:
    """The kernel's order of pairs for n x n: the circle method on m = n +
    n % 2 indices, m - 1 rounds of m / 2 disjoint pairs (slot 0 of round r
    pairs m - 1 with r, slot k pairs (r + k) and (r - k) mod (m - 1)), each
    pair as (p, q) with p < q; pairs of the padding index n are left out."""
    m = n + n % 2
    rounds = []
    for r in range(m - 1):
        pairs = []
        for k in range(m // 2):
            a, b = ((m - 1, r) if k == 0 else
                    ((r + k) % (m - 1), (r - k) % (m - 1)))
            if max(a, b) < n:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return rounds


def _rotation(app, aqq, apq):
    """The kernel's ``rotation``: (c, s, t, rotates) of each pair: the
    identity where a_pq is negligible beside both diagonal entries; t =
    a_pq / h, c = 1 where |h| = |a_qq - a_pp| dwarfs a_pq; else, with θ =
    h / (2 a_pq) and d = |θ| + sqrt(θ² + 1), t = sgn θ / d, c = d e, s =
    sgn θ e for e = 1 / sqrt(d² + 1)."""
    g = 100 * apq.abs()
    negligible = (app.abs() + g == app.abs()) & (aqq.abs() + g == aqq.abs())
    h = aqq - app
    small = h.abs() + g == h.abs()
    t_small = apq / h
    theta = 0.5 * h / apq
    r2 = theta * theta + 1
    d = theta.abs() + r2 * torch.rsqrt(r2)
    x = d * d + 1
    e = torch.rsqrt(x)
    e = 0.5 * e * (1 - x * e * e) + e
    sgn = torch.where(theta < 0, -1.0, 1.0)
    one, zero = torch.ones_like(h), torch.zeros_like(h)
    c = torch.where(negligible | small, one, d * e)
    s = torch.where(negligible, zero, torch.where(small, t_small, sgn * e))
    t = torch.where(negligible, zero, torch.where(small, t_small, sgn / d))
    return c, s, t, ~negligible


def eigh_jacobi_reference(A: torch.Tensor):
    """The kernel's algorithm in plain torch, float32, for the tests: the
    lower triangle mirrored; sweeps of ``jacobi_rounds(n)``, each round's
    rotations taken from the matrix as the round found it, applied to the
    rows (Jᵀ A), then to the columns (A J and V J); a_pq set to 0 and the
    diagonal to a_pp - t a_pq, a_qq + t a_pq; until a sweep rotates no pair
    of any matrix with finite entries (a finished matrix meets identity
    rotations only), at most MAX_SWEEPS. Eigenvalues ascending (ties by
    index), NaN in w and V for a matrix with a non-finite entry. Returns
    (w [..., n], V [..., n, n]) as ``eigh``."""
    n, shape = A.shape[-1], A.shape[:-2]
    low = torch.tril(A.detach().float().cpu())
    a = (low + torch.tril(low, -1).transpose(-1, -2)).reshape(-1, n, n)
    v = torch.eye(n).expand(a.shape[0], n, n).clone()
    bad = ~torch.isfinite(a).all(-1).all(-1)
    rounds = [(torch.tensor([p for p, _ in pairs]),
               torch.tensor([q for _, q in pairs]))
              for pairs in jacobi_rounds(n) if pairs]
    for _ in range(MAX_SWEEPS):
        rotated = torch.zeros_like(bad)
        for P, Q in rounds:
            app, aqq, apq = a[:, P, P], a[:, Q, Q], a[:, P, Q]
            c, s, t, rot = _rotation(app, aqq, apq)
            rotated |= rot.any(-1)
            cr, sr = c[..., None], s[..., None]
            ap, aq = a[:, P, :], a[:, Q, :]
            a[:, P, :], a[:, Q, :] = cr * ap - sr * aq, sr * ap + cr * aq
            cc, sc = c[:, None, :], s[:, None, :]
            for m in (a, v):
                mp, mq = m[:, :, P], m[:, :, Q]
                m[:, :, P], m[:, :, Q] = cc * mp - sc * mq, sc * mp + cc * mq
            a[:, P, Q] = 0.0
            a[:, Q, P] = 0.0
            a[:, P, P], a[:, Q, Q] = app - t * apq, aqq + t * apq
        if not bool((rotated & ~bad).any()):
            break
    w = torch.diagonal(a, dim1=-2, dim2=-1) + 0.0
    w, order = torch.sort(w, dim=-1, stable=True)
    V = torch.gather(v, -1, order[:, None, :].expand_as(v))
    w[bad], V[bad] = float("nan"), float("nan")
    return w.reshape(shape + (n,)), V.reshape(shape + (n, n))


def eigh(A: torch.Tensor):
    """(w [..., n], V [..., n, n]) of symmetric A [..., n, n], as
    ``torch.linalg.eigh``: eigenvalues ascending, eigenvectors as columns
    (each up to sign), the lower triangle read.

    A CPU tensor runs the plain version (LAPACK). A CUDA tensor (float32,
    n <= 16) launches the Jacobi kernel, one launch a call, or raises.
    """
    if A.device.type == "cpu":
        return eigh_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"eigh: no kernel for {A.device}")
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"eigh: needs [..., n, n] with n <= {MAX_N}, got "
                         f"{tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"eigh: the kernel takes float32, got {A.dtype}")
    A = A.contiguous()
    batch = A.numel() // (n * n)
    w = torch.empty(A.shape[:-1], dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    if batch == 0:
        return w, V
    lib, _ = load_library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.oetr_sym_eigh_f32(A.data_ptr(), w.data_ptr(), V.data_ptr(),
                                   batch, n, stream)
    check_launch(lib, rc, "eigh")
    _WRAPPER.launches += 1
    return w, V


# The count lives on the wrapper; _WRAPPER keeps it reachable where a
# caller has put a recording function in this module's ``eigh``.
eigh.launches = 0
_WRAPPER = eigh


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-30)


def svd3_from_eigh(A: torch.Tensor):
    """(U, S, Vh) of A [..., 3, 3] from ``eigh`` of AᵀA: S the square roots
    of its eigenvalues, descending; V its eigenvectors; u1 and u2 the unit
    A v1 and A v2 (u2 made orthogonal to u1), u3 = u1 x u2, and v3's sign
    set so that A v3 lies along u3. So U is a rotation and A = U S Vh; a
    singular vector of a repeated or zero singular value is one of many,
    as in any SVD."""
    w, V = eigh(A.transpose(-1, -2) @ A)
    w, V = w.flip(-1), V.flip(-1)
    S = torch.sqrt(torch.clamp(w, min=0.0))
    AV = A @ V
    u1 = _unit(AV[..., 0])
    a2 = AV[..., 1]
    u2 = _unit(a2 - torch.sum(u1 * a2, dim=-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2)
    flip = torch.where(torch.sum(AV[..., 2] * u3, dim=-1) < 0, -1.0, 1.0)
    V = torch.cat([V[..., :2], V[..., 2:] * flip[..., None, None]], dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, S, V.transpose(-1, -2)


def svd3(A: torch.Tensor):
    """(U, S, Vh) of A [..., 3, 3]: LAPACK's gesdd on a CPU tensor; on a
    CUDA tensor ``svd3_from_eigh``, through the eigh kernel."""
    if A.device.type == "cpu":
        return _lapack(A, "gesdd")
    return svd3_from_eigh(A)
