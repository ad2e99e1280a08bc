"""Nister/Stewenius 5-point minimal essential-matrix solver (port of
``oetr_tpu/geometry/fivepoint.py``).

The solver is the JAX package's float64 numpy code, copied (the port
imports nothing of that package): E = x E1 + y E2 + z E3 + E4 over the
nullspace basis of the 5 epipolar constraints; det(E) = 0 and
2 E Eᵀ E - tr(E Eᵀ) E = 0 give 10 cubics in (x, y, z), whose coefficients
are recovered numerically at 20 fixed generic points through one
precomputed inverse Vandermonde matrix (the same seed); the 10x10 action
matrix of multiplication by x has the solutions as its real eigenpairs.
The nonsymmetric eigensolve runs on the host, as in JAX, where it sits
behind ``jax.pure_callback``. ``five_point_hypotheses`` makes one
device -> host -> device round trip per call for all pairs and samples
(JAX's callback loops over pairs one at a time), and its solver runs
the samples' eigenproblems and projections as stacked LAPACK calls where
JAX's loops over samples in Python.
"""
from __future__ import annotations

import numpy as np
import torch

from .homography import gather_points

# Monomial exponent table: first 10 = degree-3 monomials (the reduced
# set A), last 10 = basis B of the quotient ring (degree <= 2).
_MONOMIALS = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
    (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]

_rng = np.random.default_rng(1234)
_PTS = _rng.normal(size=(20, 3)) * 0.9 + _rng.normal(size=(20, 3)) * 0.1
_V = np.stack([[p[0] ** a * p[1] ** b * p[2] ** c
                for (a, b, c) in _MONOMIALS] for p in _PTS])
_V_INV = np.linalg.inv(_V)


def _constraint_values(E: np.ndarray) -> np.ndarray:
    """The 10 cubic constraint values of E [..., 3, 3] -> [..., 10] (the
    determinant, then the trace constraint)."""
    det = np.linalg.det(E)
    EEt = E @ np.swapaxes(E, -1, -2)
    tr = np.trace(EEt, axis1=-2, axis2=-1)
    C = 2.0 * EEt @ E - tr[..., None, None] * E
    return np.concatenate([det[..., None], C.reshape(E.shape[:-2] + (9,))],
                          axis=-1)


def solve_5pt_batch(bases: np.ndarray):
    """Solve the 5-point problem for nullspace bases [H, 4, 9] (rows E1,
    E2, E3, E4, row-major flattened).

    Returns (E_out [H, 10, 3, 3] float32, valid [H, 10] bool): up to 10
    real solutions per sample, projected onto the essential manifold.
    """
    bases = np.asarray(bases, np.float64)
    h = bases.shape[0]
    Eb = bases.reshape(h, 4, 3, 3)

    coeff = np.concatenate([_PTS, np.ones((20, 1))], axis=1)    # [20, 4]
    E_at = np.einsum("kp,hpij->hkij", coeff, Eb)                # [H,20,3,3]
    F = _constraint_values(E_at)                                # [H,20,10]
    M = np.einsum("mk,hkj->hjm", _V_INV, F)                     # [H,10,20]

    MA, MB = M[:, :, :10], M[:, :, 10:]
    dets = np.abs(np.linalg.det(MA))
    ok_sample = dets > 1e-12
    MA_safe = np.where(ok_sample[:, None, None], MA, np.eye(10)[None])
    X = np.linalg.solve(MA_safe, MB)                            # [H,10,10]

    # Action matrix of multiplication by x on the basis
    # B = [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1].
    T = np.zeros((h, 10, 10))
    T[:, 0:6] = -X[:, 0:6]
    T[:, 6, 0] = 1.0
    T[:, 7, 1] = 1.0
    T[:, 8, 2] = 1.0
    T[:, 9, 6] = 1.0

    E_out = np.zeros((h, 10, 3, 3), np.float32)
    valid = np.zeros((h, 10), bool)
    solved = np.flatnonzero(ok_sample)
    if not len(solved):
        return E_out, valid
    # Stacked LAPACK calls (geev, then gesdd) run on each matrix as they
    # would alone, so this gives JAX's per-sample loop bit for bit.
    lam, W = np.linalg.eig(T[solved])                           # [S,10]
    v = W.real                                  # v[:, :, j]: eigenvector j
    real = np.abs(lam.imag) <= 1e-6 * (1.0 + np.abs(lam.real))
    keep = real & (np.abs(v[:, 9, :]) >= 1e-12)   # finite real solutions
    si, sj = np.nonzero(keep)                 # by sample, roots in order
    x = lam.real[si, sj][:, None, None]
    y = (v[si, 7, sj] / v[si, 9, sj])[:, None, None]
    z = (v[si, 8, sj] / v[si, 9, sj])[:, None, None]
    Eb_s = Eb[solved[si]]
    E = x * Eb_s[:, 0] + y * Eb_s[:, 1] + z * Eb_s[:, 2] + Eb_s[:, 3]
    # Project onto the essential manifold (singular values 1, 1, 0).
    U, _, Vt = np.linalg.svd(E)
    E = (U * np.array([1.0, 1.0, 0.0])) @ Vt
    slot = (np.cumsum(keep, axis=1) - 1)[si, sj]
    E_out[solved[si], slot] = E.astype(np.float32)
    valid[solved[si], slot] = True
    return E_out, valid


def nullspace_bases(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Normalized correspondence samples [H, 5, 2] -> bases [H, 4, 9]."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = np.ones_like(x0)
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                  ones], axis=-1)                               # [H, 5, 9]
    # Right-singular vectors of the 4 smallest singular values.
    _, _, Vt = np.linalg.svd(A)
    return Vt[:, 5:9, :]


def solve_5pt_host(p0, p1):
    """[H, 5, 2] x2 -> (E [H, 10, 3, 3], valid [H, 10]), in numpy."""
    return solve_5pt_batch(nullspace_bases(np.asarray(p0, np.float64),
                                           np.asarray(p1, np.float64)))


def five_point_hypotheses(kpts0n: torch.Tensor, kpts1n: torch.Tensor,
                          idx: torch.Tensor):
    """Gather 5-point samples and solve them on the host.

    kpts0n, kpts1n: [..., N, 2] normalized coordinates; idx [..., H, 5]
    sample indices. Returns (E [..., H*10, 3, 3] float32, valid
    [..., H*10] bool) on the points' device: all the samples go to the
    host in one copy, and the solutions come back at once.
    """
    batch, h = idx.shape[:-2], idx.shape[-2]
    p0 = gather_points(kpts0n, idx).reshape(-1, 5, 2)
    p1 = gather_points(kpts1n, idx).reshape(-1, 5, 2)
    host = torch.stack([p0, p1]).cpu().numpy()
    E, valid = solve_5pt_host(host[0], host[1])
    dev = kpts0n.device
    E = torch.from_numpy(E).to(dev).reshape(batch + (h * 10, 3, 3))
    valid = torch.from_numpy(valid).to(dev).reshape(batch + (h * 10,))
    return E, valid
