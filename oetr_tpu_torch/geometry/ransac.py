"""Batched LO-RANSAC essential matrices and pose recovery (port of
``oetr_tpu/geometry/ransac.py``).

The estimator evaluates a fixed budget of minimal hypotheses at once,
scores each against every correspondence with a masked Sampson residual,
refits the best on their inliers (LO-RANSAC), refines them by Gauss-Newton
on the essential manifold (in float64; float32 keeps them, as JAX's float32
refinement does), and picks the winner by cheirality-checked
MSAC score; ``estimate_pose`` adds the planar and plane-and-parallax
fallback. Static shapes throughout, as in JAX.

Where JAX's function is vmapped over pairs, the port's takes the pairs as
leading batch dimensions: points [..., N, 2], masks [..., N], intrinsics
[..., 3, 3]. It runs where its inputs lie. On the card it never waits on
the device: the null vectors and 3x3 SVDs go through ``ops.eigh`` (the
Jacobi kernel; ``torch.linalg.eigh`` and ``svd`` read a status back on
every call), the 5x5 solves through ``torch.linalg.solve_ex`` unchecked,
and constants are made on the device. The one exception is the 5-point
stage, which solves on the host, as JAX does (``use_5pt``; off by default
on the card, as JAX's is off on an accelerator). Its random numbers come
from an explicit ``torch.Generator`` through ``draws.gumbel``, one
Gumbel tensor per stage, of the shapes JAX draws.
"""
from __future__ import annotations

import torch

from ..ops.small_eigh import eigh, svd3
from . import draws
from .epipolar import sampson_error, skew, to_homogeneous
from .fivepoint import five_point_hypotheses
from .homography import (gather_points, per_pair, ransac_homography,
                         sample_minimal_sets)

PARALLAX_CANDIDATES = 16
# The slots of estimate_pose's planar vote, in order: the homography's 4
# decompositions, the plane-and-parallax candidates, the E route's pose.
VOTE_ROUTES = ("H",) * 4 + ("P&P",) * PARALLAX_CANDIDATES + ("E",)


def _pick(x: torch.Tensor, i: torch.Tensor, rest: int) -> torch.Tensor:
    """x [..., K, *s] (s of ``rest`` dims, ``...`` = i's shape) at the
    index i [...] -> [..., *s]."""
    tail = x.shape[x.dim() - rest:] if rest else ()
    x = x.expand(i.shape + x.shape[x.dim() - rest - 1:])
    idx = i.reshape(i.shape + (1,) * (rest + 1)).expand(i.shape + (1,) + tail)
    return torch.gather(x, i.dim(), idx).squeeze(i.dim())


def _take(x: torch.Tensor, idx: torch.Tensor, rest: int) -> torch.Tensor:
    """x [..., K, *s] at the indices idx [..., C] -> [..., C, *s]."""
    tail = x.shape[x.dim() - rest:] if rest else ()
    full = idx.reshape(idx.shape + (1,) * rest).expand(idx.shape + tail)
    return torch.gather(x, idx.dim() - 1, full)


def _det3(M: torch.Tensor) -> torch.Tensor:
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :],
                                                        M[..., 2, :]), -1)


def _s110(like: torch.Tensor) -> torch.Tensor:
    """[1, 1, 0] in like's dtype, on its device."""
    return (torch.arange(3, device=like.device) < 2).to(like.dtype)


def essential_8pt(kpts0: torch.Tensor, kpts1: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted 8-point essential matrices [..., 3, 3] from normalized
    correspondences [..., N, 2] (weights [..., N], 0 leaves a row out): the
    null vector of the constraint rows [x1x0, x1y0, x1, y1x0, y1y0, y1, x0,
    y0, 1] by eigh of AᵀA, projected onto the essential manifold
    (singular values 1, 1, 0)."""
    x0, y0 = kpts0[..., 0], kpts0[..., 1]
    x1, y1 = kpts1[..., 0], kpts1[..., 1]
    ones = torch.ones_like(x0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     ones], dim=-1)
    if weights is not None:
        A = A * weights[..., None]
    _, V = eigh(A.transpose(-1, -2) @ A)
    E = V[..., :, 0].reshape(V.shape[:-2] + (3, 3))
    U, _, Vh = svd3(E)
    return (U * _s110(E)) @ Vh


class _Div(torch.autograd.Function):
    """a / b, differentiated by JAX's rule for division (``lax.div``): the
    JVP g_a / b + (-g_b · a) · b⁻², and for the VJP its transpose. Torch's
    own rule, (g_a - g_b · (a / b)) / b, never forms b⁻²; JAX's does, and
    where b² overflows its tangent is 0 · inf = NaN, not a number."""
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return a / b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, a_t, b_t):
        a, b = ctx.saved_tensors
        return a_t / b + (-b_t * a) * b ** -2

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return g / b, (-g * a) * b ** -2


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' exponential [..., 3] -> [..., 3, 3], safe at ||w|| -> 0
    under differentiation (no norm of an exactly zero vector).

    Its two divisions are differentiated as ``jax.jacfwd`` differentiates
    JAX's (``_Div``), so forward-mode AD gives JAX's Jacobian: at w = 0 in
    float32, (1 - cos θ)/θ² with θ = 1e-12 forms θ⁻⁴ = inf, and every
    entry of the Jacobian, the translation's columns of a camera's too, is
    NaN (``sfm/ba.py`` copies what that does to bundle adjustment)."""
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(th2 + 1e-24)
    K = skew(w)
    A = _Div.apply(torch.sin(th), th)[..., None, None]
    B = _Div.apply(1.0 - torch.cos(th), th * th)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * (K @ K)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] orthonormal bases of the planes orthogonal to unit t."""
    near_x = torch.abs(t[..., 0]) < 0.9
    a = torch.stack([near_x, ~near_x, torch.zeros_like(near_x)],
                    dim=-1).to(t.dtype)
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def signed_sampson(kpts0: torch.Tensor, kpts1: torch.Tensor,
                   E: torch.Tensor) -> torch.Tensor:
    """First-order signed Sampson residual [..., N]: the square root of
    ``sampson_error`` with the sign of x1ᵀ E x0."""
    h0 = to_homogeneous(kpts0)
    h1 = to_homogeneous(kpts1)
    Ep0 = h0 @ E.transpose(-1, -2)
    Etp1 = h1 @ E
    num = torch.sum(h1 * Ep0, dim=-1)
    den = torch.sqrt(torch.clamp(
        Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2 + Etp1[..., 0] ** 2
        + Etp1[..., 1] ** 2, min=1e-18))
    return num / den


def _residuals(p, R, t, basis, w, kpts0n, kpts1n):
    """The weighted signed Sampson residuals of (R, t) moved by p [..., 5]:
    R exp([p0:3]) and t + basis p[3:5], renormalized."""
    Rn = R @ so3_exp(p[..., :3])
    tn = t + (basis @ p[..., 3:, None])[..., 0]
    tn = tn / torch.sqrt(torch.sum(tn * tn, dim=-1, keepdim=True) + 1e-24)
    return w * signed_sampson(kpts0n, kpts1n, skew(tn) @ Rn)


def refine_pose_sampson(R: torch.Tensor, t: torch.Tensor,
                        kpts0n: torch.Tensor, kpts1n: torch.Tensor,
                        thresh_sq, valid: torch.Tensor | None = None,
                        iters: int = 15, damping: float = 1e-10):
    """Gauss-Newton refinement of (R [..., 3, 3], t [..., 3]) on the
    essential manifold: 5 parameters (the so3 tangent of R, the 2-D tangent
    of the unit sphere at t), inliers re-selected at twice the threshold
    every step, and a step kept only where it does not lower the MSAC
    score. kpts [..., N, 2], thresh_sq and valid [..., N] broadcast to R's
    batch.

    The Jacobian is forward-mode AD of the residuals at p = 0, as JAX's
    ``jax.jacfwd``: the five JVPs along the unit directions, evaluated in
    one ``torch.func.jvp`` call over a leading axis of 5. It is taken
    outside inference mode: under ``torch.inference_mode`` forward-mode AD
    is off, and torch (2.11) returns zero tangents without a word, which
    would leave (R, t) where they started.

    In float32 it returns (R, t) as they are, which is what JAX's float32
    refinement returns: its ``jax.jacfwd`` Jacobian through ``so3_exp``
    (``oetr_tpu/geometry/ransac.py:137``, ``:75``) forms (1 - cos θ)/θ² at
    θ = 1e-12, whose θ⁻⁴ overflows float32, so the whole Jacobian is NaN
    and every step is rejected. The port's Jacobian is that NaN too
    (``so3_exp``), so the early return only skips the 15 rejected steps.
    Float64 takes the Gauss-Newton steps, as JAX's does under x64.
    """
    if R.dtype == torch.float32:
        return R, t
    batch = R.shape[:-2]
    n = kpts0n.shape[-2]
    k0 = kpts0n.expand(batch + (n, 2))
    k1 = kpts1n.expand(batch + (n, 2))
    vmask = (torch.ones(batch + (n,), dtype=torch.bool, device=R.device)
             if valid is None else valid.expand(batch + (n,)))
    ts = per_pair(thresh_sq, batch, R)[..., None]
    dt = R.dtype
    with torch.inference_mode(False):
        eye5 = torch.eye(5, dtype=dt, device=R.device)
        p0 = torch.zeros((5,) + batch + (5,), dtype=dt, device=R.device)
        dirs = eye5.reshape((5,) + (1,) * len(batch) + (5,)).expand(p0.shape)

    for _ in range(iters):
        e = sampson_error(k0, k1, skew(t) @ R)
        w = ((e < 4.0 * ts) & vmask).to(dt)
        basis = _tangent_basis(t)
        with torch.inference_mode(False):
            r5, dr = torch.func.jvp(
                lambda p: _residuals(p, R, t, basis, w, k0, k1), (p0,),
                (dirs,))
        r = r5[0]                                       # [..., N]
        J = torch.movedim(dr, 0, -1)                    # [..., N, 5]
        JTJ = J.transpose(-1, -2) @ J + damping * eye5
        rhs = J.transpose(-1, -2) @ r[..., None]
        delta = -torch.linalg.solve_ex(JTJ, rhs, check_errors=False)[0][..., 0]
        Rn = R @ so3_exp(delta[..., :3])
        tn = t + (basis @ delta[..., 3:, None])[..., 0]
        tn = tn / torch.linalg.norm(tn, dim=-1, keepdim=True)
        # Keep a step only where it does not lower the MSAC (truncated
        # quadratic) score, which keeps discriminating within a fixed
        # consensus set.
        e_new = sampson_error(k0, k1, skew(tn) @ Rn)
        s_new = torch.where(vmask, torch.clamp(1.0 - e_new / ts, min=0.0),
                            0.0).sum(-1)
        s_old = torch.where(vmask, torch.clamp(1.0 - e / ts, min=0.0),
                            0.0).sum(-1)
        better = s_new >= s_old
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn, t)
    return R, t


def _msac_counts(errs, thresh_sq, valid):
    """MSAC scores [..., H] of errors [..., H, N]: the sum over valid slots
    of max(1 - err / thresh², 0)."""
    return torch.where(valid[..., None, :],
                       torch.clamp(1.0 - errs / thresh_sq[..., None, None],
                                   min=0.0), 0.0).sum(-1)


def ransac_essential(kpts0n: torch.Tensor, kpts1n: torch.Tensor,
                     valid: torch.Tensor, threshold,
                     generator: torch.Generator,
                     num_hypotheses: int = 512, lo_candidates: int = 8,
                     use_5pt: bool | None = None):
    """Fixed-budget parallel LO-RANSAC for the essential matrix.

      1. ``num_hypotheses`` 8-point fits, MSAC-scored against every
         correspondence (Sampson residual);
      2. (``use_5pt``) ``max(num_hypotheses // 4, 32)`` 5-point samples,
         up to 10 solutions each, solved on the host;
      3. ``num_hypotheses // 2`` 8-point fits sampled from the best
         consensus set so far, where it has >= 16 points (LO-RANSAC inner
         sampling);
      4. the ``lo_candidates`` best of all: three weighted 8-point refits
         on their inliers, recover_pose, Gauss-Newton refinement;
      5. the best by cheirality-masked MSAC score wins.

    Args:
      kpts0n, kpts1n: [..., N, 2] normalized coordinates (padded).
      valid: [..., N] bool mask of real correspondences.
      threshold: inlier threshold on the Sampson distance (normalized
        units, squared inside), a float or a tensor of the batch shape.
      generator: the draws of stages ``round1``, ``round2`` and
        ``five_point`` come from it (``draws.gumbel``).
      use_5pt: None runs the 5-point stage on a CPU tensor and not on the
        card (JAX's rule: on for a host backend).

    Returns dict: E [..., 3, 3], R [..., 3, 3], t [..., 3], inliers
    [..., N], num_inliers, score.
    """
    if use_5pt is None:
        use_5pt = kpts0n.device.type == "cpu"
    batch, n = kpts0n.shape[:-2], kpts0n.shape[-2]
    tsq = per_pair(threshold, batch, kpts0n) ** 2
    k0, k1 = kpts0n[..., None, :, :], kpts1n[..., None, :, :]
    g1 = draws.gumbel("round1", batch + (num_hypotheses, n), generator)
    g2 = draws.gumbel("round2", batch + (num_hypotheses // 2, n), generator)

    def fit_round(g, pool):
        idx = sample_minimal_sets(g, pool, 8)
        Es = essential_8pt(gather_points(kpts0n, idx),
                           gather_points(kpts1n, idx))
        errs = sampson_error(k0, k1, Es)
        return Es, errs, _msac_counts(errs, tsq, valid)

    Es1, errs1, counts1 = fit_round(g1, valid)
    if use_5pt:
        # Nister's 5-point minimal solver keeps the true twisted pair in
        # the pool where a sample is dominated by one plane (the 8-point
        # fit then lands anywhere in the plane's E-family).
        g5 = draws.gumbel("five_point",
                          batch + (max(num_hypotheses // 4, 32), n),
                          generator)
        idx5 = sample_minimal_sets(g5, valid, 5)
        Es5, ok5 = five_point_hypotheses(kpts0n, kpts1n, idx5)
        Es5 = Es5.to(kpts0n.dtype)
        errs5 = sampson_error(k0, k1, Es5)
        counts5 = torch.where(ok5, _msac_counts(errs5, tsq, valid), -1.0)
        Es1 = torch.cat([Es1, Es5], dim=-3)
        errs1 = torch.cat([errs1, errs5], dim=-2)
        counts1 = torch.cat([counts1, counts5], dim=-1)

    # Round 2 resamples from the best consensus set, kept only where it is
    # large enough to give diverse 8-point samples.
    best1 = torch.argmax(counts1, dim=-1)
    inl1 = (_pick(errs1, best1, 1) < tsq[..., None]) & valid
    pool2 = torch.where((inl1.sum(-1) >= 16)[..., None], inl1, valid)
    Es2, errs2, counts2 = fit_round(g2, pool2)

    Es = torch.cat([Es1, Es2], dim=-3)
    errs = torch.cat([errs1, errs2], dim=-2)
    counts = torch.cat([counts1, counts2], dim=-1)
    # lax.top_k's order: equal scores (the -1 of invalid 5-point
    # solutions) lower index first.
    top = torch.sort(counts, dim=-1, descending=True,
                     stable=True).indices[..., :lo_candidates]
    E = _take(Es, top, 2)                                   # [..., C, 3, 3]
    tsq_c = tsq[..., None, None]
    valid_c = valid[..., None, :]
    inl = (_take(errs, top, 1) < tsq_c) & valid_c           # [..., C, N]

    # Iterated least-squares refits on the consensus set (LO-RANSAC's
    # inner step), kept where they do not lose inliers.
    for _ in range(3):
        E_new = essential_8pt(k0, k1, inl.to(kpts0n.dtype))
        inl_new = (sampson_error(k0, k1, E_new) < tsq_c) & valid_c
        better = inl_new.sum(-1) >= inl.sum(-1)
        E = torch.where(better[..., None, None], E_new, E)
        inl = torch.where(better[..., None], inl_new, inl)
    pose = recover_pose(E, k0, k1, inl)
    R, t = refine_pose_sampson(pose["R"], pose["t"], k0, k1,
                               tsq[..., None], valid_c)
    E_ref = skew(t) @ R
    e = sampson_error(k0, k1, E_ref)
    inl = (e < tsq_c) & valid_c
    z0, z1 = _cheirality_depths(R, t, to_homogeneous(k0),
                                to_homogeneous(k1))
    good = torch.where(inl & (z0 > 0) & (z1 > 0), 1.0 - e / tsq_c,
                       0.0).sum(-1)
    best = torch.argmax(good, dim=-1)
    E_final = _pick(E_ref, best, 2)
    inl_final = _pick(inl, best, 1)
    e_final = sampson_error(kpts0n, kpts1n, E_final)
    score = torch.where(inl_final,
                        tsq[..., None] - torch.minimum(e_final,
                                                       tsq[..., None]),
                        0.0).sum(-1)
    return {"E": E_final, "R": _pick(R, best, 2), "t": _pick(t, best, 1),
            "inliers": inl_final, "num_inliers": inl_final.sum(-1),
            "score": score}


def decompose_essential(E: torch.Tensor):
    """E [..., 3, 3] -> the 4 candidate motions (R1, t), (R1, -t), (R2, t),
    (R2, -t): Rs [..., 4, 3, 3], unit ts [..., 4, 3]. Which of the twisted
    pair is R1 depends on the SVD's signs; the set does not."""
    U, _, Vh = svd3(E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vh = Vh * torch.sign(_det3(Vh))[..., None, None]
    W = torch.zeros((3, 3), dtype=E.dtype, device=E.device)
    W[0, 1], W[1, 0], W[2, 2] = -1.0, 1.0, 1.0
    R1 = U @ W @ Vh
    R2 = U @ W.T @ Vh
    t = U[..., :, 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _cheirality_depths(R, t, k0h, k1h):
    """Two-view depths (z0, z1) [..., N] of rays k0h (camera 0) and k1h
    (camera 1) [..., N, 3] under (R [..., 3, 3], t [..., 3]), from
    x1 ~ R x0 z0 + t: cross(x1, R x0) z0 = -cross(x1, t)."""
    Rx0 = k0h @ R.transpose(-1, -2)
    c_a = torch.linalg.cross(k1h, Rx0)
    c_b = torch.linalg.cross(k1h, t[..., None, :].expand(c_a.shape))
    denom = torch.sum(c_a * c_a, dim=-1)
    z0 = -torch.sum(c_a * c_b, dim=-1) / torch.clamp(denom, min=1e-12)
    p1 = (k0h * z0[..., None]) @ R.transpose(-1, -2) + t[..., None, :]
    return z0, p1[..., 2]


def recover_pose(E: torch.Tensor, kpts0n: torch.Tensor,
                 kpts1n: torch.Tensor, inliers: torch.Tensor):
    """The (R, t) of E with the most inliers in front of both cameras
    (cv2.recoverPose's rule). kpts [..., N, 2] and inliers [..., N]
    broadcast to E's batch. Returns dict R [..., 3, 3], t [..., 3],
    num_good."""
    Rs, ts = decompose_essential(E)
    k0h = to_homogeneous(kpts0n)[..., None, :, :]
    k1h = to_homogeneous(kpts1n)[..., None, :, :]
    z0, z1 = _cheirality_depths(Rs, ts, k0h, k1h)
    counts = ((z0 > 0) & (z1 > 0) & inliers[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)
    return {"R": _pick(Rs, best, 2), "t": _pick(ts, best, 1),
            "num_good": _pick(counts, best, 0)}


def decompose_homography(H: torch.Tensor):
    """Calibrated homographies [..., 3, 3] -> 4 candidate motions (R, t, n)
    each (Ma-Soatto-Kosecka, Thm 5.19): H normalized by its middle singular
    value, the two structure solutions from its right singular vectors,
    and the (t, n) sign flips. Rs [..., 4, 3, 3], unit ts and ns
    [..., 4, 3]."""
    _, s_all, _ = svd3(H)
    Hn = H / torch.clamp(s_all[..., 1], min=1e-12)[..., None, None]
    _, s, Vh = svd3(Hn)
    V = Vh.transpose(-1, -2)
    s1, s3 = s[..., 0, None], s[..., 2, None]
    denom = torch.sqrt(torch.clamp(s1 ** 2 - s3 ** 2, min=1e-12))
    a = torch.sqrt(torch.clamp(1.0 - s3 ** 2, min=0.0))
    b = torch.sqrt(torch.clamp(s1 ** 2 - 1.0, min=0.0))
    u1 = (a * V[..., :, 0] + b * V[..., :, 2]) / denom
    u2 = (a * V[..., :, 0] - b * V[..., :, 2]) / denom
    v2 = V[..., :, 1]

    def sol(u):
        U1 = torch.stack([v2, u, torch.linalg.cross(v2, u)], dim=-1)
        Hv2 = (Hn @ v2[..., None])[..., 0]
        Hu = (Hn @ u[..., None])[..., 0]
        W1 = torch.stack([Hv2, Hu, torch.linalg.cross(Hv2, Hu)], dim=-1)
        R = W1 @ U1.transpose(-1, -2)
        nrm = torch.linalg.cross(v2, u)
        t = ((Hn - R) @ nrm[..., None])[..., 0]
        t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                            min=1e-12)
        return R, t, nrm

    R1, t1, n1 = sol(u1)
    R2, t2, n2 = sol(u2)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t1, -t1, t2, -t2], dim=-2),
            torch.stack([n1, -n1, n2, -n2], dim=-2))


def _vote(score: torch.Tensor) -> torch.Tensor:
    """The winning slot [...] of the planar vote's scores [..., slots]
    (``VOTE_ROUTES`` names each slot's route)."""
    return torch.argmax(score, dim=-1)


def estimate_pose(kpts0: torch.Tensor, kpts1: torch.Tensor,
                  valid: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor,
                  generator: torch.Generator, thresh_px: float = 1.0,
                  num_hypotheses: int = 512, lo_candidates: int = 8,
                  planar_fallback: bool = True,
                  use_5pt: bool | None = None):
    """Relative pose of image pairs, as the reference's estimate_pose
    (OpenCV's RANSAC essential matrix + recoverPose): normalize by the
    intrinsics, threshold = thresh_px / f_mean (the mean of [K0_fx, K1_fy,
    K0_fx, K1_fy]), ``ransac_essential``.

    ``planar_fallback`` also fits a calibrated homography (its own RANSAC
    at 3x the threshold), decomposes it into 4 motions, builds 16
    plane-and-parallax candidates (E = [e']x H, the epipole e' from two
    off-plane residual lines, each refined by Gauss-Newton), and lets all
    of them [H, P&P, E] vote by cheirality-checked MSAC score; the P&P
    candidates and a double vote for off-plane inliers engage only where
    more than 70% of the E route's inliers lie on the plane (DEGENSAC).

    Args:
      kpts0, kpts1: [..., N, 2] pixel coordinates (padded).
      valid: [..., N] bool mask; K0, K1: [..., 3, 3].
      generator: a ``torch.Generator`` on the points' device, where JAX
        takes a key (every draw goes through ``draws.gumbel``).
      use_5pt: None: on for a CPU tensor, off on the card.
    Returns dict E, R, t, inliers, num_inliers, ok (>= 5 valid points and
    >= 5 inliers), each with the batch dimensions.
    """
    f_mean = (K0[..., 0, 0] + K1[..., 1, 1] + K0[..., 0, 0]
              + K1[..., 1, 1]) / 4.0
    norm_thresh = thresh_px / f_mean

    def normalize(k, K):
        c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)[..., None, :]
        f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)[..., None, :]
        return (k - c) / f

    k0n, k1n = normalize(kpts0, K0), normalize(kpts1, K1)
    res = ransac_essential(k0n, k1n, valid, norm_thresh, generator,
                           num_hypotheses=num_hypotheses,
                           lo_candidates=lo_candidates, use_5pt=use_5pt)
    R_final, t_final, inl_final = res["R"], res["t"], res["inliers"]
    E_final = res["E"]

    if planar_fallback:
        batch, n = k0n.shape[:-2], k0n.shape[-2]
        tsq = norm_thresh ** 2
        tsq_c = tsq[..., None, None]
        k0h, k1h = to_homogeneous(k0n), to_homogeneous(k1n)
        resH = ransac_homography(k0n, k1n, valid, norm_thresh * 3.0,
                                 generator,
                                 num_hypotheses=max(num_hypotheses // 2, 64))
        H = resH["H"]
        on_plane = resH["inliers"]
        off_plane = valid & ~on_plane
        Rs, ts, _ = decompose_homography(H)

        # Plane-and-parallax (DEGENSAC): each off-plane correspondence
        # gives a residual line (H x0) x x1 through the epipole e'; two
        # lines fix e', and E = [e']x H is the essential matrix compatible
        # with the plane.
        lines = torch.linalg.cross(k0h @ H.transpose(-1, -2), k1h)
        lines = lines / torch.clamp(torch.linalg.norm(lines, dim=-1,
                                                      keepdim=True),
                                    min=1e-12)
        g = draws.gumbel("parallax", batch + (PARALLAX_CANDIDATES, n),
                         generator)
        idx2 = sample_minimal_sets(g, off_plane, 2)
        ends = gather_points(lines, idx2)                # [..., 16, 2, 3]
        e = torch.linalg.cross(ends[..., 0, :], ends[..., 1, :])
        e = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True),
                            min=1e-12)
        U, _, Vh = svd3(skew(e) @ H[..., None, :, :])
        E_pp = (U * _s110(U)) @ Vh
        k0c, k1c = k0n[..., None, :, :], k1n[..., None, :, :]
        valid_c = valid[..., None, :]
        inl0 = (sampson_error(k0c, k1c, E_pp) < tsq_c) & valid_c
        pose = recover_pose(E_pp, k0c, k1c, inl0)
        Rp, tp = refine_pose_sampson(pose["R"], pose["t"], k0c, k1c,
                                     tsq[..., None], valid_c)

        h_dom = ((on_plane & inl_final).sum(-1).to(k0n.dtype)
                 / torch.clamp(inl_final.sum(-1), min=1).to(k0n.dtype))
        degenerate = h_dom > 0.7

        # One vote over [H, P&P, E]. The raw H decompositions stay
        # unrefined (within the plane's E-family every member fits the
        # Sampson residuals, so GN would drift off the cheirality answer);
        # in the degenerate regime off-plane inliers count double. The
        # order keeps the H route first in an exact tie.
        R_all = torch.cat([Rs, Rp, R_final[..., None, :, :]], dim=-3)
        t_all = torch.cat([ts, tp, t_final[..., None, :]], dim=-2)
        off_w = torch.where(degenerate, 2.0, 0.0).to(k0n.dtype)
        slot = torch.arange(len(VOTE_ROUTES), device=k0n.device)
        pp = VOTE_ROUTES.index("P&P")
        pp_mask = (slot >= pp) & (slot < pp + PARALLAX_CANDIDATES)
        e_all = sampson_error(k0c, k1c, skew(t_all) @ R_all)
        inl_all = (e_all < tsq_c) & valid_c
        z0, z1 = _cheirality_depths(R_all, t_all, k0h[..., None, :, :],
                                    k1h[..., None, :, :])
        good = inl_all & (z0 > 0) & (z1 > 0)
        msac = torch.where(good, 1.0 - e_all / tsq_c, 0.0)
        score = msac.sum(-1) + off_w[..., None] * torch.where(
            good & off_plane[..., None, :], msac, 0.0).sum(-1)
        score = torch.where(pp_mask & ~degenerate[..., None], -1.0, score)
        b = _vote(score)
        R_final, t_final = _pick(R_all, b, 2), _pick(t_all, b, 1)
        inl_final = _pick(inl_all, b, 1)
        E_final = skew(t_final) @ R_final

    num = inl_final.sum(-1)
    return {"E": E_final, "R": R_final, "t": t_final, "inliers": inl_final,
            "num_inliers": num, "ok": (valid.sum(-1) >= 5) & (num >= 5)}
