"""Bundle adjustment and DLT triangulation (port of ``oetr_tpu/sfm/ba.py``).

Levenberg-Marquardt over an implicit Schur complement, as in JAX:
observations are flat arrays (obs_cam, obs_pt, obs_uv, valid) and the
per-camera and per-point reductions are ``index_add_`` sums (JAX's
``segment_sum``); the camera system S = H_cc - W H_pp⁻¹ Wᵀ is never
formed: conjugate gradients run on its matvec (two sweeps over the
observations) with block-Jacobi preconditioning from H_cc's 6x6 blocks,
and the points come back by a batched 3x3 back-substitution.

It runs where its tensors lie. On the card neither loop (the LM steps,
the CG iterations; JAX's two ``lax.scan``s) reads anything back: the step
is accepted or rejected by ``torch.where`` on tensors, and the 3x3 and 6x6
inverses are ``torch.linalg.inv_ex`` unchecked (``inv`` reads its status
back on every call). The sums are atomic adds on the card, so their order,
and the last bits of a sum, change from run to run. With ``group`` (JAX's
``axis_name``) the observations are sharded over its ranks: every segment
sum and the cost are all-reduced (JAX's psum), so each rank runs the same
LM steps on the same cameras and points.

The Jacobians are forward-mode AD, one JVP a column, as ``jax.jacfwd``
takes them. Through ``geometry.ransac.so3_exp``, which divides with JAX's
derivative rule, a camera at exactly zero rotation in float32 gets a NaN
Jacobian in all six columns, as in JAX; NaN · 0 passes the update mask
into the CG, so every step of that problem is rejected and the cost stays
where it started (float64 moves).

Camera model: world->camera rigid (so3 log + translation, [C, 6]) with
fixed per-camera intrinsics K [C, 3, 3]; residual = pi(K (R X + t)) - uv.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..geometry.ransac import so3_exp
from ..ops.small_eigh import eigh


def project_residual(cam6: torch.Tensor, K: torch.Tensor, pt: torch.Tensor,
                     uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residuals [..., 2] of observations: cameras [..., 6],
    intrinsics [..., 3, 3], points [..., 3], pixels [..., 2] (broadcast)."""
    R = so3_exp(cam6[..., :3])
    p = (R @ pt[..., None])[..., 0] + cam6[..., 3:]
    z = p[..., 2:]
    z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    proj = (K @ (p / z)[..., None])[..., 0]
    return proj[..., :2] - uv


def residuals(cams: torch.Tensor, pts: torch.Tensor, K: torch.Tensor,
              obs_cam: torch.Tensor, obs_pt: torch.Tensor,
              obs_uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[O, 2] masked residuals."""
    r = project_residual(cams[obs_cam], K[obs_cam], pts[obs_pt], obs_uv)
    return r * valid[:, None]


def _jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """Per-row Jacobians [O, 2, n] of f: [O, n] -> [O, 2] at x, where row o
    of f reads row o of x alone: one ``torch.func.jvp`` over a leading axis
    of the n unit directions (``jax.jacfwd``'s columns). Not a vmap of
    ``torch.func.jacfwd`` over rows: there a row's sum of squares is a
    0-dim tensor, and torch gives a 0-dim tensor plus a Python float a
    float64 tangent, so a float32 Jacobian would come out in float64."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    dirs = eye[:, None, :].expand((n,) + x.shape).contiguous()
    xs = x.expand((n,) + x.shape).contiguous()
    _, dr = torch.func.jvp(f, (xs,), (dirs,))
    return torch.movedim(dr, 0, -1)


def _obs_jacobians(cams, pts, K, obs_cam, obs_pt, obs_uv, valid):
    """Per-observation Jacobians Jc [O, 2, 6], Jp [O, 2, 3], each taken
    apart, as in JAX (with both at once the cameras' NaN at zero rotation
    would reach Jp). Outside inference mode: under ``torch.inference_mode``
    forward-mode AD is off, and torch 2.11 returns zero tangents without a
    word."""
    with torch.inference_mode(False):
        c, Ko, p, uv = cams[obs_cam], K[obs_cam], pts[obs_pt], obs_uv
        Jc = _jacobian(lambda x: project_residual(x, Ko, p, uv), c)
        Jp = _jacobian(lambda x: project_residual(c, Ko, x, uv), p)
    m = valid[:, None, None]
    return Jc * m, Jp * m


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-observation robust IRLS weights (sqrt applied to J and r)."""
    norm = torch.linalg.norm(r, dim=-1)
    w = torch.where(norm <= delta, 1.0,
                    delta / torch.clamp(norm, min=1e-12))
    return torch.sqrt(w)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M v: [..., a, b], [..., b] -> [..., a]."""
    return (M @ v[..., None])[..., 0]


def _vm(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Batched vᵀ M: [..., a], [..., a, b] -> [..., b]."""
    return (v[..., None, :] @ M)[..., 0, :]


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int,
                 group=None) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                      device=x.device).index_add_(0, idx, x)
    return _psum(out, group)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (in place); ``x`` alone
    without one."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _apply_cam(cams: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Local so3 update of the rotations (back to the log by the
    quaternion-free Rodrigues log), additive for the translations."""
    R = so3_exp(cams[:, :3]) @ so3_exp(d[:, :3])
    cos = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1) / 2,
                      -1.0, 1.0)
    th = torch.arccos(cos)[:, None]
    sin = torch.sin(th)
    axis = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                        R[:, 1, 0] - R[:, 0, 1]], dim=-1)
    w = torch.where(sin > 1e-7, axis * th / (2 * sin + 1e-30), axis * 0.5)
    return torch.cat([w, cams[:, 3:] + d[:, 3:]], dim=-1)


def bundle_adjust(cams0: torch.Tensor, pts0: torch.Tensor, K: torch.Tensor,
                  obs_cam: torch.Tensor, obs_pt: torch.Tensor,
                  obs_uv: torch.Tensor, valid: torch.Tensor,
                  update_mask: torch.Tensor | None = None,
                  iters: int = 10, cg_iters: int = 30,
                  damping: float = 1e-3, huber_delta: float = 0.0,
                  group=None) -> dict:
    """Levenberg-Marquardt BA.

    Args:
      cams0: [C, 6] (so3, t) world->camera; pts0: [P, 3]; K: [C, 3, 3].
      obs_cam/obs_pt: [O] int indices; obs_uv: [O, 2]; valid: [O] bool.
      update_mask: [C, 6] float (0 freezes a component, gauge fixing;
        default fixes camera 0 entirely).
      group: the process group the observations are sharded over (each
        rank passes its own obs_*; cameras, points and K whole on every
        rank), or None.

    Returns dict: cams [C, 6], pts [P, 3], cost0, cost, cost_history
    [iters + 1], tensors where the inputs lie.
    """
    C, P = cams0.shape[0], pts0.shape[0]
    dt, dev = cams0.dtype, cams0.device
    obs_cam, obs_pt = obs_cam.long(), obs_pt.long()
    vf = valid.to(dt)
    if update_mask is None:
        update_mask = torch.ones((C, 6), dtype=dt, device=dev)
        update_mask[0] = 0.0
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def cost(cams, pts):
        r = residuals(cams, pts, K, obs_cam, obs_pt, obs_uv, vf)
        if huber_delta > 0:
            n = torch.linalg.norm(r, dim=-1)
            per = torch.where(n <= huber_delta, 0.5 * n ** 2,
                              huber_delta * (n - 0.5 * huber_delta))
            return _psum(torch.sum(per * vf), group)
        return 0.5 * _psum(torch.sum(r ** 2), group)

    def lm_step(cams, pts, lam, prev_cost):
        r = residuals(cams, pts, K, obs_cam, obs_pt, obs_uv, vf)
        Jc, Jp = _obs_jacobians(cams, pts, K, obs_cam, obs_pt, obs_uv, vf)
        if huber_delta > 0:
            w = _huber_weights(r, huber_delta) * vf
            r = r * w[:, None]
            Jc = Jc * w[:, None, None]
            Jp = Jp * w[:, None, None]

        # Gradient and diagonal blocks.
        JcT, JpT = Jc.transpose(1, 2), Jp.transpose(1, 2)
        g_c = _segment_sum(_vm(r, Jc), obs_cam, C, group)
        g_p = _segment_sum(_vm(r, Jp), obs_pt, P, group)
        Hcc = _segment_sum(JcT @ Jc, obs_cam, C, group)
        Hpp = _segment_sum(JpT @ Jp, obs_pt, P, group)
        Hcc = Hcc + lam * eye6
        Hpp = Hpp + lam * eye3
        Hpp_inv = torch.linalg.inv_ex(Hpp, check_errors=False)[0]
        # Each observation's block of W, Jcᵀ Jp [O, 6, 3].
        W = JcT @ Jp

        # Schur RHS: b = -(g_c - W Hpp⁻¹ g_p).
        y_p = _mv(Hpp_inv, g_p)
        t = _segment_sum(_mv(W, y_p[obs_pt]), obs_cam, C, group)
        b = -(g_c - t) * update_mask

        def S_mv(v):
            """S v = Hcc v - W Hpp⁻¹ Wᵀ v."""
            v = v * update_mask
            u1 = _mv(Hcc, v)
            wtv = _segment_sum(_vm(_mv(Jc, v[obs_cam]), Jp), obs_pt, P,
                               group)
            u2 = _segment_sum(_mv(W, _mv(Hpp_inv, wtv)[obs_pt]), obs_cam, C,
                              group)
            return (u1 - u2) * update_mask

        Hcc_inv = torch.linalg.inv_ex(Hcc, check_errors=False)[0]

        def precond(v):
            return _mv(Hcc_inv, v) * update_mask

        x = torch.zeros_like(b)
        rr = b - S_mv(x)
        z = precond(rr)
        p = z
        rz = torch.sum(rr * z)
        for _ in range(cg_iters):
            Sp = S_mv(p)
            denom = torch.sum(p * Sp)
            alpha = rz / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20)
            p = z + beta * p
            rz = rz_new
        dc = x

        # Point back-substitution: dp = Hpp⁻¹ (-g_p - Wᵀ dc).
        wtdc = _segment_sum(_vm(_mv(Jc, dc[obs_cam]), Jp), obs_pt, P,
                            group)
        dp = _mv(Hpp_inv, -(g_p + wtdc))

        cams_new = _apply_cam(cams, dc * update_mask).to(dt)
        pts_new = (pts + dp).to(pts0.dtype)
        new_cost = cost(cams_new, pts_new).to(prev_cost.dtype)
        accept = new_cost < prev_cost
        cams = torch.where(accept, cams_new, cams)
        pts = torch.where(accept, pts_new, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cur = torch.where(accept, new_cost, prev_cost)
        return cams, pts, lam, cur

    c0 = cost(cams0, pts0).to(dt)
    cams, pts, cur = cams0, pts0, c0
    lam = torch.full((), damping, dtype=dt, device=dev)
    hist = [c0]
    for _ in range(iters):
        cams, pts, lam, cur = lm_step(cams, pts, lam, cur)
        hist.append(cur)
    return {"cams": cams, "pts": pts, "cost0": c0, "cost": cur,
            "cost_history": torch.stack(hist)}


def triangulate_points(cams: torch.Tensor, K: torch.Tensor,
                       obs_uv: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Linear multi-view (DLT) triangulation of P points at once.

    Args:
      cams: [P, V, 6] observing cameras; K: [P, V, 3, 3]; obs_uv: [P, V, 2];
      valid: [P, V] bool (padded views allowed).
    Returns [P, 3] world points: each the null vector of its AᵀA, from
    ``ops.eigh``: one launch of the eigh kernel (n = 4) for all points on
    the card (float32), LAPACK's syevd, JAX's routine, on the CPU.
    """
    R = so3_exp(cams[..., :3])
    Pm = K @ torch.cat([R, cams[..., 3:, None]], dim=-1)      # [P, V, 3, 4]
    r1 = obs_uv[..., 0:1] * Pm[..., 2, :] - Pm[..., 0, :]
    r2 = obs_uv[..., 1:2] * Pm[..., 2, :] - Pm[..., 1, :]
    A = torch.stack([r1, r2], dim=-2) * valid.to(cams.dtype)[..., None, None]
    A = A.reshape(A.shape[:-3] + (-1, 4))
    _, V = eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]
    w = X[..., 3:]
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)


def triangulate_dlt(cams: torch.Tensor, K: torch.Tensor,
                    obs_uv: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """Linear multi-view triangulation of ONE point: cams [V, 6], K [V, 3,
    3], obs_uv [V, 2], valid [V] -> [3]."""
    return triangulate_points(cams[None], K[None], obs_uv[None],
                              valid[None])[0]
