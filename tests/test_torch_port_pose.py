"""The port's two-view geometry against the JAX package, on the CPU:
epipolar geometry, homographies, the 5-point solver, LO-RANSAC and
``estimate_pose``.

The same numpy inputs go through the JAX function and the port's. Where
JAX draws random numbers, the test repeats its key splits and draws
(``oetr_tpu/geometry/ransac.py:208,441``) and hands them to the port
through its one draw function, ``draws.gumbel``, so both run on the same
noise.

Precision. JAX's estimator runs in float32 in production; there its
Gauss-Newton refinement never moves: ``jax.jacfwd`` through so3_exp's
(1 - cos θ)/θ² at θ = 1e-12 forms θ⁻⁴ = 1e48, inf in float32, and 0 * inf
makes the whole Jacobian NaN, so every step is rejected
(``test_jax_f32_gauss_newton_is_a_no_op``). Under x64 it works. The port
copies this: its float32 refinement returns its input. So the estimator
is held to JAX twice, each whole: in float32 (x64 off, JAX's production
arithmetic and draws), where neither refinement moves, and in float64
(x64 on), where both run.

Bounds:
  epipolar functions, pose_error        1e-5 relative; angles 1e-4°
  homography_dlt, essential_8pt         equal up to sign within 1e-4 of
                                        the matrix's Frobenius norm
  decompose_essential/_homography       the same candidates within 1e-5
  recover_pose, refine_pose_sampson     R and t within 1e-3°
  the numpy 5-point solver              equal within 1e-12
  ransac_homography, ransac_essential,  R and t (H up to scale, 1e-4) within
  estimate_pose on JAX's draws          0.05°; inlier masks equal on >= 99%
                                        of valid slots; ok equal
Angles between two results are taken from chords in float64: the arccos
of the trace near 1 turns a rounding of the matrices (0.02° for one ulp
of an f32 trace) into an angle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.geometry import epipolar as jepi
from oetr_tpu.geometry import fivepoint as jfive
from oetr_tpu.geometry import homography as jhom
from oetr_tpu.geometry import ransac as jr
from oetr_tpu_torch import profile_forward as pf
from oetr_tpu_torch.geometry import draws
from oetr_tpu_torch.geometry import epipolar as pepi
from oetr_tpu_torch.geometry import fivepoint as pfive
from oetr_tpu_torch.geometry import homography as phom
from oetr_tpu_torch.geometry import ransac as pr

torch.set_num_threads(2)

REL = 1e-5
ANGLE_DEG = 1e-4
SIGN_FROB = 1e-4
CAND = 1e-5
POSE_DEG = 1e-3
FIVE = 1e-12
RANSAC_DEG = 0.05
MASK_AGREE = 0.99
N = 256
HYPS = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _deg_R(a, b):
    """Angles (°) between rotations from their chord, in float64:
    ||Ra - Rb||_F = 2 sqrt(2) sin(θ / 2)."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    chord = np.linalg.norm(a - b, axis=(-1, -2)) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.minimum(chord, 1.0)))


def _deg_t(a, b):
    """Angles (°) between vectors from the chord of their unit vectors."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    chord = np.linalg.norm(unit(a) - unit(b), axis=-1) / 2.0
    return np.degrees(2.0 * np.arcsin(np.minimum(chord, 1.0)))


def _up_to_sign(a, b):
    """max over matrices of min(|a - b|, |a + b|) / ||b||_F."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    d = np.minimum(np.abs(a - b).max((-1, -2)), np.abs(a + b).max((-1, -2)))
    return (d / np.linalg.norm(b, axis=(-1, -2))).max()


def _same_candidates(pa, pb):
    """Each candidate of one set within CAND of one of the other's."""
    pa, pb = _np(pa), _np(pb)
    for x in pa:
        assert min(np.abs(x - y).max() for y in pb) < CAND
    for y in pb:
        assert min(np.abs(x - y).max() for x in pa) < CAND


def _rotations(rng, n, max_deg=30.0):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(
        rng.normal(size=(n, 3)) * np.deg2rad(max_deg) / 2).as_matrix()


def _poses(rng, n):
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = _rotations(rng, n)
    t = rng.normal(size=(n, 3))
    T[:, :3, 3] = t / np.linalg.norm(t, axis=-1, keepdims=True)
    return T.astype(np.float32)


def _K(n):
    K = np.tile(np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]]),
                (n, 1, 1))
    return K.astype(np.float32)


# ------------------------------------------------------------ draws --

def _jax_draws(key, hyps, n):
    """JAX's Gumbel draws of one estimate_pose call, by the port's stage
    names (the key splits of ransac.py:208 and :441)."""
    rng_e, rng_h, rng_p = jax.random.split(key, 3)
    rng1, rng2, rng5 = jax.random.split(rng_e, 3)
    g = jax.random.gumbel
    return {"round1": np.asarray(g(rng1, (hyps, n))),
            "round2": np.asarray(g(rng2, (hyps // 2, n))),
            "five_point": np.asarray(g(rng5, (max(hyps // 4, 32), n))),
            "homography": np.asarray(g(rng_h, (max(hyps // 2, 64), n))),
            "parallax": np.asarray(g(rng_p, (16, n)))}


@pytest.fixture
def feed(monkeypatch):
    """feed(draws_by_stage): the port draws these (a stage's array stacked
    over the batch when there is one) instead of the generator's."""
    def install(by_stage):
        def gumbel(stage, shape, generator):
            a = by_stage[stage]
            assert tuple(shape) == a.shape, (stage, shape, a.shape)
            return _t(a)
        monkeypatch.setattr(draws, "gumbel", gumbel)
    return install


# ---------------------------------------------------------- epipolar --

def _epipolar_inputs(rng):
    n = 40
    kp0 = rng.uniform(0, 640, (2, n, 2)).astype(np.float32)
    kp1 = rng.uniform(0, 640, (2, n, 2)).astype(np.float32)
    return dict(kp0=kp0, kp1=kp1, K=_K(2), T=_poses(rng, 2),
                R=_rotations(rng, 2).astype(np.float32),
                v=rng.normal(size=(2, 3)).astype(np.float32),
                xyz=(rng.uniform(-2, 2, (2, n, 3))
                     + [0, 0, 6]).astype(np.float32))


EPIPOLAR = {
    "to_homogeneous": lambda m, d: m.to_homogeneous(d["kp0"]),
    "normalize_keypoints": lambda m, d: m.normalize_keypoints(d["kp0"],
                                                              d["K"]),
    "unnormalize_keypoints": lambda m, d: m.unnormalize_keypoints(
        d["kp0"] / 600.0, d["K"]),
    "skew": lambda m, d: m.skew(d["v"]),
    "essential_from_pose": lambda m, d: m.essential_from_pose(d["T"]),
    "symmetric_epipolar_error": lambda m, d: m.symmetric_epipolar_error(
        d["kp0"], d["kp1"], d["T"], d["K"], d["K"]),
    "sampson_error": lambda m, d: m.sampson_error(
        d["kp0"] / 600.0, d["kp1"] / 600.0, m.essential_from_pose(d["T"])),
    "project_points": lambda m, d: m.project_points(d["xyz"], d["K"]),
    "transform_points": lambda m, d: m.transform_points(d["T"], d["xyz"]),
}
ANGLES = {
    "angle_error_mat": lambda m, d: m.angle_error_mat(d["R"],
                                                      d["T"][:, :3, :3]),
    "angle_error_vec": lambda m, d: m.angle_error_vec(d["v"],
                                                      d["T"][:, :3, 3]),
    "pose_error": lambda m, d: m.pose_error(d["T"], d["R"], d["v"]),
}


@pytest.mark.parametrize("name", sorted(EPIPOLAR) + sorted(ANGLES))
def test_epipolar_matches_jax(name):
    d = _epipolar_inputs(np.random.default_rng(1))
    fn = {**EPIPOLAR, **ANGLES}[name]
    with jax.enable_x64(False):
        want = fn(jepi, {k: jnp.asarray(v) for k, v in d.items()})
    got = fn(pepi, {k: _t(v) for k, v in d.items()})
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert _np(g).shape == np.asarray(w).shape
        if name in ANGLES:
            assert np.abs(_np(g) - np.asarray(w)).max() < ANGLE_DEG
        else:
            assert _rel(g, w) < REL


# -------------------------------------------------------- homography --

def _planar_samples(rng, b, n, noise=0.5):
    """b noisy views of planar points under random homographies."""
    p0 = rng.uniform(0, 640, (b, n, 2))
    H = np.tile(np.eye(3), (b, 1, 1)) + rng.normal(0, 0.05, (b, 3, 3))
    H[:, 2, :2] *= 1e-3
    H[:, :2, 2] += rng.uniform(-40, 40, (b, 2))
    ph = np.concatenate([p0, np.ones((b, n, 1))], -1) @ H.transpose(0, 2, 1)
    p1 = ph[..., :2] / ph[..., 2:] + rng.normal(0, noise, (b, n, 2))
    return p0.astype(np.float32), p1.astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_dlt_matches_jax(weighted):
    rng = np.random.default_rng(2)
    p0, p1 = _planar_samples(rng, 6, 24)
    w = (rng.uniform(size=(6, 24)) < 0.7).astype(np.float32)
    with jax.enable_x64(False):
        f = jax.jit(jax.vmap(jhom.homography_dlt) if weighted else
                    jax.vmap(lambda a, b: jhom.homography_dlt(a, b)))
        want = (f(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w))
                if weighted else f(jnp.asarray(p0), jnp.asarray(p1)))
    got = phom.homography_dlt(_t(p0), _t(p1), _t(w) if weighted else None)
    assert _up_to_sign(got, want) < SIGN_FROB


PLANAR_2D = {
    "similarity_from_2pts": lambda m, p0, p1, w: m.similarity_from_2pts(
        p0[..., :2, :], p1[..., :2, :]),
    "similarity_umeyama": lambda m, p0, p1, w: m.similarity_umeyama(p0, p1,
                                                                   w),
    "apply_homography": lambda m, p0, p1, w: m.apply_homography(
        m.similarity_umeyama(p0, p1, w), p0),
}


@pytest.mark.parametrize("name", sorted(PLANAR_2D))
def test_similarity_and_warp_match_jax(name):
    rng = np.random.default_rng(3)
    p0, p1 = _planar_samples(rng, 4, 16)
    w = (rng.uniform(size=(4, 16)) < 0.8).astype(np.float32)
    fn = PLANAR_2D[name]
    with jax.enable_x64(False):
        want = jax.vmap(lambda a, b, c: fn(jhom, a, b, c))(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(w))
    got = fn(phom, _t(p0), _t(p1), _t(w))
    assert _rel(got, want) < REL


def test_decompose_homography_matches_jax():
    rng = np.random.default_rng(4)
    T = _poses(rng, 5).astype(np.float64)
    nrm = rng.normal(size=(5, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    H = (T[:, :3, :3] + T[:, :3, 3, None] * nrm[:, None, :] / 5.0)
    H = (H * rng.uniform(0.5, 2, (5, 1, 1))).astype(np.float32)
    with jax.enable_x64(False):
        want = jax.vmap(jr.decompose_homography)(jnp.asarray(H))
    got = pr.decompose_homography(_t(H))
    for i in range(5):
        _same_candidates(np.concatenate([_np(got[0][i]).reshape(4, 9),
                                         _np(got[1][i]), _np(got[2][i])], -1),
                         np.concatenate([np.asarray(want[0][i]).reshape(4, 9),
                                         np.asarray(want[1][i]),
                                         np.asarray(want[2][i])], -1))


@pytest.mark.parametrize("model", ["homography", "similarity"])
def test_ransac_homography_matches_jax(model, feed):
    rng = np.random.default_rng(5)
    p0, p1 = _planar_samples(rng, 1, N, noise=0.3)
    p0, p1 = p0[0], p1[0]
    out = rng.choice(N, N // 4, replace=False)
    p1[out] = rng.uniform(0, 640, (len(out), 2))
    valid = np.arange(N) < 220
    key = jax.random.key(5)
    with jax.enable_x64(False):
        want = jhom.ransac_homography(jnp.asarray(p0), jnp.asarray(p1),
                                      jnp.asarray(valid), 2.0, key,
                                      num_hypotheses=HYPS, model=model)
        g = np.asarray(jax.random.gumbel(key, (HYPS, N)))
    feed({"homography": g})
    got = phom.ransac_homography(_t(p0), _t(p1), _t(valid), 2.0, None,
                                 num_hypotheses=HYPS, model=model)
    Hw = np.asarray(want["H"]) / np.asarray(want["H"])[2, 2]
    Hg = _np(got["H"]) / _np(got["H"])[2, 2]
    assert _rel(Hg, Hw) < SIGN_FROB
    agree = (_np(got["inliers"]) == np.asarray(want["inliers"]))[valid]
    assert agree.mean() >= MASK_AGREE
    assert bool(got["ok"]) == bool(want["ok"])
    assert not _np(got["inliers"])[~valid].any()


# --------------------------------------------------------- fivepoint --

def _five_samples(rng, h=40):
    """Exact minimal samples of random motions, a quarter of them
    coplanar."""
    out0, out1 = [], []
    for i in range(h):
        R = _rotations(rng, 1)[0]
        t = rng.normal(size=3)
        X = rng.uniform(-2, 2, (5, 3)) + [0, 0, 6]
        if i % 4 == 0:
            X[:, 2] = 6.0
        x0 = X[:, :2] / X[:, 2:]
        X1 = X @ R.T + t
        out0.append(x0)
        out1.append(X1[:, :2] / X1[:, 2:])
    return np.stack(out0), np.stack(out1)


def test_fivepoint_numpy_copies_match_jax():
    p0, p1 = _five_samples(np.random.default_rng(6))
    assert np.array_equal(pfive._V_INV, jfive._V_INV)
    bases = pfive.nullspace_bases(p0, p1)
    assert np.abs(bases - jfive.nullspace_bases(p0, p1)).max() <= FIVE
    E, v = pfive.solve_5pt_batch(bases)
    Ej, vj = jfive.solve_5pt_batch(bases)
    assert np.array_equal(v, vj) and v.any()
    assert np.abs(E.astype(np.float64) - Ej).max() <= FIVE
    E, v = pfive.solve_5pt_host(p0, p1)
    Ej, vj = jfive.solve_5pt_host(p0, p1)
    assert np.array_equal(v, vj)
    assert np.abs(E.astype(np.float64) - Ej).max() <= FIVE


def test_five_point_hypotheses_match_the_callback():
    """One host round trip for a batch of pairs against JAX's callback,
    pair by pair."""
    rng = np.random.default_rng(7)
    k0 = rng.normal(0, 0.3, (3, 64, 2)).astype(np.float32)
    k1 = (k0 + rng.normal(0, 0.05, (3, 64, 2))).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(64, 5, replace=False)
                              for _ in range(8)]) for _ in range(3)])
    E, v = pfive.five_point_hypotheses(_t(k0), _t(k1), _t(idx))
    assert E.shape == (3, 80, 3, 3) and v.shape == (3, 80)
    with jax.enable_x64(False):
        for i in range(3):
            Ej, vj = jfive.five_point_hypotheses(jnp.asarray(k0[i]),
                                                 jnp.asarray(k1[i]),
                                                 jnp.asarray(idx[i]))
            assert np.array_equal(_np(v[i]), np.asarray(vj))
            assert np.abs(_np(E[i]) - np.asarray(Ej)).max() <= FIVE


# ------------------------------------------------------------ ransac --

def _eight_samples(rng, h=32, n=8, noise=1e-3):
    T = _poses(rng, h).astype(np.float64)
    X = rng.uniform(-2, 2, (h, n, 3)) + [0, 0, 6]
    x0 = X[..., :2] / X[..., 2:]
    X1 = X @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
    x1 = X1[..., :2] / X1[..., 2:]
    x0 = x0 + rng.normal(0, noise, x0.shape)
    x1 = x1 + rng.normal(0, noise, x1.shape)
    return x0.astype(np.float32), x1.astype(np.float32), T


@pytest.mark.parametrize("weighted", [False, True])
def test_essential_8pt_matches_jax(weighted):
    rng = np.random.default_rng(8)
    n = 8 if not weighted else 60
    x0, x1, _ = _eight_samples(rng, n=n)
    w = (rng.uniform(size=x0.shape[:2]) < 0.8).astype(np.float32)
    with jax.enable_x64(False):
        if weighted:
            want = jax.jit(jax.vmap(jr.essential_8pt))(
                jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w))
        else:
            want = jax.jit(jax.vmap(lambda a, b: jr.essential_8pt(a, b)))(
                jnp.asarray(x0), jnp.asarray(x1))
    got = pr.essential_8pt(_t(x0), _t(x1), _t(w) if weighted else None)
    assert _up_to_sign(got, want) < SIGN_FROB


HELPERS = {
    "so3_exp": lambda m, d: m.so3_exp(d["w"]),
    "tangent_basis": lambda m, d: m._tangent_basis(d["t"]),
    "signed_sampson": lambda m, d: m.signed_sampson(d["x0"], d["x1"],
                                                    d["E"]),
    "cheirality_depths": lambda m, d: m._cheirality_depths(
        d["R"], d["t"], d["h0"], d["h1"]),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_ransac_helpers_match_jax(name):
    rng = np.random.default_rng(9)
    x0, x1, T = _eight_samples(rng, h=1, n=50, noise=1e-2)
    T32 = T.astype(np.float32)[0]
    ones = np.ones((50, 1), np.float32)
    d = dict(w=rng.normal(0, 0.3, 3).astype(np.float32),
             t=T32[:3, 3], R=T32[:3, :3], x0=x0[0], x1=x1[0],
             h0=np.concatenate([x0[0], ones], -1),
             h1=np.concatenate([x1[0], ones], -1),
             E=np.asarray(jepi.essential_from_pose(T32)).astype(np.float32))
    fn = HELPERS[name]
    with jax.enable_x64(False):
        want = fn(jr, {k: jnp.asarray(v) for k, v in d.items()})
    got = fn(pr, {k: _t(v) for k, v in d.items()})
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert _rel(g, w) < REL


def test_decompose_essential_matches_jax():
    T = _poses(np.random.default_rng(10), 6)
    E = np.asarray(jepi.essential_from_pose(T.astype(np.float64)))
    E = (E * np.random.default_rng(11).uniform(0.5, 2, (6, 1, 1)))
    E = E.astype(np.float32)
    with jax.enable_x64(False):
        Rj, tj = jax.vmap(jr.decompose_essential)(jnp.asarray(E))
    Rp, tp = pr.decompose_essential(_t(E))
    for i in range(6):
        _same_candidates(
            np.concatenate([_np(Rp[i]).reshape(4, 9), _np(tp[i])], -1),
            np.concatenate([np.asarray(Rj[i]).reshape(4, 9),
                            np.asarray(tj[i])], -1))


def test_recover_pose_matches_jax():
    rng = np.random.default_rng(12)
    x0, x1, T = _eight_samples(rng, h=6, n=80, noise=2e-3)
    inl = rng.uniform(size=(6, 80)) < 0.9
    E = np.asarray(jepi.essential_from_pose(T)).astype(np.float32)
    with jax.enable_x64(False):
        want = jax.vmap(jr.recover_pose)(jnp.asarray(E), jnp.asarray(x0),
                                         jnp.asarray(x1), jnp.asarray(inl))
    got = pr.recover_pose(_t(E), _t(x0), _t(x1), _t(inl))
    assert _deg_R(got["R"], want["R"]).max() < POSE_DEG
    assert _deg_t(got["t"], want["t"]).max() < POSE_DEG
    assert np.array_equal(_np(got["num_good"]), np.asarray(want["num_good"]))
    # ... and the motion they pick is the true one.
    assert _deg_R(got["R"], T[:, :3, :3]).max() < 1.0


def _refine_case(rng, dtype):
    """A noisy problem and a perturbed start (R0, t0)."""
    x0, x1, T = _eight_samples(rng, h=4, n=120, noise=1.5e-3)
    x1[:, :20] = rng.uniform(-0.4, 0.4, (4, 20, 2))
    R0 = np.stack([_rotations(rng, 1, 0.4)[0] @ T[i, :3, :3]
                   for i in range(4)])
    t0 = T[:, :3, 3] + rng.normal(0, 0.005, (4, 3))
    t0 /= np.linalg.norm(t0, axis=-1, keepdims=True)
    cast = lambda a: a.astype(dtype)
    return cast(x0), cast(x1), cast(R0), cast(t0), np.ones((4, 120), bool), T


def test_refine_pose_sampson_matches_jax_x64():
    """From the same start, in float64: JAX's refinement runs here."""
    x0, x1, R0, t0, valid, T = _refine_case(np.random.default_rng(13),
                                            np.float64)
    tsq = (1.0 / 600.0) ** 2
    with jax.enable_x64(True):
        Rj, tj = jax.vmap(lambda R, t, a, b, v: jr.refine_pose_sampson(
            R, t, a, b, tsq, v))(*map(jnp.asarray, (R0, t0, x0, x1, valid)))
    Rp, tp = pr.refine_pose_sampson(_t(R0), _t(t0), _t(x0), _t(x1),
                                    torch.full((4,), tsq, dtype=torch.float64),
                                    _t(valid))
    assert _deg_R(Rp, Rj).max() < POSE_DEG
    assert _deg_t(tp, tj).max() < POSE_DEG
    # The refinement moved, towards the truth.
    assert _deg_R(Rp, R0).min() > 0.05
    assert (_deg_R(Rp, T[:, :3, :3]) < _deg_R(R0, T[:, :3, :3])).all()


def test_jax_f32_gauss_newton_is_a_no_op():
    """The reference's fault, and the port's copy of it: in float32 JAX's
    Jacobian of the refinement is NaN, so it never moves, and the port's
    float32 refinement returns its input likewise. The port's residuals
    have a finite float32 Jacobian equal to JAX's float64 one, which its
    float64 refinement takes."""
    x0, x1, R0, t0, valid, _ = _refine_case(np.random.default_rng(14),
                                            np.float32)
    R, t, k0, k1 = R0[0], t0[0], x0[0], x1[0]
    w = np.ones(120, np.float32)

    def jac(Rm, tm, a, b, wm, dtype):
        def residuals(p):
            Rn = Rm @ jr.so3_exp(p[:3])
            tn = tm + jr._tangent_basis(tm) @ p[3:]
            tn = tn / jnp.sqrt(jnp.sum(tn * tn) + 1e-24)
            return wm * jr.signed_sampson(a, b, jepi.skew(tn) @ Rn)
        return np.asarray(jax.jit(jax.jacfwd(residuals))(jnp.zeros(5, dtype)))

    with jax.enable_x64(False):
        J32 = jac(*map(jnp.asarray, (R, t, k0, k1, w)), jnp.float32)
        R32, _ = jax.jit(jr.refine_pose_sampson)(
            *map(jnp.asarray, (R, t, k0, k1)), jnp.float32((1 / 600) ** 2))
    assert np.isnan(J32).all()
    assert np.array_equal(np.asarray(R32), R)           # never moved
    Rp, tp = pr.refine_pose_sampson(_t(R), _t(t), _t(k0), _t(k1),
                                    (1 / 600) ** 2)
    assert np.array_equal(_np(Rp), R) and np.array_equal(_np(tp), t)
    with jax.enable_x64(True):
        J64 = jac(*(jnp.asarray(a, jnp.float64) for a in (R, t, k0, k1, w)),
                  jnp.float64)
    basis = pr._tangent_basis(_t(t))
    p0 = torch.zeros(5, 5)
    _, dr = torch.func.jvp(
        lambda p: pr._residuals(p, _t(R), _t(t), basis, _t(w), _t(k0),
                                _t(k1)), (p0,), (torch.eye(5),))
    J = _np(dr).T
    assert np.isfinite(J).all()
    assert np.abs(J - J64).max() < 1e-3 * np.abs(J64).max()


def _general(seed, b=1, n_true=200, n_slots=N, outlier_frac=0.3):
    d = pf.general_pose_pairs(b, torch.Generator().manual_seed(seed),
                              n_true=n_true, n_slots=n_slots,
                              outlier_frac=outlier_frac, hw=640,
                              focal=600.0)
    return {k: _np(v) for k, v in d.items()}


def _planar(seed, b=3):
    raw = pf.scene_pairs(128, b, seed, device="cpu")
    d = pf.planar_pose_pairs(raw, torch.Generator().manual_seed(seed + 1),
                             step=8, n_slots=N)
    return {k: _np(v) for k, v in d.items()}


def _run_both(d, seed, use_5pt, dtype, feed, hyps=HYPS, **kw):
    """JAX's estimate_pose pair by pair (keys seed, seed + 1, ...) and the
    port's on the whole batch with those keys' draws."""
    b = d["kpts0"].shape[0]
    x64 = dtype == np.float64
    want, by_stage = [], []
    with jax.enable_x64(x64):
        for i in range(b):
            key = jax.random.key(seed + i)
            by_stage.append(_jax_draws(key, hyps, d["kpts0"].shape[1]))
            res = jr.estimate_pose(
                *(jnp.asarray(d[k][i].astype(dtype)) for k in
                  ("kpts0", "kpts1")), jnp.asarray(d["valid"][i]),
                jnp.asarray(d["K"][i].astype(dtype)),
                jnp.asarray(d["K"][i].astype(dtype)), key,
                num_hypotheses=hyps, use_5pt=use_5pt, **kw)
            want.append({k: np.asarray(v) for k, v in res.items()})
    feed({s: np.stack([bs[s] for bs in by_stage]) for s in by_stage[0]})
    got = pr.estimate_pose(
        *(_t(d[k].astype(dtype)) for k in ("kpts0", "kpts1")),
        _t(d["valid"]), _t(d["K"].astype(dtype)), _t(d["K"].astype(dtype)),
        None, num_hypotheses=hyps, use_5pt=use_5pt, **kw)
    return {k: np.stack([w[k] for w in want]) for k in want[0]}, \
        {k: _np(v) for k, v in got.items()}


def _assert_same_pose(want, got, valid):
    assert np.array_equal(got["ok"], want["ok"])
    assert _deg_R(got["R"], want["R"]).max() < RANSAC_DEG
    assert _deg_t(got["t"], want["t"]).max() < RANSAC_DEG
    for i in range(len(valid)):
        agree = (got["inliers"][i] == want["inliers"][i])[valid[i]]
        assert agree.mean() >= MASK_AGREE, (i, agree.mean())
    assert not got["inliers"][~valid].any()


@pytest.mark.parametrize("use_5pt", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ransac_essential_matches_jax(use_5pt, dtype, feed):
    d = _general(20 + use_5pt)
    k0 = ((d["kpts0"][0] - 320) / 600).astype(dtype)
    k1 = ((d["kpts1"][0] - 320) / 600).astype(dtype)
    valid, thr = d["valid"][0], 1.0 / 600.0
    key = jax.random.key(21)
    with jax.enable_x64(dtype == np.float64):
        want = jr.ransac_essential(jnp.asarray(k0), jnp.asarray(k1),
                                   jnp.asarray(valid), thr, key,
                                   num_hypotheses=HYPS, use_5pt=use_5pt)
        want = {k: np.asarray(v) for k, v in want.items()}
        rng1, rng2, rng5 = jax.random.split(key, 3)
        g = {"round1": jax.random.gumbel(rng1, (HYPS, N)),
             "round2": jax.random.gumbel(rng2, (HYPS // 2, N)),
             "five_point": jax.random.gumbel(rng5, (32, N))}
    feed({k: np.asarray(v) for k, v in g.items()})
    got = pr.ransac_essential(_t(k0), _t(k1), _t(valid), thr, None,
                              num_hypotheses=HYPS, use_5pt=use_5pt)
    got = {k: _np(v) for k, v in got.items()}
    assert _deg_R(got["R"], want["R"]) < RANSAC_DEG
    assert _deg_t(got["t"], want["t"]) < RANSAC_DEG
    assert (got["inliers"] == want["inliers"])[valid].mean() >= MASK_AGREE


CASES = {
    # case: (inputs, seed)
    "general": (lambda: _general(30), 30),
    "padded": (lambda: _general(31, n_true=150, outlier_frac=0.2), 31),
    "planar": (lambda: _planar(32), 32),
    "few_points": (lambda: _general(33, n_true=4), 33),
    "batch_of_3": (lambda: _general(34, b=3), 34),
}


@pytest.mark.parametrize("use_5pt", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_estimate_pose_matches_jax(case, dtype, use_5pt, feed):
    make, seed = CASES[case]
    d = make()
    want, got = _run_both(d, seed, use_5pt, dtype, feed)
    _assert_same_pose(want, got, d["valid"])
    if case == "few_points":
        assert not got["ok"].any()


def test_estimate_pose_full_defaults_match_jax(feed):
    """JAX's defaults: 512 hypotheses, 8 LO candidates, the fallback."""
    d = _general(40, n_true=400, n_slots=512)
    want, got = _run_both(d, 40, None, np.float32, feed, hyps=512)
    _assert_same_pose(want, got, d["valid"])


@pytest.mark.parametrize("use_5pt", [False, True])
def test_estimate_pose_recovers_ground_truth(use_5pt):
    """The port in float32 (its refinement returns its input, as JAX's
    does) on its own draws: the JAX tests' bounds at 200 points, 30%
    outliers (tests/test_ransac.py)."""
    d = pf.general_pose_pairs(4, torch.Generator().manual_seed(50),
                              n_true=200, n_slots=N, hw=640, focal=600.0)
    res = pr.estimate_pose(d["kpts0"], d["kpts1"], d["valid"], d["K"],
                           d["K"], torch.Generator().manual_seed(51),
                           use_5pt=use_5pt)
    err_t, err_R = pepi.pose_error(d["T_0to1"], res["R"], res["t"])
    assert res["ok"].all()
    assert (err_R < 2.0).all(), err_R
    assert (err_t < 5.0).all(), err_t
    assert not (res["inliers"] & ~d["valid"]).any()


# --------------------------------------------------- the linear algebra --

def test_cpu_eigh_and_svd_are_jax_bit_for_bit():
    """On a CPU tensor ``eigh`` and ``svd3`` run LAPACK's syevd and gesdd,
    as JAX does on the CPU: the same bits on the 8-point normal matrices
    (whose null vectors move with the last bit) and on 3x3 matrices."""
    from oetr_tpu_torch.ops import small_eigh
    x0, x1, _ = _eight_samples(np.random.default_rng(15), h=256)
    A = np.stack([x1[..., 0] * x0[..., 0], x1[..., 0] * x0[..., 1],
                  x1[..., 0], x1[..., 1] * x0[..., 0],
                  x1[..., 1] * x0[..., 1], x1[..., 1], x0[..., 0],
                  x0[..., 1], np.ones_like(x0[..., 0])], -1)
    AtA = np.swapaxes(A, -1, -2) @ A
    M = np.random.default_rng(16).normal(size=(64, 3, 3)).astype(np.float32)
    with jax.enable_x64(False):
        wj, Vj = jax.jit(jax.vmap(jnp.linalg.eigh))(jnp.asarray(AtA))
        Uj, Sj, Vhj = jax.jit(jax.vmap(jnp.linalg.svd))(jnp.asarray(M))
    w, V = small_eigh.eigh(_t(AtA))
    assert np.array_equal(_np(w), np.asarray(wj))
    assert np.array_equal(_np(V), np.asarray(Vj))
    for got, want in zip(small_eigh.svd3(_t(M)), (Uj, Sj, Vhj)):
        assert np.array_equal(_np(got), np.asarray(want))


def test_svd3_from_eigh_is_an_svd():
    """The card's 3x3 SVD (eigh of AᵀA), run here with LAPACK's eigh: A =
    U S Vh with U a rotation, LAPACK's singular values, and the same
    essential projection and candidate motions."""
    from oetr_tpu_torch.ops import small_eigh
    rng = np.random.default_rng(17)
    A = _t(rng.normal(size=(200, 3, 3)).astype(np.float32))
    U, S, Vh = small_eigh.svd3_from_eigh(A)
    assert _rel(U @ torch.diag_embed(S) @ Vh, A) < 1e-5
    eye = np.eye(3)
    assert _rel(U.transpose(-1, -2) @ U, eye) < 1e-5
    assert _rel(Vh @ Vh.transpose(-1, -2), eye) < 1e-5
    assert (torch.linalg.det(U) > 0).all()
    Ul, Sl, Vhl = small_eigh.svd3(A)
    assert _rel(S, Sl) < 1e-5
    s110 = torch.tensor([1.0, 1.0, 0.0])
    assert _rel((U * s110) @ Vh, (Ul * s110) @ Vhl) < 1e-4
    T = _poses(rng, 20)
    E = _t(np.asarray(jepi.essential_from_pose(T)))
    lapack = pr.decompose_essential(E)
    real = pr.svd3
    try:
        pr.svd3 = small_eigh.svd3_from_eigh
        card = pr.decompose_essential(E)
    finally:
        pr.svd3 = real
    for i in range(20):
        _same_candidates(
            np.concatenate([_np(card[0][i]).reshape(4, 9),
                            _np(card[1][i])], -1),
            np.concatenate([_np(lapack[0][i]).reshape(4, 9),
                            _np(lapack[1][i])], -1))


def test_refine_pose_sampson_under_inference_mode():
    """A caller's inference_mode leaves the refinement as it is: the
    Jacobian is taken outside it (torch 2.11 gives zero tangents inside).
    In float64, where the refinement moves."""
    x0, x1, R0, t0, valid, _ = _refine_case(np.random.default_rng(18),
                                            np.float64)
    args = (_t(R0), _t(t0), _t(x0), _t(x1),
            torch.full((4,), (1 / 600) ** 2, dtype=torch.float64),
            _t(valid))
    R, t = pr.refine_pose_sampson(*args)
    with torch.inference_mode():
        Ri, ti = pr.refine_pose_sampson(*args)
    assert torch.equal(R, Ri) and torch.equal(t, ti)
    assert _deg_R(R, R0).min() > 0.05


def test_pose_parting_replays_and_reads_the_vote():
    """``pose_parting.recorded``, which the card's tests use to give the CPU
    the card's eigh and svd3 results: a run that replays its own record
    is the run, and the recorded vote names the route the result took
    (``VOTE_ROUTES``; the E route's pose where it won)."""
    from oetr_tpu_torch.pose_parting import recorded
    d = _general(21, b=2)
    k = {key: _t(v) for key, v in d.items()}
    call = lambda: pr.estimate_pose(k["kpts0"], k["kpts1"], k["valid"],
                                    k["K"], k["K"],
                                    torch.Generator().manual_seed(5),
                                    num_hypotheses=HYPS, use_5pt=False)
    with recorded() as log:
        want = call()
    with recorded(log) as again:
        got = call()
    for key in want:
        assert torch.equal(want[key], got[key]), key
    assert len(again["eigh"]) == len(log["eigh"]) > 0
    # A record whose vectors are rolled by one column is obeyed (with the
    # 5-point stage off, every hypothesis comes through eigh and svd3).
    rolled = dict(log, eigh=[(a, (w, V.roll(1, -1))) for a, (w, V)
                             in log["eigh"]],
                  svd3=[(a, (U.roll(1, -1), S, Vh)) for a, (U, S, Vh)
                        in log["svd3"]])
    with recorded(rolled):
        assert not torch.equal(call()["R"], want["R"])
    wins = log["_vote"][0][1]
    for pair, slot in enumerate(wins.tolist()):
        if pr.VOTE_ROUTES[slot] == "E":
            e = log["ransac_essential"][0][1]
            assert torch.equal(want["R"][pair], e["R"][pair])


def test_pose_parting_wide_lapack_and_spread(capsys):
    """``pose_parting.wide_lapack`` gives the estimator the same eigh and
    svd3 (LAPACK's float64 routines, rounded to float32): within float32's
    rounding of the plain ones on well-conditioned matrices, and in the
    input's dtype; ``parting`` is zero for a result against itself; and
    ``--spread`` runs on the CPU, a line per problem and stage and the
    count of cases beyond the bound last."""
    import json

    from oetr_tpu_torch import pose_parting
    from oetr_tpu_torch.ops import small_eigh
    rng = np.random.default_rng(18)
    M = rng.normal(size=(32, 9, 9)).astype(np.float32)
    A = _t(M @ np.swapaxes(M, -1, -2) + 9.0 * np.eye(9, dtype=np.float32))
    B = _t(rng.normal(size=(32, 3, 3)).astype(np.float32))
    with pose_parting.wide_lapack():
        w, V = pr.eigh(A)
        U, S, Vh = pr.svd3(B)
        assert phom.eigh is pr.eigh
    assert pr.eigh is small_eigh.eigh and pr.svd3 is small_eigh.svd3
    assert all(x.dtype == torch.float32 for x in (w, V, U, S, Vh))
    wl, _ = small_eigh.eigh(A)
    _, Sl, _ = small_eigh.svd3(B)
    assert _rel(w, wl) < 1e-5 and _rel(S, Sl) < 1e-5
    assert _rel(A @ V, V * w[:, None, :]) < 1e-5
    assert _rel(U @ torch.diag_embed(S) @ Vh, B) < 1e-5
    d = _general(22, b=2)
    k = {key: _t(v) for key, v in d.items()}
    res = pr.estimate_pose(k["kpts0"], k["kpts1"], k["valid"], k["K"],
                           k["K"], torch.Generator().manual_seed(5),
                           num_hypotheses=HYPS, use_5pt=False)
    deg, rel = pose_parting.parting(k["T_0to1"], res, res)
    assert deg.shape == rel.shape == (2,)
    assert not deg.any() and not rel.any()
    assert pose_parting.main(["--spread", "--problems", "1", "--pairs", "1",
                              "--true", "60", "--slots", "64"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["use_5pt"] for x in lines[:2]] == [False, True]
    assert lines[-1]["spread"]["cases"] == 2
