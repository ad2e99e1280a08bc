"""The port's SfM (``oetr_tpu_torch/sfm``) against the JAX package, on the
CPU: COLMAP files and databases, tracks, DLT triangulation, the residuals
and their Jacobians, bundle adjustment, ``reconstruct`` with its exports,
and the demo's rig.

The same seeded numpy inputs go to both sides. JAX's ``bundle_adjust`` and
Jacobians run jitted, as ``reconstruct`` runs them, with x64 off for the
float32 cases (``tests/conftest.py`` turns it on; under it JAX's float32
BA widens ``Hcc + lam * eye(6)`` to float64) and on for float64.

JAX's float32 quirk, copied: ``jax.jacfwd`` through ``so3_exp`` at a
rotation of exactly zero forms θ⁻⁴ = inf (θ = 1e-12) and NaN · 0, so every
Jacobian entry of that camera's observations is NaN and every LM step is
rejected: the cost stays at cost0. In float64 it moves. The port's
``so3_exp`` divides with JAX's derivative rule to get the same NaN.

Bounds:
  COLMAP files, database rows       byte-equal (same inputs)
  pair ids, qvec <-> R              equal
  build_tracks, view tables         equal array by array
  triangulate_points                1e-5 (f32; or twice JAX's own spread
                                    under a one-ulp nudge of the pixels),
                                    1e-10 (f64) of max(1, |X|)
  residuals                         1e-6 of the largest |pixel|
  Jacobians                         1e-6 of max(1, |ref|); f32 NaN pattern
                                    equal (all of a zero-rotation camera's)
  bundle_adjust cost_history        1e-4 relative to cost0
  bundle_adjust cams / pts          f64: 1e-8; f32: twice JAX's own
                                    spread under a one-ulp nudge, at
                                    least BA_F32
  reconstruct                       tracks and point_valid equal; final
                                    cost 1e-4; cameras through the ATE
  the demo's rig                    images within one level on <= 0.1% of
                                    pixels; K, cameras, depths equal
"""
import importlib
import sqlite3
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.evalx import trajectory as jtraj
from oetr_tpu.geometry import ransac as jransac
from oetr_tpu_torch.evalx import trajectory as ptraj
from oetr_tpu_torch.geometry import ransac as pransac

jba = importlib.import_module("oetr_tpu.sfm.ba")
jrec = importlib.import_module("oetr_tpu.sfm.reconstruct")
jcm = importlib.import_module("oetr_tpu.sfm.colmap_model")
jdb = importlib.import_module("oetr_tpu.sfm.database")
pba = importlib.import_module("oetr_tpu_torch.sfm.ba")
prec = importlib.import_module("oetr_tpu_torch.sfm.reconstruct")
pcm = importlib.import_module("oetr_tpu_torch.sfm.colmap_model")
pdb = importlib.import_module("oetr_tpu_torch.sfm.database")
pdemo = importlib.import_module("oetr_tpu_torch.sfm.demo")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRI_TOL = {np.float32: 1e-5, np.float64: 1e-10}
JAC_TOL = 1e-6
COST_RTOL = 1e-4
BA_F64 = 1e-8
# float32 floors of the cameras' and points' bound: some tens of ulps at
# their magnitudes (~1 and ~8), where the spread below is smaller.
BA_F32 = (2e-5, 1e-4)
LEVEL_SHARE = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


# ------------------------------------------------------------- COLMAP I/O

def test_pair_ids_equal():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 2 ** 31 - 1, (200, 2)).tolist()
    ids += [[1, 2], [2, 1], [5, 5], [100, 100000]]
    for a, b in ids:
        pid = pdb.image_ids_to_pair_id(a, b)
        assert pid == jdb.image_ids_to_pair_id(a, b)
        assert pdb.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid)
        assert pdb.pair_id_to_image_ids(pid) == (min(a, b), max(a, b))


def test_qvec_roundtrip_equal():
    from scipy.spatial.transform import Rotation

    for R in Rotation.random(64, random_state=1).as_matrix():
        q = pcm.rotmat2qvec(R)
        np.testing.assert_array_equal(q, jcm.rotmat2qvec(R))
        np.testing.assert_array_equal(pcm.qvec2rotmat(q), jcm.qvec2rotmat(q))
        np.testing.assert_allclose(pcm.qvec2rotmat(q), R, atol=1e-9)


def _model(mod, rng):
    cameras = {1: mod.Camera(1, "PINHOLE", 640, 480,
                             np.array([600.0, 600.0, 320.0, 240.0])),
               2: mod.Camera(2, "SIMPLE_RADIAL", 320, 240,
                             np.array([300.0, 160.0, 120.0, 0.01]))}
    images = {
        1: mod.Image(1, np.array([1.0, 0, 0, 0]), np.array([0.0, 0, 0]), 1,
                     "a.jpg", rng.uniform(0, 10, (3, 2)),
                     np.array([1, 2, -1])),
        2: mod.Image(2, mod.rotmat2qvec(np.eye(3)), np.array([1.0, 0, 0]),
                     2, "b.jpg", np.zeros((0, 2)), np.zeros(0, np.int64)),
    }
    points = {1: mod.Point3D(1, np.array([0.0, 1, 5]), np.array([255, 0, 0]),
                             0.5, np.array([1]), np.array([0])),
              2: mod.Point3D(2, np.array([1.0, 1, 6]), np.array([0, 255, 0]),
                             0.1, np.array([1, 2]), np.array([1, 0]))}
    return cameras, images, points


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_files_byte_equal(tmp_path, ext):
    """Both writers on the same model give the same bytes; the port reads
    back what was written."""
    for side, mod in (("jax", jcm), ("port", pcm)):
        mod.write_model(*_model(mod, np.random.default_rng(3)),
                        str(tmp_path / side), ext)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == (3 if ext == ".bin" else 2)
    for name in files:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    cams, imgs, pts = pcm.read_model(str(tmp_path / "port"), ext)
    cams_j, imgs_j, pts_j = jcm.read_model(str(tmp_path / "jax"), ext)
    assert cams.keys() == cams_j.keys() and imgs.keys() == imgs_j.keys()
    for k in cams:
        assert cams[k].model == cams_j[k].model
        np.testing.assert_array_equal(cams[k].params, cams_j[k].params)
    for k in imgs:
        assert imgs[k].name == imgs_j[k].name
        for f in ("qvec", "tvec", "xys", "point3D_ids"):
            np.testing.assert_array_equal(getattr(imgs[k], f),
                                          getattr(imgs_j[k], f))
    if ext == ".bin":
        for k in pts:
            for f in ("xyz", "rgb", "image_ids", "point2D_idxs"):
                np.testing.assert_array_equal(getattr(pts[k], f),
                                              getattr(pts_j[k], f))


def _tables(path):
    con = sqlite3.connect(str(path))
    try:
        return {t: con.execute(f"SELECT * FROM {t}").fetchall()
                for (t,) in con.execute(
                    "SELECT name FROM sqlite_master WHERE type='table' "
                    "ORDER BY name")}
    finally:
        con.close()


def test_database_tables_and_blobs_equal(tmp_path):
    rng = np.random.default_rng(4)
    kpts = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    m = np.stack([np.arange(30), np.arange(30) + 5], axis=1)
    desc = rng.integers(0, 255, (50, 128)).astype(np.uint8)
    for side, mod in (("jax", jdb), ("port", pdb)):
        db = mod.COLMAPDatabase.connect(str(tmp_path / f"{side}.db"))
        db.create_tables()
        cam = db.add_camera(1, 640, 480, np.array([600.0, 600, 320, 240]))
        im1 = db.add_image("a.jpg", cam)
        im2 = db.add_image("b.jpg", cam, prior_q=(0.5, 0.5, 0.5, 0.5))
        db.add_keypoints(im1, kpts)
        db.add_keypoints(im2, np.concatenate([kpts + 1, kpts], 1))
        db.add_descriptors(im1, desc)
        db.add_matches(im2, im1, m)
        db.add_two_view_geometry(im1, im2, m, F=np.arange(9.0).reshape(3, 3))
        db.commit()
        np.testing.assert_array_equal(db.read_keypoints(im1), kpts)
        np.testing.assert_array_equal(db.read_matches(im2, im1), m)
        np.testing.assert_array_equal(db.read_matches(im1, im2), m[:, ::-1])
        db.close()
    tj, tp = _tables(tmp_path / "jax.db"), _tables(tmp_path / "port.db")
    assert tj == tp
    assert all(len(tp[t]) for t in ("cameras", "images", "keypoints",
                                    "descriptors", "matches",
                                    "two_view_geometries"))


# ----------------------------------------------------------------- tracks

def _track_inputs(rng, n_img=5, n_kp=80, n_match=10):
    kps = [rng.uniform(0, 100, (n_kp, 2)).astype(np.float32)
           for _ in range(n_img)]
    matches = {}
    for i in range(n_img):
        for j in range(i + 1, n_img):
            a = rng.choice(n_kp, n_match, replace=False)
            b = rng.choice(n_kp, n_match, replace=False)
            matches[(i, j)] = np.stack([a, b])
    return kps, matches


def _tracks_equal(a, b):
    assert a.num_tracks == b.num_tracks
    for f in ("obs_cam", "obs_pt", "obs_kp", "obs_uv"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("min_len", [2, 3])
def test_build_tracks_equal(min_len):
    """Random matches (many merge conflicts), JAX's conflict example, and
    no match at all: equal array by array, ids in the same order."""
    kps, matches = _track_inputs(np.random.default_rng(5))
    tj = jrec.build_tracks(kps, matches, min_len)
    tp = prec.build_tracks(kps, matches, min_len)
    _tracks_equal(tp, tj)
    assert tp.num_tracks > 10
    for mv in (2, 4):
        for x, y in zip(prec._tracks_to_view_arrays(tp, mv),
                        jrec._tracks_to_view_arrays(tj, mv)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)

    kps = [np.random.default_rng(6).uniform(0, 100, (4, 2)).astype(
        np.float32) for _ in range(3)]
    conflict = {(0, 1): np.array([[0, 1], [0, 1]]),
                (1, 2): np.array([[0], [2]]), (0, 2): np.array([[0], [3]])}
    _tracks_equal(prec.build_tracks(kps, conflict, min_len),
                  jrec.build_tracks(kps, conflict, min_len))
    _tracks_equal(prec.build_tracks(kps, {}, min_len),
                  jrec.build_tracks(kps, {}, min_len))


# ------------------------------------------------- geometry of the problem

def _ba_problem(rng, n_cams=4, n_pts=60, noise=0.5, zero_rot=False):
    """tests/test_sfm.py's problem: points seen by every camera of a short
    rig, initial cameras and points perturbed, camera 0 exact."""
    from scipy.spatial.transform import Rotation

    K = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]]),
                (n_cams, 1, 1))
    cams = []
    for i in range(n_cams):
        w = Rotation.from_euler("xyz", rng.uniform(-5, 5, 3),
                                degrees=True).as_rotvec()
        t = np.array([i * 0.5, 0.0, 0.0]) + rng.normal(0, 0.05, 3)
        cams.append(np.concatenate([w, t]))
    cams = np.stack(cams)
    if zero_rot:
        cams[0, :3] = 0.0
    pts = rng.uniform(-2, 2, (n_pts, 3)) + [0, 0, 8.0]
    oc, op = np.meshgrid(np.arange(n_cams), np.arange(n_pts), indexing="ij")
    oc, op = oc.reshape(-1), op.reshape(-1)
    R = Rotation.from_rotvec(cams[:, :3]).as_matrix()
    x = np.einsum("oij,oj->oi", R[oc], pts[op]) + cams[oc, 3:]
    uv = np.einsum("oij,oj->oi", K[oc], x / x[:, 2:])[:, :2]
    uv = uv + rng.normal(0, noise, uv.shape)
    cams_init = cams + rng.normal(0, 0.01, cams.shape)
    cams_init[0] = cams[0]
    pts_init = pts + rng.normal(0, 0.05, pts.shape)
    return cams_init, pts_init, K, oc, op, uv


def _args(prob, dt):
    ci, pi, K, oc, op, uv = prob
    return [ci.astype(dt), pi.astype(dt), K.astype(dt), oc.astype(np.int32),
            op.astype(np.int32), uv.astype(dt), np.ones(len(oc), bool)]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_triangulate_points_matches_jax(dt):
    """Tracks of 2-8 views with padded views, through LAPACK on both sides
    (the port's CPU eigh is the syevd JAX calls); and the single-point
    form. Within TRI_TOL of max(1, |X|), or in float32, where a 2-view
    track of this rig (0.5 units of baseline at 8) moves with the last bit
    of its AᵀA, within twice what JAX's own points move when obs_uv is
    nudged by one ulp (1.7e-5 here, the port 1.95e-5)."""
    rng = np.random.default_rng(7)
    ci, pi, K, oc, op, uv = _ba_problem(rng, n_cams=8, n_pts=50,
                                        noise=0.3)
    n_views = rng.integers(2, 9, 50)
    cams = np.tile(ci[None], (50, 1, 1)).astype(dt)
    Ks = np.tile(K[None], (50, 1, 1, 1)).astype(dt)
    uvs = uv.reshape(8, 50, 2).transpose(1, 0, 2).astype(dt)
    valid = np.arange(8)[None] < n_views[:, None]
    with jax.enable_x64(dt == np.float64):
        tri = lambda u: np.asarray(jba.triangulate_points(
            jnp.asarray(cams), jnp.asarray(Ks), jnp.asarray(u),
            jnp.asarray(valid)))
        xj = tri(uvs)
        xn = tri(np.nextafter(uvs, dt(np.inf)))
        x1 = np.asarray(jba.triangulate_dlt(
            jnp.asarray(cams[0]), jnp.asarray(Ks[0]), jnp.asarray(uvs[0]),
            jnp.asarray(valid[0])))
    xp = pba.triangulate_points(_t(cams), _t(Ks), _t(uvs), _t(valid))
    assert xp.dtype == (torch.float32 if dt == np.float32 else torch.float64)
    tol = TRI_TOL[dt]
    if dt == np.float32:
        tol = max(tol, 2 * _rel(xn, xj))
    assert _rel(xp, xj) < tol
    p1 = pba.triangulate_dlt(_t(cams[0]), _t(Ks[0]), _t(uvs[0]),
                             _t(valid[0]))
    assert _rel(p1, x1) < tol


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_residuals_and_jacobians_match_jax(dt):
    """Residuals and per-observation Jacobians within JAC_TOL, with an
    observation masked out; in float32 with camera 1 at exactly zero
    rotation, every Jc entry of its observations is NaN on both sides and
    Jp stays finite; in float64 nothing is NaN."""
    rng = np.random.default_rng(8)
    ci, pi, K, oc, op, uv = _ba_problem(rng, n_cams=3, n_pts=20)
    ci[1, :3] = 0.0
    args = _args((ci, pi, K, oc, op, uv), dt)
    args[6][5] = False
    with jax.enable_x64(dt == np.float64):
        ja = [jnp.asarray(a) for a in args]
        rj = np.asarray(jax.jit(jba.residuals)(*ja))
        Jcj, Jpj = (np.asarray(x) for x in jax.jit(jba._obs_jacobians)(
            *ja[:6], ja[6].astype(ja[0].dtype)))
    ta = [_t(a) for a in args]
    ta[3], ta[4] = ta[3].long(), ta[4].long()
    rp = pba.residuals(*ta)
    Jcp, Jpp = pba._obs_jacobians(*ta[:6], ta[6].to(ta[0].dtype))
    assert rp.dtype == Jcp.dtype == Jpp.dtype == ta[0].dtype
    # A residual is a projection (~300-600 px) less a pixel: its rounding
    # lives at the pixels' scale.
    assert np.abs(rp.numpy() - rj).max() < JAC_TOL * np.abs(uv).max()
    nan_j, nan_p = np.isnan(Jcj), torch.isnan(Jcp).numpy()
    np.testing.assert_array_equal(nan_p, nan_j)
    if dt == np.float32:
        on_cam1 = (oc == 1) & args[6]
        assert nan_j[on_cam1].all() and not nan_j[~on_cam1].any()
    else:
        assert not nan_j.any()
    assert not np.isnan(Jpj).any() and not torch.isnan(Jpp).any()
    fin = ~nan_j
    assert _rel(Jcp.numpy()[fin], Jcj[fin]) < JAC_TOL
    assert _rel(Jpp, Jpj) < JAC_TOL


def test_so3_exp_derivatives_match_jax():
    """``so3_exp``'s forward-mode Jacobian and reverse-mode gradient equal
    JAX's at random rotations in both dtypes; at zero in float32 the
    Jacobian is NaN on both sides, in float64 finite; the values are the
    plain division's."""
    rng = np.random.default_rng(9)
    for dt, x64 in ((np.float32, False), (np.float64, True)):
        for w in list(rng.normal(0, 0.5, (4, 3))) + [np.zeros(3)]:
            w = w.astype(dt)
            with jax.enable_x64(x64):
                Jj = np.asarray(jax.jacfwd(jransac.so3_exp)(jnp.asarray(w)))
                gj = np.asarray(jax.grad(
                    lambda v: jnp.sum(jransac.so3_exp(v) * jnp.arange(9.0)
                                      .reshape(3, 3).astype(v.dtype)))(
                        jnp.asarray(w)))
                Rj = np.asarray(jransac.so3_exp(jnp.asarray(w)))
            wt = _t(w)
            Jp = torch.func.jacfwd(pransac.so3_exp)(wt[None])[0, :, :, 0]
            np.testing.assert_array_equal(torch.isnan(Jp).numpy(),
                                          np.isnan(Jj))
            if not np.isnan(Jj).any():
                assert _rel(Jp, Jj) < JAC_TOL
            wg = wt.clone().requires_grad_(True)
            (pransac.so3_exp(wg) * torch.arange(9.0, dtype=wg.dtype)
             .reshape(3, 3)).sum().backward()
            if not np.isnan(gj).any():
                assert _rel(wg.grad, gj) < JAC_TOL
            assert _rel(pransac.so3_exp(wt), Rj) < JAC_TOL
        zero = torch.zeros(1, 3, dtype=torch.float32 if dt == np.float32
                           else torch.float64)
        J0 = torch.func.jacfwd(pransac.so3_exp)(zero)
        assert torch.isnan(J0).all() == (dt == np.float32)


# -------------------------------------------------------- bundle adjustment

def _custom_mask(n_cams, dt):
    """Camera 0 fixed and camera 1's x translation too: the scene's scale
    is pinned."""
    m = np.ones((n_cams, 6), dt)
    m[0] = 0.0
    m[1, 3] = 0.0
    return m


def _run_ba(args, dt, mask=None, **kw):
    with jax.enable_x64(dt == np.float64):
        ja = [jnp.asarray(a) for a in args]
        rj = jba.bundle_adjust(
            *ja, update_mask=None if mask is None else jnp.asarray(mask),
            **kw)
        rj = {k: np.asarray(v) for k, v in rj.items()}
    ta = [_t(a) for a in args]
    rp = pba.bundle_adjust(
        *ta, update_mask=None if mask is None else _t(mask), **kw)
    return rj, rp


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("masked", [False, True])
def test_bundle_adjust_matches_jax(dt, huber, masked):
    """8 LM steps of 25 CG iterations: the cost history within COST_RTOL of
    cost0; the cameras and points within BA_F64 (f64) or, in f32, twice
    what JAX's own move when obs_uv is nudged by one ulp (with camera 0
    fixed the scene's scale is free, and the converged cameras slide along
    it with the rounding: up to 1e-2, points 6e-2; pinned by the custom
    mask, where the bound is BA_F32's floor); the cost below a fifth of cost0 on both sides; frozen
    translations untouched (a frozen rotation goes through exp and log)."""
    prob = _ba_problem(np.random.default_rng(10))
    args = _args(prob, dt)
    mask = _custom_mask(4, dt) if masked else None
    kw = dict(iters=8, cg_iters=25, huber_delta=huber)
    rj, rp = _run_ba(args, dt, mask, **kw)
    assert rp["cams"].dtype == rp["cost_history"].dtype == _t(args[0]).dtype
    hj, hp = rj["cost_history"], rp["cost_history"].numpy()
    assert hp.shape == (9,)
    assert np.abs(hp - hj).max() / hj[0] < COST_RTOL
    assert hj[-1] < 0.2 * hj[0] and hp[-1] < 0.2 * hp[0]
    if dt == np.float64:
        cams_tol = pts_tol = BA_F64
    else:
        nudged = list(args)
        nudged[5] = np.nextafter(args[5], dt(np.inf))
        rn, _ = _run_ba(nudged, dt, mask, **kw)
        cams_tol = max(BA_F32[0], 2 * np.abs(rn["cams"] - rj["cams"]).max())
        pts_tol = max(BA_F32[1], 2 * np.abs(rn["pts"] - rj["pts"]).max())
    assert np.abs(rp["cams"].numpy() - rj["cams"]).max() <= cams_tol
    assert np.abs(rp["pts"].numpy() - rj["pts"]).max() <= pts_tol
    default = np.ones((4, 6), dt)
    default[0] = 0.0
    frozen = (mask if masked else default) == 0
    frozen[:, :3] = False
    np.testing.assert_array_equal(rp["cams"].numpy()[frozen],
                                  args[0][frozen])
    assert float(rp["cost0"]) == hp[0] and float(rp["cost"]) == hp[-1]


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_bundle_adjust_zero_rotation_quirk(dt):
    """Camera 0 (frozen by the default gauge) at exactly zero rotation: in
    float32 neither side ever moves (cost stays at cost0 for every step,
    cameras and points as given); in float64 both fall, and agree."""
    prob = _ba_problem(np.random.default_rng(11), zero_rot=True)
    args = _args(prob, dt)
    rj, rp = _run_ba(args, dt, iters=6, cg_iters=20)
    hj, hp = rj["cost_history"], rp["cost_history"].numpy()
    if dt == np.float32:
        assert (hj == hj[0]).all() and (hp == hp[0]).all()
        assert abs(hp[0] - hj[0]) / hj[0] < COST_RTOL
        np.testing.assert_array_equal(rp["cams"].numpy(), args[0])
        np.testing.assert_array_equal(rp["pts"].numpy(), args[1])
    else:
        assert hj[-1] < 0.2 * hj[0] and hp[-1] < 0.2 * hp[0]
        assert np.abs(hp - hj).max() / hj[0] < COST_RTOL
        assert np.abs(rp["cams"].numpy() - rj["cams"]).max() < BA_F64


def test_bundle_adjust_under_inference_mode():
    """Under ``torch.inference_mode`` the Jacobians still come out (taken
    outside it) and the result is the same bits as with grad mode on."""
    args = [_t(a) for a in _args(_ba_problem(np.random.default_rng(12)),
                                 np.float32)]
    ref = pba.bundle_adjust(*args, iters=3, cg_iters=10)
    with torch.inference_mode():
        inf = pba.bundle_adjust(*[a.clone() for a in args], iters=3,
                                cg_iters=10)
    assert inf["cost"] < 0.5 * inf["cost0"]
    for k in ("cams", "pts", "cost_history"):
        assert torch.equal(inf[k], ref[k]), k


# ------------------------------------------------------------ reconstruct

def _make_scene(rng, n_cams=6, n_pts=80, noise_px=0.5):
    """tests/test_reconstruct.py's scene: a point cloud seen by every camera
    of a wide arc, identity matches between every pair of images."""
    pts = rng.uniform(-1, 1, (n_pts, 3)) + np.array([0, 0, 6.0])
    K = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]]),
                (n_cams, 1, 1))
    cams_gt = np.asarray([np.concatenate([
        [0.0, 0.7 * (i / (n_cams - 1) - 0.5), 0.02 * i],
        [4.0 * (i / (n_cams - 1) - 0.5), 0.1 * i, 0.2 * i]])
        for i in range(n_cams)])
    keypoints = []
    for i in range(n_cams):
        R = ptraj.so3_exp_np(cams_gt[i][:3])
        pc = pts @ R.T + cams_gt[i][3:]
        uv = (pc / pc[:, 2:3]) @ K[i].T
        kp = uv[:, :2] + rng.normal(0, noise_px, (n_pts, 2))
        keypoints.append(kp.astype(np.float32))
    idx = np.arange(n_pts)
    matches = {(i, j): np.stack([idx, idx]) for i in range(n_cams)
               for j in range(i + 1, n_cams)}
    return pts, K, cams_gt, keypoints, matches


def test_reconstruct_and_exports_match_jax(tmp_path):
    """tests/test_reconstruct.py's scene (6 cameras, 80 points) through both
    ``reconstruct``s (float32, 2 rounds, Huber on): equal tracks and
    point_valid, the final cost within COST_RTOL, the ATE of each within
    1e-3 of the other's and below half the start's. Then both exporters on
    the port's result: cameras.bin, points3D.bin and the text cameras
    byte-equal, images.bin's quaternions within 1e-6 (each side's so3_exp
    rounds its sines apart), the databases equal."""
    rng = np.random.default_rng(13)
    pts, K, cams_gt, kps, matches = _make_scene(rng)
    init = cams_gt + np.concatenate([rng.normal(0, 0.01, (6, 3)),
                                     rng.normal(0, 0.05, (6, 3))], axis=1)
    init[0] = cams_gt[0]
    kw = dict(ba_iters=10, cg_iters=40, rounds=2)
    with jax.enable_x64(False):
        rj = jrec.reconstruct(kps, matches, K, init, **kw)
    rp = prec.reconstruct(kps, matches, K, init, device="cpu", **kw)
    _tracks_equal(rp["tracks"], rj["tracks"])
    np.testing.assert_array_equal(rp["point_valid"], rj["point_valid"])
    assert rp["cams"].dtype == rp["pts"].dtype == np.float32
    assert rp["cost_history"].shape == rj["cost_history"].shape == (22,)
    assert abs(rp["cost_history"][-1] - rj["cost_history"][-1]) < (
        COST_RTOL * rj["cost_history"][0])
    ate0 = ptraj.absolute_trajectory_error(init, cams_gt)["ate_rmse"]
    ate_j = jtraj.absolute_trajectory_error(rj["cams"], cams_gt)["ate_rmse"]
    ate_p = ptraj.absolute_trajectory_error(rp["cams"], cams_gt)["ate_rmse"]
    assert ate_p < 0.5 * ate0 and ate_j < 0.5 * ate0
    assert abs(ate_p - ate_j) < 1e-3

    names = [f"im{i}.jpg" for i in range(len(K))]
    two_view = {pair: {"matches": m, "E": np.eye(3)}
                for pair, m in list(matches.items())[:3]}
    for side, mod in (("jax", jrec), ("port", prec)):
        with jax.enable_x64(False):
            mod.export_colmap(str(tmp_path / side), names, K, rp)
            mod.export_colmap(str(tmp_path / f"{side}_txt"), names, K, rp,
                              ext=".txt")
        mod.export_database(str(tmp_path / f"{side}.db"), names, K, kps,
                            matches, two_view=two_view)
    for name in ("cameras.bin", "points3D.bin"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    assert ((tmp_path / "jax_txt" / "cameras.txt").read_bytes()
            == (tmp_path / "port_txt" / "cameras.txt").read_bytes())
    _, ij, pj = pcm.read_model(str(tmp_path / "jax"))
    cams_p, ip, pp = pcm.read_model(str(tmp_path / "port"))
    assert len(cams_p) == 6 and len(pp) == int(rp["point_valid"].sum())
    for k in ij:
        assert np.abs(ip[k].qvec - ij[k].qvec).max() < 1e-6
        np.testing.assert_array_equal(ip[k].tvec, ij[k].tvec)
    assert _tables(tmp_path / "jax.db") == _tables(tmp_path / "port.db")


def test_reconstruct_refuses_no_tracks():
    kps = [np.zeros((3, 2), np.float32)] * 2
    with pytest.raises(ValueError, match="no tracks"):
        prec.reconstruct(kps, {}, np.tile(np.eye(3), (2, 1, 1)),
                         np.zeros((2, 6)), device="cpu")


# -------------------------------------------------------------- the demo

def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "sfm_demo_script", ROOT / "scripts" / "sfm_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_render_rig_matches_jax_demo():
    """scripts/sfm_demo.py::render_rig (cv2's blur and remap) against the
    port's (numpy), 4 views of 160², pixel noise on."""
    j = _jax_demo().render_rig(4, 160, 3, arc_deg=45.0, noise=6.0)
    p = pdemo.render_rig(4, 160, 3, arc_deg=45.0, noise=6.0)
    assert p[0].shape == j[0].shape == (4, 160, 160, 3)
    assert p[0].dtype == np.uint8
    diff = np.abs(p[0].astype(int) - j[0].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= LEVEL_SHARE
    np.testing.assert_array_equal(p[1], j[1])
    np.testing.assert_array_equal(p[2], j[2])
    for a, b in zip(p[3], j[3]):
        np.testing.assert_array_equal(a, b)


def test_demo_on_depth_correspondences():
    """The demo's steps on the CPU at a small rig (6 views of 160², 24°
    arc, span 2): the depth correspondences, per-edge pose (every edge
    kept), the chain, both reconstruct rows and the exports. The chain row
    starts camera 0 at the identity, so its float32 BA never moves; the
    odometry row's ATE falls below half its start's (the demo's gate)."""
    n, span = 6, 2
    images, K, gt, depths = pdemo.render_rig(n, 160, 3, arc_deg=24.0)
    edges = pdemo.edges_within(n, span)
    kps, cands = pdemo.depth_candidates(depths, K, gt, edges, seed=3)
    assert set(cands) == set(edges)
    for (i, j), (ia, ib, p0, p1) in cands.items():
        assert len(ia) == len(ib) >= pdemo.MIN_CANDIDATES
        np.testing.assert_array_equal(p0, kps[i][ia])
        np.testing.assert_array_equal(p1, kps[j][ib])
    matches, rel = pdemo.two_view(cands, K, "cpu")
    assert set(matches) == set(edges)
    init = pdemo.chain_init(kps, matches, rel, K, n, "cpu")
    assert init.shape == (n, 6) and (init[0] == 0).all()
    odo = pdemo.odometry_init(gt, 3)
    recon, rec2, ate = pdemo.reconstruct_rows(kps, matches, K, gt, init,
                                              odo, span, 8, "cpu")
    h = recon["cost_history"]
    assert (h == h[0]).all()
    assert rec2["cost_history"][-1] < 0.1 * rec2["cost_history"][0]
    fields = pdemo.summary(recon, ate)
    assert fields["ate_rmse_ba"] == fields["ate_rmse_init"]
    assert fields["ate_rmse_odometry_ba"] < 0.5 * fields[
        "ate_rmse_odometry_init"]
    assert fields["ba_beats_init"]


def test_demo_cli(tmp_path, capsys):
    """``python -m oetr_tpu_torch.sfm.demo`` on the host's SIFT (cv2) at a
    small rig prints the JSON line of scripts/sfm_demo.py's keys, in its
    order, with the exports written; a learned matcher without its store
    stops with FileNotFoundError (they run in
    ``test_torch_port_sfm_learned.py``)."""
    import json

    pdemo.main(["--n_views", "6", "--hw", "160", "--arc_deg", "24",
                "--max_span", "2", "--ba_iters", "6", "--device", "cpu",
                "--export", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == [
        "metric", "n_views", "hw", "matcher", "edges_matched", "tracks",
        "tracks_valid", "ate_rmse_init", "ate_rmse_ba",
        "rot_err_mean_deg_init", "rot_err_mean_deg_ba",
        "ate_rmse_odometry_init", "ate_rmse_odometry_ba",
        "rot_err_mean_deg_odometry_init", "rot_err_mean_deg_odometry_ba",
        "ba_beats_init", "colmap_export_ok", "export_dir", "wall_s"]
    assert line["colmap_export_ok"] and line["edges_matched"] >= 5
    cams, images, _ = pcm.read_model(str(tmp_path))
    assert len(cams) == len(images) == 6
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        pdemo.main(["--matcher", "sp_sg", "--device", "cpu", "--n_views",
                    "3", "--hw", "160", "--ckpt_dir", str(tmp_path / "no")])


def test_demo_learned_matcher_candidates():
    """``candidates_sp_sg`` and ``candidates_loftr`` on the caller's seeded
    modules (CPU, small widths; threshold 0 so the seeded matchers keep
    matches): each edge's index pairs point into its views' keypoints, as
    the two-view step reads them; LoFTR's target side keeps one
    observation a cell and its positions continuous."""
    from oetr_tpu_torch.models.loftr import build_loftr
    from oetr_tpu_torch.models.superglue import build_superglue
    from oetr_tpu_torch.models.superpoint import build_superpoint

    images = pdemo.render_rig(3, 64, 1, arc_deg=6.0)[0]
    edges = pdemo.edges_within(3, 2)
    sp = build_superpoint("cpu", max_keypoints=64, keypoint_threshold=0.0,
                          descriptor_dim=64)
    sg = build_superglue("cpu", descriptor_dim=64, gnn_layers=2,
                         match_threshold=0.0)
    lf = build_loftr("cpu", d_coarse=32, d_fine=16, coarse_layers=1,
                     fine_layers=1, nhead=4, match_threshold=0.0,
                     max_matches=32)
    for kps, cands in (pdemo.candidates_sp_sg(images, edges, sp, sg),
                       pdemo.candidates_loftr(images, edges, lf)):
        assert len(kps) == 3 and set(cands) == set(edges)
        assert sum(len(c[0]) for c in cands.values()) > 0
        for (i, j), (ia, ib, p0, p1) in cands.items():
            assert len(ia) == len(ib) == len(p0) == len(p1)
            np.testing.assert_array_equal(p0, kps[i][ia])
            assert (ib >= 0).all() and (ib < len(kps[j])).all()
    for ia, ib, _, _ in cands.values():
        assert len(set(ib.tolist())) == len(ib)
