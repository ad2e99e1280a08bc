"""The port's evaluation package against the JAX package, on the CPU:
metrics, trajectory, HPatches, IMC math, per-pair validation, pair lists,
h5 result files, dataset utilities and the MegaDepth / IMC / HPatches
harnesses.

The same numpy inputs go through both. Where JAX's estimator draws random
numbers, the port draws JAX's: its one draw function, ``draws.gumbel``,
returns ``jax.random.gumbel`` of the stage's key (the splits of
``oetr_tpu/geometry/ransac.py:208,441``) at the shape asked for. JAX runs
with x64 off, as in production, where its Gauss-Newton refinement never
moves (``tests/test_torch_port_pose.py``), and the port's float32
refinement returns its input likewise. The last tests run the port's
harness on its own draws against ground truth.

Bounds:
  metrics, trajectory, hpatches           1e-12
  imc_math (float64, x64 on)              1e-9
  validation_error on JAX's draws         precision, matching_score,
                                          num_correct, epipolar_errors
                                          exact; error_t, error_R 0.05°
  the harnesses on a synthetic scene      AUC and mAA within 0.5
                                          percentage points; precision,
                                          matching score and MMA exact
"""
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.data import pairs as jpairs
from oetr_tpu.evalx import datasets as jdatasets
from oetr_tpu.evalx import hpatches as jhpatches
from oetr_tpu.evalx import imc as jimc
from oetr_tpu.evalx import imc_math as jimc_math
from oetr_tpu.evalx import megadepth as jmegadepth
from oetr_tpu.evalx import metrics as jmetrics
from oetr_tpu.evalx import trajectory as jtrajectory
from oetr_tpu.evalx import twoview as jtwoview
from oetr_tpu.sfm.colmap_model import rotmat2qvec as jrotmat2qvec
from oetr_tpu.utils import h5io as jh5io
from oetr_tpu_torch.data import pairs as ppairs
from oetr_tpu_torch.evalx import datasets as pdatasets
from oetr_tpu_torch.evalx import hpatches as phpatches
from oetr_tpu_torch.evalx import imc as pimc
from oetr_tpu_torch.evalx import imc_math as pimc_math
from oetr_tpu_torch.evalx import megadepth as pmegadepth
from oetr_tpu_torch.evalx import metrics as pmetrics
from oetr_tpu_torch.evalx import trajectory as ptrajectory
from oetr_tpu_torch.evalx import twoview as ptwoview
from oetr_tpu_torch.geometry import draws
from oetr_tpu_torch.utils import h5io as ph5io

torch.set_num_threads(2)

EXACT_F64 = 1e-12
IMC_MATH = 1e-9
POSE_DEG = 0.05
AUC_PP = 0.5


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=0, atol=tol), np.abs(a - b).max()


def _same(a, b, tol):
    """Nested results (dicts, lists, tuples, arrays, scalars) within tol."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, tol)
    elif isinstance(a, str):
        assert a == b
    else:
        _close(a, b, tol)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port draws JAX's Gumbel noise of key(seed) by stage."""
    def install(seed):
        with jax.enable_x64(False):
            rng_e, rng_h, rng_p = jax.random.split(jax.random.key(seed), 3)
            rng1, rng2, rng5 = jax.random.split(rng_e, 3)
        keys = {"round1": rng1, "round2": rng2, "five_point": rng5,
                "homography": rng_h, "parallax": rng_p}

        def gumbel(stage, shape, generator):
            with jax.enable_x64(False):
                g = jax.random.gumbel(keys[stage], tuple(shape))
            return torch.from_numpy(np.array(g))
        monkeypatch.setattr(draws, "gumbel", gumbel)
    return install


# ----------------------------------------------------------- metrics --

METRICS = {
    "pose_auc": lambda m, e: m.pose_auc(e, [5, 10, 20]),
    "pose_acc": lambda m, e: m.pose_acc(e, [5, 10, 20]),
    "pose_mAA": lambda m, e: m.pose_mAA(e),
    "iou_recalls": lambda m, e: m.iou_recalls(np.clip(e / 40, 0, 1)),
    "error_summary": lambda m, e: m.error_summary(e, e[::-1]),
}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metrics_match_jax(name):
    e = np.random.default_rng(0).exponential(8.0, 300)
    _same(METRICS[name](pmetrics, e), METRICS[name](jmetrics, e), EXACT_F64)


def _cams(rng, n=6):
    return np.concatenate([rng.normal(0, 0.3, (n, 3)),
                           rng.normal(0, 2, (n, 3))], -1)


TRAJECTORY = {
    "so3_exp_np": lambda m, a, b: [m.so3_exp_np(c[:3]) for c in a],
    "camera_centers": lambda m, a, b: m.camera_centers(a),
    "umeyama_3d": lambda m, a, b: m.umeyama_3d(a[:, 3:], b[:, 3:]),
    "absolute_trajectory_error": lambda m, a, b:
        m.absolute_trajectory_error(a, b),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORY))
def test_trajectory_matches_jax(name):
    rng = np.random.default_rng(1)
    a, b = _cams(rng), _cams(rng)
    _same(TRAJECTORY[name](ptrajectory, a, b),
          TRAJECTORY[name](jtrajectory, a, b), EXACT_F64)


def _hpatches_records(rng):
    H = np.array([[1.1, 0.02, 4.0], [0.01, 0.95, -2.0], [1e-5, 0, 1.0]])
    k0 = rng.uniform(0, 300, (50, 2))
    ph = np.concatenate([k0, np.ones((50, 1))], 1) @ H.T
    k1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 2.0, (50, 2))
    m = np.stack([np.arange(50), np.arange(50)], axis=1)
    return [{"seq_name": s, "H_gt": H, "kpts0": k0, "kpts1": k1 + off,
             "matches": m} for s, off in (("i_a", 0.0), ("v_b", 3.0),
                                          ("v_c", 0.5), ("i_d", 8.0))]


HPATCHES = {
    "h_evaluate": lambda m, r: [m.h_evaluate(x["H_gt"], x["kpts0"],
                                             x["kpts1"], x["matches"])
                                for x in r],
    "mma_table": lambda m, r: _accumulated(m, r),
    "benchmark_results": lambda m, r: m.benchmark_results(r),
}


def _accumulated(m, recs):
    acc_i, acc_v = {}, {}
    for x in recs:
        m.accumulate_pair(acc_i, acc_v, x["seq_name"], m.h_evaluate(
            x["H_gt"], x["kpts0"], x["kpts1"], x["matches"]))
    m.accumulate_pair(acc_i, acc_v, "v_empty", np.zeros(0))
    return m.mma_table(acc_i, acc_v, 2, 3)


@pytest.mark.parametrize("name", sorted(HPATCHES))
def test_hpatches_matches_jax(name):
    recs = _hpatches_records(np.random.default_rng(2))
    _same(HPATCHES[name](phpatches, recs), HPATCHES[name](jhpatches, recs),
          EXACT_F64)


# ---------------------------------------------------------- imc_math --

def _imc_case(rng):
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
    t = rng.normal(size=3)
    X = rng.uniform(-2, 2, (60, 3)) + [0, 0, 7]
    X1 = X @ R.T + t
    x1, x2 = X[:, :2] / X[:, 2:], X1[:, :2] / X1[:, 2:]
    x2 = x2 + rng.normal(0, 1e-3, x2.shape)
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
    return dict(R=R, t=t, x1=x1, x2=x2, d1=X[:, 2:], d2=X1[:, 2:],
                E=E + rng.normal(0, 1e-3, (3, 3)),
                R2=Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix())


IMC = {
    "rotmat2qvec": lambda m, d: (jrotmat2qvec if m is jimc_math
                                 else pimc_math.rotmat2qvec)(d["R2"]),
    "evaluate_R_t": lambda m, d: m.evaluate_R_t(d["R"], d["t"], d["R2"],
                                                d["t"] + 0.1),
    "eval_essential_matrix": lambda m, d: m.eval_essential_matrix(
        d["x1"], d["x2"], d["E"], d["R"], d["t"]),
    "get_projected_kp": lambda m, d: m.get_projected_kp(
        d["x1"], d["x2"], d["d1"], d["d2"], d["R"], d["t"]),
    "get_repeatability": lambda m, d: m.get_repeatability(
        d["x1"] + 1e-3, d["x1"], [1e-3, 2e-3, 5e-3]),
    "get_episym": lambda m, d: m.get_episym(d["x1"], d["x2"], d["R"],
                                            d["t"]),
    "eval_match_score": lambda m, d: m.eval_match_score(
        d["x1"], d["x2"], *m.get_projected_kp(d["x1"], d["x2"], d["d1"],
                                              d["d2"], d["R"], d["t"]),
        d["R"], d["t"]),
}


@pytest.mark.parametrize("name", sorted(IMC))
def test_imc_math_matches_jax(name):
    d = _imc_case(np.random.default_rng(3))
    with jax.enable_x64(True):
        want = IMC[name](jimc_math, d)
    _same(IMC[name](pimc_math, d), want, IMC_MATH)


def test_eval_essential_matrix_refuses_as_jax():
    d = _imc_case(np.random.default_rng(4))
    for args in ((d["x1"][:4], d["x2"][:4], d["E"]), (d["x1"], d["x2"], None),
                 (d["x1"], d["x2"], np.zeros((0, 3)))):
        assert pimc_math.eval_essential_matrix(*args, d["R"], d["t"]) == \
            jimc_math.eval_essential_matrix(*args, d["R"], d["t"])
    with pytest.raises(RuntimeError):
        pimc_math.eval_essential_matrix(d["x1"], d["x2"][:5], d["E"],
                                        d["R"], d["t"])


# ----------------------------------------------------------- twoview --

def _pair_case(rng, n_kpts=120, noise=0.3, outlier_frac=0.15):
    """One synthetic pair as tests/test_eval_harness.py makes them."""
    from scipy.spatial.transform import Rotation
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    R = Rotation.from_euler("xyz", rng.uniform(-10, 10, 3),
                            degrees=True).as_matrix()
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    pts = rng.uniform(-3, 3, (n_kpts, 3)) + [0, 0, 8.0]
    uv0 = (pts / pts[:, 2:]) @ K.T
    p1 = pts @ R.T + t
    uv1 = (p1 / p1[:, 2:]) @ K.T
    k0 = uv0[:, :2] + rng.normal(0, noise, (n_kpts, 2))
    k1 = uv1[:, :2] + rng.normal(0, noise, (n_kpts, 2))
    n_out = int(n_kpts * outlier_frac)
    k1[rng.choice(n_kpts, n_out, replace=False)] = rng.uniform(0, 640,
                                                              (n_out, 2))
    return k0, k1, K, T


def test_twoview_helpers_match_jax():
    rng = np.random.default_rng(5)
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    ip = np.array([0.8, 0.8, 12.0, -7.0, 1.2, 1.3])
    _same(ptwoview.correct_intrinsics(K, ip),
          jtwoview.correct_intrinsics(K, ip), 0.0)
    for n in (0, 3, 64, 65, 300):
        a = rng.normal(size=(n, 2)).astype(np.float32)
        for x, y in zip(ptwoview._pad_pow2(a), jtwoview._pad_pow2(a)):
            assert np.array_equal(x, y)
    k0, k1, K, T = _pair_case(rng)
    assert np.array_equal(ptwoview._symmetric_epipolar_np(k0, k1, T, K, K),
                          jtwoview._symmetric_epipolar_np(k0, k1, T, K, K))


VALIDATION = {
    # case: (kwargs of _pair_case, matches kept, inparams)
    "plain": ({}, slice(None), False),
    "inparams": ({}, slice(None), True),
    "hard": ({"noise": 1.0, "outlier_frac": 0.4}, slice(None), False),
    "four_matches": ({}, slice(0, 4), False),
    "no_matches": ({}, slice(0, 0), False),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_error_matches_jax(case, jax_draws):
    kw, keep, with_ip = VALIDATION[case]
    k0, k1, K, T = _pair_case(np.random.default_rng(6), **kw)
    m = np.stack([np.arange(len(k0)), np.arange(len(k0))])[:, keep]
    ip0 = np.array([0.9, 0.9, 5.0, 3.0, 1.1, 1.1]) if with_ip else None
    ip1 = np.array([1.0, 0.95, -4.0, 2.0, 0.9, 1.0]) if with_ip else None
    with jax.enable_x64(False):
        want = jtwoview.validation_error(k0, k1, m, K, K, T, ip0, ip1,
                                         rng_seed=7)
    jax_draws(7)
    got = ptwoview.validation_error(k0, k1, m, K, K, T, ip0, ip1,
                                    rng_seed=7, device="cpu")
    for k in ("precision", "matching_score", "num_correct"):
        assert got[k] == want[k]
    assert np.array_equal(got["epipolar_errors"], want["epipolar_errors"])
    for k in ("error_t", "error_R"):
        if np.isinf(want[k]):
            assert np.isinf(got[k])
        else:
            assert abs(got[k] - want[k]) < POSE_DEG, (k, got[k], want[k])
    assert got["inliers"].shape == want["inliers"].shape
    if len(want["inliers"]) > 5:
        assert (got["inliers"] == want["inliers"]).mean() >= 0.99


# ---------------------------------------------------- pairs and files --

def test_pair_lists_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    train = tmp_path / "train.txt"
    lines = []
    for i in range(3):
        K = ",".join(map(str, rng.uniform(1, 600, 9)))
        P = ",".join(map(str, rng.normal(size=16)))
        box = "10,20,300,400" if i != 1 else "300,20,10,400"
        lines.append(f"im{i}.jpg d{i}.h5 {K} {P} {box} "
                     f"im{i}b.jpg d{i}b.h5 {K} {P} 5,5,50,60")
    train.write_text("\n".join(lines) + "\n\n")
    ev = tmp_path / "eval.txt"
    ev.write_text(
        "a/x.jpg a/y.jpg " + " ".join(map(str, rng.normal(size=34))) + "\n"
        + "a/x.jpg a/z.jpg " + " ".join(map(str, rng.normal(size=42)))
        + "\nseq/1.ppm seq/2.ppm\nshort line\n")
    for got, want in ((ppairs.load_pairs(str(train)),
                       jpairs.load_pairs(str(train))),
                      (ppairs.load_eval_pairs(str(ev)),
                       jpairs.load_eval_pairs(str(ev)))):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k, v in vars(w).items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(getattr(g, k), v)
                else:
                    assert getattr(g, k) == v
    assert ppairs.names_to_pair("a/b.jpg", "c/d.jpg") == \
        jpairs.names_to_pair("a/b.jpg", "c/d.jpg")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scene_results_read_across(tmp_path, writer):
    """Files written by one package read the same through the other."""
    rng = np.random.default_rng(9)
    k = {"a": rng.uniform(0, 10, (5, 2)), "b": rng.uniform(0, 10, (7, 2))}
    m = {"a-b": np.stack([np.arange(3), np.arange(3)])}
    ip = {"a-b": np.arange(6.0), "b-a": np.arange(6.0) + 1}
    sc = {"a-b": np.float64(0.7)}
    (ph5io if writer == "port" else jh5io).save_scene_results(
        str(tmp_path), "s", k, m, inparams=ip, scales=sc)
    for pairwise in (False,):
        got = ph5io.SceneResults(str(tmp_path), "s", pairwise)
        want = jh5io.SceneResults(str(tmp_path), "s", pairwise)
        for x, y in zip(got.pair("x/a.jpg", "x/b.jpg"),
                        want.pair("x/a.jpg", "x/b.jpg")):
            assert np.array_equal(x, y)
        assert got.scales["a-b"][()] == want.scales["a-b"][()]
        got.close()
        want.close()
    assert ph5io.stem("dir/img.0001.png") == jh5io.stem("dir/img.0001.png")
    assert ph5io.pair_key("a/b.jpg", "c") == jh5io.pair_key("a/b.jpg", "c")


def test_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    scene = "phototourism-val/british_museum"
    cal = tmp_path / scene / "set_100" / "calibration"
    vis = tmp_path / scene / "set_100" / "new-vis-pairs"
    os.makedirs(cal)
    os.makedirs(vis)
    from scipy.spatial.transform import Rotation
    for i, name in enumerate(("a", "b", "c")):
        with h5py.File(cal / f"calibration_{name}.h5", "w") as f:
            f.create_dataset("K", data=rng.uniform(1, 500, (3, 3)))
            f.create_dataset("R", data=Rotation.random(
                random_state=i).as_matrix())
            f.create_dataset("T", data=rng.normal(size=3))
    np.save(vis / "keys-th-0.1.npy", np.array(["a-b", "b-c"]))
    scenes = tmp_path / "scenes.txt"
    scenes.write_text(f"{scene} jpg\n")
    n = pdatasets.generate_imc_pairs(str(scenes), str(tmp_path),
                                     str(tmp_path / "p.txt"), 0.1)
    assert n == jdatasets.generate_imc_pairs(str(scenes), str(tmp_path),
                                             str(tmp_path / "j.txt"), 0.1)
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    with h5py.File(cal / "calibration_a.h5", "r") as f:
        assert np.array_equal(pdatasets.calib_to_matrix(f),
                              jdatasets.calib_to_matrix(f))

    root, res = tmp_path / "hp", tmp_path / "res"
    for seq in ("i_ajuntament", "v_abstract"):
        os.makedirs(root / seq)
        for i in range(2, 7):
            np.savetxt(root / seq / f"H_1_{i}", np.eye(3) + rng.normal(
                0, 1e-3, (3, 3)))
        os.makedirs(res / seq)
        with h5py.File(res / seq / "keypoints.h5", "w") as f:
            for i in range(1, 7):
                f.create_dataset(str(i), data=rng.uniform(0, 100, (10, 2)))
        with h5py.File(res / seq / "matches.h5", "w") as f:
            for i in range(2, 7):
                f.create_dataset(f"1-{i}", data=np.stack(
                    [np.arange(10), rng.permutation(10)]))
    pfile, jfile = tmp_path / "hp.txt", tmp_path / "hj.txt"
    assert pdatasets.generate_hpatches_pairs(str(root), str(pfile)) == \
        jdatasets.generate_hpatches_pairs(str(root), str(jfile))
    assert pfile.read_text() == jfile.read_text()
    got = list(pdatasets.iter_hpatches_results(str(pfile), str(root),
                                               str(res)))
    want = list(jdatasets.iter_hpatches_results(str(jfile), str(root),
                                                str(res)))
    _same(got, want, 0.0)


# --------------------------------------------------------- harnesses --

def _scene(tmp_path, dataset, n_pairs, seed):
    """tests/test_eval_harness.py's synthetic scene in the reference's h5
    layout: (pairs file, results directory)."""
    rng = np.random.default_rng(seed)
    keypoints, matches, lines = {}, {}, []
    for i in range(n_pairs):
        k0, k1, K, T = _pair_case(rng)
        name0 = f"{dataset}/scene0/im{2 * i}.jpg"
        name1 = f"{dataset}/scene0/im{2 * i + 1}.jpg"
        keypoints[ph5io.stem(name0)] = k0
        keypoints[ph5io.stem(name1)] = k1
        matches[ph5io.pair_key(name0, name1)] = np.stack(
            [np.arange(len(k0)), np.arange(len(k0))])
        lines.append(" ".join([name0, name1] + [str(x) for x in K.ravel()]
                              + [str(x) for x in K.ravel()]
                              + [str(x) for x in T.ravel()]
                              + "0 0 640 480 0 0 640 480".split()))
    results = tmp_path / "results" / "m"
    ph5io.save_scene_results(str(results), "scene0", keypoints, matches)
    pairs_file = tmp_path / "pairs.txt"
    pairs_file.write_text("\n".join(lines) + "\n")
    return str(pairs_file), str(results)


def test_megadepth_harness_matches_jax(tmp_path, jax_draws):
    pairs_file, results = _scene(tmp_path, "mega", 4, seed=11)
    with jax.enable_x64(False):
        want = jmegadepth.benchmark_results(pairs_file, results)
    jax_draws(0)
    got = pmegadepth.benchmark_results(pairs_file, results, device="cpu")
    _close(got[0], want[0], AUC_PP)
    assert got[1:] == want[1:]
    table = pmegadepth.summary_table({"m": got})
    assert table == jmegadepth.summary_table({"m": got})


def test_imc_harness_matches_jax(tmp_path, jax_draws):
    pairs_file, results = _scene(tmp_path, "phototourism-val", 3, seed=12)
    rule = pimc.dynamic_threshold_for("oetr_superglue")
    assert rule == jimc.dynamic_threshold_for("oetr_superglue") == "sg"
    with jax.enable_x64(False):
        want = jimc.benchmark_results(pairs_file, results,
                                      dynamic_threshold=rule)
    jax_draws(0)
    got = pimc.benchmark_results(pairs_file, results, dynamic_threshold=rule,
                                 device="cpu")
    assert got[0] == want[0]
    _close(got[1], want[1], AUC_PP)
    assert got[2] == want[2] and got[3] == want[3]
    _close(got[4], want[4], AUC_PP)
    for method in ("oetr_NN", "loftr", "OETR_superglue"):
        assert pimc.dynamic_threshold_for(method) == \
            jimc.dynamic_threshold_for(method)


def test_hpatches_harness_matches_jax():
    """tests/test_eval_harness.py's two sequences (one at ~1 px, one off by
    100 px) and four more: equal tables, and the JAX test's bounds."""
    rng = np.random.default_rng(13)
    H = np.array([[1.1, 0.02, 4.0], [0.01, 0.95, -2.0], [1e-5, 0, 1.0]])
    k0 = rng.uniform(0, 300, (50, 2))
    ph = np.concatenate([k0, np.ones((50, 1))], 1) @ H.T
    k1 = ph[:, :2] / ph[:, 2:] + rng.normal(0, 1.0, (50, 2))
    m = np.stack([np.arange(50), np.arange(50)], axis=1)
    recs = [{"seq_name": "i_seq", "H_gt": H, "kpts0": k0, "kpts1": k1,
             "matches": m},
            {"seq_name": "v_seq", "H_gt": H, "kpts0": k0,
             "kpts1": k1 + 100.0, "matches": m}]
    got = phpatches.benchmark_results(recs)
    assert got == jhpatches.benchmark_results(recs)
    assert got["illumination"][3] > 0.9
    assert got["viewpoint"][3] < 0.1
    more = recs + _hpatches_records(rng)
    assert phpatches.benchmark_results(more) == \
        jhpatches.benchmark_results(more)


def test_megadepth_harness_recovers_poses(tmp_path):
    """The port's harness on its own draws: the JAX harness test's bounds
    (tests/test_eval_harness.py)."""
    pairs_file, results = _scene(tmp_path, "mega", 4, seed=14)
    aucs, prec, ms = pmegadepth.benchmark_results(pairs_file, results,
                                                  device="cpu")
    assert aucs[2] > 50.0, aucs
    assert prec > 60.0
    assert 0 < ms <= 100.0
    errors = pmegadepth.evaluate_methods(
        pairs_file, os.path.dirname(results), [("m", "superglue"),
                                               ("absent", "x")],
        device="cpu")
    assert list(errors) == ["superglue"]
