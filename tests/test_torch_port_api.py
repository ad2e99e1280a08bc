"""The port's public matching API, image service, benchmark runner, demo,
timer and plots against the JAX package, on the CPU.

``prepare_image`` (numpy's INTER_AREA) is held to JAX's (cv2's);
``build_model`` + ``get_matches`` to JAX's on cv2-written files, with the
same seeded numpy params (on each flax model's ``init`` shapes) given to
both, JAX's as flax trees and the port's converted; ``get_pose`` to JAX's
on JAX's Gumbel draws; ``run_benchmark``'s h5 files to JAX's. The
SuperPoint + SuperGlue + OETR combination and the trained
``.ckpt_loftr_r5`` are in ``test_torch_port_api_weights.py``.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.data import images as j_images
from oetr_tpu.models import registry as j_registry
from oetr_tpu.pipelines import api as j_api
from oetr_tpu.pipelines import PipelineConfig as JaxPipelineConfig
from oetr_tpu_torch import interop
from oetr_tpu_torch.data import images
from oetr_tpu_torch.geometry import draws
from oetr_tpu_torch.pipelines import api
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

CANVAS, OETR_HW = (128, 128), (128, 128)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------- image service --

PREPARE_CASES = {
    # name: (image hw, canvas, oetr, resize_max)
    "shrink_integer": ((256, 384), (128, 192), (64, 96), None),
    "shrink_fractional": ((150, 210), (96, 128), (100, 70), None),
    "enlarge": ((60, 80), (96, 96), (128, 128), None),
    "mixed": ((90, 70), (96, 96), (40, 120), None),
    "resize_max_cut": ((300, 500), (192, 192), (64, 64), 333),
}


@pytest.mark.parametrize("case", sorted(PREPARE_CASES))
def test_prepare_image_matches_jax(rng, case):
    hw, canvas, oetr_hw, resize_max = PREPARE_CASES[case]
    image = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    want = j_images.prepare_image(image, canvas, oetr_hw, resize_max)
    got = images.prepare_image(image, canvas, oetr_hw, resize_max)
    assert got.orig_hw == want.orig_hw
    for field in ("canvas", "valid_hw", "oetr_image", "oetr_scale",
                  "scale_to_orig"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=field)
    bj = j_images.batch_pairs([want], [want])
    bp = images.batch_pairs([got], [got])
    assert set(bj) == set(bp)


@pytest.mark.parametrize("src,dst", [((37, 53), (20, 37)),
                                     ((64, 64), (64, 64)),
                                     ((17, 9), (13, 5)),
                                     ((480, 640), (640, 640))])
def test_resize_area_matches_cv2(rng, src, dst):
    img = rng.uniform(0, 1, src + (3,)).astype(np.float32)
    np.testing.assert_allclose(
        images.resize_area(img, dst[::-1]),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA),
        rtol=0, atol=1e-6)


def test_read_image_matches_jax(tmp_path, rng):
    img = rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    for gray in (False, True):
        np.testing.assert_array_equal(images.read_image(path, gray),
                                      j_images.read_image(path, gray))
    with pytest.raises(FileNotFoundError):
        images.read_image(str(tmp_path / "missing.png"))


# ------------------------------------------------- build_model/get_matches --

def _texture_files(tmp_path, seed, shift=(8, -8), hw=(160, 160)):
    """Two cv2-written PNGs: a smooth texture and a shifted copy (rolled),
    of a size that fills the canvas: in a padded (flat) region the
    frameworks' rounding alone would pick the NMS's survivors."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (hw[0] // 8, hw[1] // 8, 3))
    img = cv2.resize(small, hw[::-1], interpolation=cv2.INTER_CUBIC)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)
    paths = [str(tmp_path / f"{seed}_{i}.png") for i in (0, 1)]
    cv2.imwrite(paths[0], img)
    cv2.imwrite(paths[1], np.roll(img, shift, axis=(0, 1)))
    return paths


def _sg_dummy(k, d, hw):
    return {"keypoints0": jnp.zeros((1, k, 2)),
            "keypoints1": jnp.zeros((1, k, 2)),
            "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
            "descriptors0": jnp.zeros((1, k, d)),
            "descriptors1": jnp.zeros((1, k, d)),
            "valid0": jnp.ones((1, k), bool),
            "valid1": jnp.ones((1, k), bool),
            "image_hw0": hw, "image_hw1": hw}


def _params(extractor, matcher, overlaper, seed):
    """(JAX params, port state dicts) per component, seeded on the shapes
    of the models JAX's ``build_model`` initialises."""
    key = jax.random.key(0)
    dummy = jnp.zeros((1,) + CANVAS + (1,), jnp.float32)
    jp, pp = {}, {}
    if overlaper:
        m = j_registry.build(overlaper)
        od = jnp.zeros((1,) + OETR_HW + (3,), jnp.float32)
        jp["oetr"] = seeded_params(jax.eval_shape(m.init, key, od, od), seed)
        pp["oetr"] = interop.convert_flax_params(jp["oetr"],
                                                 port.OETRConfig())
    if matcher == "loftr":
        m = j_registry.build("loftr")
        jp["matcher"] = seeded_params(
            jax.eval_shape(m.init, key, dummy, dummy), seed + 1)
        pp["matcher"] = interop.convert_loftr_params(jp["matcher"])
        return jp, pp
    ex = j_registry.build(extractor)
    jp["extractor"] = seeded_params(jax.eval_shape(ex.init, key, dummy),
                                    seed + 2)
    convert = {"superpoint_aachen": interop.convert_superpoint_params,
               "d2net-ss": interop.convert_d2net_params,
               "disk-desc": interop.convert_disk_params}[extractor]
    pp["extractor"] = convert(jp["extractor"])
    if matcher.startswith("superglue"):
        sg = j_registry.build(matcher)
        jp["matcher"] = seeded_params(jax.eval_shape(
            lambda k: sg.init(k, _sg_dummy(ex.max_keypoints,
                                           sg.descriptor_dim, CANVAS)), key),
            seed + 3, shrink=("mlp2", "out"))
        pp["matcher"] = interop.convert_superglue_params(
            jp["matcher"], **j_registry.get(matcher).defaults)
    return jp, pp


def assert_same_keypoints(got, want, px=1e-3):
    """Each side's valid keypoints correspond one to one within ``px``."""
    for side in "01":
        if f"all_valid{side}" not in want:
            continue
        pg = got[f"kpts{side}"][got[f"all_valid{side}"]]
        pw = want[f"kpts{side}"][want[f"all_valid{side}"]]
        assert len(pg) == len(pw), side
        dist = np.abs(pw[:, None, :] - pg[None, :, :]).max(-1)
        assert len(set(dist.argmin(1).tolist())) == len(pw), side
        assert dist.min(1).max() <= px, (side, dist.min(1).max())


def match_rows(d):
    """[M, 4] matched (x0, y0, x1, y1) and [M] confidences."""
    m = d["matches"]
    return (np.concatenate([d["kpts0"][m[0]], d["kpts1"][m[1]]], 1),
            np.asarray(d["confidence"]))


def assert_same_matches(got, want, px=1e-3, conf_tol=1e-5, ties=None):
    """The matches correspond one to one, their points within ``px`` and
    confidences within ``conf_tol``. With ``ties`` ([K] bool over the
    port's slots of image 0: rows whose nearest two descriptors are within
    rounding), a match of one side only must start at a tied slot. Returns
    the count of those."""
    (pg, cg), (pw, cw) = match_rows(got), match_rows(want)
    if len(pg) and len(pw):
        near = np.abs(pw[:, None, :] - pg[None, :, :]).max(-1) <= px
    else:
        near = np.zeros((len(pw), len(pg)), bool)
    assert (near.sum(0) <= 1).all() and (near.sum(1) <= 1).all()
    iw, ig = np.nonzero(near)
    np.testing.assert_allclose(cg[ig], cw[iw], rtol=0, atol=conf_tol)
    only = [pw[i] for i in range(len(pw)) if not near[i].any()] + \
        [pg[i] for i in range(len(pg)) if not near[:, i].any()]
    if ties is None:
        assert not only, only[:5]
        return 0
    for row in only:
        slot = np.abs(got["kpts0"] - row[:2]).max(-1).argmin()
        assert ties[slot], row
    return len(only)


def nn_ties(pmodel, paths, tie=1e-5):
    """[K] bool over the port pipeline's slots of image 0: valid rows whose
    top two cosine similarities over the valid keypoints of image 1 differ
    by less than ``tie``, or whose best column's top two rows do (the
    mutual check's). Exact ties occur: keypoints within half a descriptor
    cell of the border sample the same (clamped) descriptor."""
    from oetr_tpu_torch.pipelines.runner import run_batch

    cfg = pmodel[1]["config"]
    prep = [images.prepare_image(images.read_image(p), cfg.canvas_hw,
                                 cfg.oetr_hw, 1024) for p in paths]
    out = run_batch(pmodel[0], images.batch_pairs(prep[:1], prep[1:]))
    d0, d1 = (out[f"descriptors{s}"][0].numpy().astype(np.float64)
              for s in "01")
    v0, v1 = out["valid0"][0].numpy(), out["valid1"][0].numpy()
    sim = np.where(v0[:, None] & v1[None, :], d0 @ d1.T, -np.inf)
    top = np.sort(sim, axis=1)
    topc = np.sort(sim, axis=0)
    row_tie = top[:, -1] - top[:, -2] < tie
    col_tie = topc[-1] - topc[-2] < tie
    return v0 & (row_tie | col_tie[sim.argmax(1)])


def _models(extractor, matcher, overlaper, **cfg_kw):
    """JAX's and the port's ``build_model`` on the same seeded params."""
    jp, pp = _params(extractor, matcher, overlaper, seed=7)
    kw = dict(canvas_hw=CANVAS, oetr_hw=OETR_HW, **cfg_kw)
    jmodel = j_api.build_model(extractor, matcher, overlaper,
                               cfg=JaxPipelineConfig(**kw),
                               params=jax.tree.map(jnp.asarray, jp))
    pmodel = api.build_model(extractor, matcher, overlaper,
                             cfg=port.PipelineConfig(**kw), params=pp,
                             device="cpu")
    assert pmodel[1]["extractor"] == jmodel[1]["extractor"]
    return jmodel, pmodel


COMBOS = {
    "d2net_nn": ("d2net-ss", "NN", None),
    "disk_disk": ("disk-desc", "disk", None),
    "loftr": ("superpoint_aachen", "loftr", None),
}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_get_matches_matches_jax(tmp_path, combo):
    extractor, matcher, overlaper = COMBOS[combo]
    paths = _texture_files(tmp_path, seed=len(combo))
    jmodel, pmodel = _models(extractor, matcher, overlaper)
    want = j_api.get_matches(jmodel, *paths)
    got = api.get_matches(pmodel, *paths)
    assert set(got) == set(want)
    assert_same_keypoints(got, want)
    if matcher == "loftr":
        # Seeded LoFTR's coarse confidences are flat (~1/N²): no match
        # passes 0.2 on either side; the trained checkpoint's test matches.
        assert_same_matches(got, want)
        return
    assert want["matches"].shape[1] >= 20
    # Each differing match counts once a side: at least half agree.
    flipped = assert_same_matches(got, want, ties=nn_ties(pmodel, paths))
    assert flipped <= want["matches"].shape[1]


@pytest.mark.parametrize("extractor,matcher", [("landmark", "NN"),
                                               ("contextdesc", "NN"),
                                               ("superpoint_aachen", "icp"),
                                               ("superpoint_aachen", "cotr")])
def test_build_model_refuses_what_jax_cannot_run(extractor, matcher):
    """JAX's build_model raises for the SIFT extractors (functions, no
    init) and builds pipelines for icp and cotr whose match_fn cannot take
    the data dict; the port refuses all four."""
    kw = dict(canvas_hw=CANVAS, oetr_hw=OETR_HW)
    with pytest.raises(Exception):
        model = j_api.build_model(extractor, matcher,
                                  cfg=JaxPipelineConfig(**kw))
        model[0].match_fn(_sg_dummy(8, 256, CANVAS))
    with pytest.raises(ValueError, match="not a pipeline component"):
        api.build_model(extractor, matcher, cfg=port.PipelineConfig(**kw),
                        device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_raise_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.build_model("d2net-ss", "NN")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.models.registry.build("superglue_outdoor", cuda_sinkhorn=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.get_pose({"kpts0": np.zeros((4, 2)), "kpts1": np.zeros((4, 2)),
                      "matches": np.zeros((2, 0), int)})


# ------------------------------------------------------------- get_pose --

@pytest.mark.parametrize("model", ["homography", "similarity"])
def test_get_pose_matches_jax_on_its_draws(monkeypatch, model):
    rng = np.random.default_rng(4)
    n = 150
    k0 = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    if model == "homography":
        H = np.array([[1.05, 0.04, 12.0], [-0.03, 0.97, -7.0],
                      [2e-5, -1e-5, 1.0]])
    else:
        c, s = 1.1 * np.cos(0.2), 1.1 * np.sin(0.2)
        H = np.array([[c, -s, 9.0], [s, c, -4.0], [0, 0, 1.0]])
    ph = np.concatenate([k0, np.ones((n, 1))], 1) @ H.T
    k1 = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    k1 += rng.normal(0, 0.3, k1.shape).astype(np.float32)
    out = rng.choice(n, int(0.3 * n), replace=False)
    k1[out] = rng.uniform(0, 400, (len(out), 2))
    perm = rng.permutation(n)
    md = {"kpts0": k0, "kpts1": k1[perm],
          "matches": np.stack([np.arange(n), np.argsort(perm)])}

    with jax.enable_x64(False):
        want = j_api.get_pose(md, model=model, rng_seed=3)
        g = np.asarray(jax.random.gumbel(jax.random.key(3), (256, 256)))
    monkeypatch.setattr(draws, "gumbel",
                        lambda stage, shape, generator: _t(g))
    got = api.get_pose(md, model=model, rng_seed=3, device="cpu")
    Hw, Hg = want["H"] / want["H"][2, 2], got["H"] / got["H"][2, 2]
    assert np.abs(Hg - Hw).max() <= 1e-4 * np.abs(Hw).max()
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    assert got["ok"] == want["ok"] is True
    assert got["inliers"].sum() >= 0.6 * n


# --------------------------------------------------------------- runner --

def _dataset(tmp_path, rng, n_pairs=2):
    """Identical textured JPEGs in a MegaDepth-style scene dir and an
    evaluation pair list (identity poses)."""
    ds = tmp_path / "data"
    os.makedirs(ds / "mega" / "scene0", exist_ok=True)
    img = rng.uniform(0, 255, (12, 12, 3)).astype(np.uint8)
    img = cv2.resize(img, (96, 96), interpolation=cv2.INTER_NEAREST)
    names = []
    for i in range(2 * n_pairs):
        names.append(f"mega/scene0/im{i}.jpg")
        cv2.imwrite(str(ds / names[-1]), img)
    K = np.array([[100.0, 0, 48], [0, 100.0, 48], [0, 0, 1]])
    pairs = tmp_path / "pairs.txt"
    with open(pairs, "w") as f:
        for a in range(n_pairs):
            f.write(" ".join([names[2 * a], names[2 * a + 1]]
                             + [str(x) for x in K.reshape(-1)] * 2
                             + [str(x) for x in np.eye(4).reshape(-1)]
                             + ["0"] * 8) + "\n")
    return ds, pairs, names


def _read_h5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


@pytest.mark.parametrize("write_inparams", [False, True])
def test_run_benchmark_matches_jax(tmp_path, rng, write_inparams):
    from oetr_tpu.models import SuperPoint, nearest_neighbor_match
    from oetr_tpu.pipelines import SparsePipeline as JaxSparsePipeline
    from oetr_tpu.pipelines.runner import run_benchmark as j_run
    from oetr_tpu_torch.models.matchers import nearest_neighbor_match as p_nn
    from oetr_tpu_torch.pipelines.runner import run_benchmark

    ds, pairs, names = _dataset(tmp_path, rng)
    kw = dict(oetr_hw=(64, 64), canvas_hw=(96, 96), fallback_min_matches=0)
    sp_kw = dict(max_keypoints=64, keypoint_threshold=1e-5, nms_radius=2)
    jsp = SuperPoint(**sp_kw)
    params = seeded_params(jax.eval_shape(
        jsp.init, jax.random.key(0), jnp.zeros((1, 96, 96, 1))), 5)
    jpipe = JaxSparsePipeline(
        jsp, jax.tree.map(jnp.asarray, params),
        lambda d: nearest_neighbor_match(d["descriptors0"],
                                         d["descriptors1"], d["valid0"],
                                         d["valid1"]),
        cfg=JaxPipelineConfig(**kw))
    psp = port.build_superpoint(device="cpu", **sp_kw)
    psp.load_state_dict(interop.convert_superpoint_params(params))
    ppipe = port.SparsePipeline(
        psp, lambda d: p_nn(d["descriptors0"], d["descriptors1"],
                            d["valid0"], d["valid1"]),
        cfg=port.PipelineConfig(**kw))

    run_kw = dict(batch_size=2, with_overlap=False,
                  write_inparams=write_inparams)
    js = j_run(jpipe, str(pairs), str(ds), str(tmp_path / "j"), **run_kw)
    ps = run_benchmark(ppipe, str(pairs), str(ds), str(tmp_path / "p"),
                       **run_kw)
    assert ps == js
    assert ps["matches_per_pair"] > 5
    files = sorted(os.listdir(tmp_path / "j" / "scene0"))
    assert sorted(os.listdir(tmp_path / "p" / "scene0")) == files
    assert ("inparams.h5" in files) == write_inparams
    for name in files:
        want = _read_h5(tmp_path / "j" / "scene0" / name)
        got = _read_h5(tmp_path / "p" / "scene0" / name)
        assert set(got) == set(want), name
        for key in want:
            assert got[key].shape == want[key].shape, (name, key)
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-3, err_msg=f"{name} {key}")
    # An identity pair: the matched coordinates coincide.
    k = _read_h5(tmp_path / "p" / "scene0" / "keypoints.h5")
    m = _read_h5(tmp_path / "p" / "scene0" / "matches.h5")["im0-im1"]
    err = np.linalg.norm(k["im0-im1"][m[0]] - k["im1-im0"][m[1]], axis=-1)
    assert np.median(err) < 1.5


def test_run_benchmark_native_loader_matches_python(tmp_path, rng):
    from oetr_tpu_torch.data.native import native_available
    from oetr_tpu_torch.pipelines.runner import run_benchmark

    if not native_available():
        pytest.skip("native data service unavailable (no g++/libjpeg)")
    ds, pairs, names = _dataset(tmp_path, rng, n_pairs=1)
    psp = port.build_superpoint(device="cpu", max_keypoints=64,
                                keypoint_threshold=1e-5, nms_radius=2)
    pipe = port.SparsePipeline(
        psp, port.models.registry.build("NN", device="cpu"),
        cfg=port.PipelineConfig(oetr_hw=(64, 64), canvas_hw=(96, 96),
                                fallback_min_matches=0))
    for tag, native in (("py", False), ("nat", True)):
        run_benchmark(pipe, str(pairs), str(ds), str(tmp_path / tag),
                      batch_size=1, with_overlap=False, use_native=native)
    a = _read_h5(tmp_path / "py" / "scene0" / "keypoints.h5")
    b = _read_h5(tmp_path / "nat" / "scene0" / "keypoints.h5")
    np.testing.assert_allclose(a["im0-im1"], b["im0-im1"], atol=1.0)


# ----------------------------------------------------------------- demo --

def test_demo_reads_a_port_checkpoint(tmp_path, rng, capsys):
    from oetr_tpu_torch.pipelines import demo
    from oetr_tpu_torch.training.train import (create_train_state,
                                               save_checkpoint)

    size = 128
    _, state = create_train_state(port.OETRConfig(),
                                  port.TrainConfig(image_size=(size, size)),
                                  torch.Generator().manual_seed(3),
                                  device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), state, step=0)
    data = tmp_path / "imgs"
    os.makedirs(data)
    for n in ("a.jpg", "b.jpg"):
        cv2.imwrite(str(data / n), rng.integers(0, 255, (90, 120, 3),
                                                dtype=np.uint8))
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("a.jpg b.jpg " + " ".join(["10"] * 8) + "\n")
    demo.main(["--pairs", str(pairs), "--data", str(data), "--checkpoint",
               str(tmp_path / "ckpt"), "--step", "0", "--out",
               str(tmp_path / "viz"), "--size", str(size), "--device",
               "cpu"])
    assert "box0" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "viz" / "a.jpg_b.jpg.png")


# ------------------------------------------------------- timer and plots --

def test_viz_utils(tmp_path, rng):
    from oetr_tpu.utils import viz as j_viz
    from oetr_tpu_torch.utils import viz

    x = np.array([0.0, 0.5, 1.0])
    np.testing.assert_array_equal(viz.error_colormap(x),
                                  j_viz.error_colormap(x))
    img = rng.uniform(0, 255, (64, 64)).astype(np.uint8)
    mk = rng.uniform(5, 59, (10, 2)).astype(np.float32)
    color = viz.error_colormap(rng.uniform(0, 1, 10))
    out = viz.make_matching_plot_fast(img, img, mk, mk, color,
                                      path=str(tmp_path / "m.png"))
    np.testing.assert_array_equal(
        out, j_viz.make_matching_plot_fast(img, img, mk, mk, color))
    assert os.path.exists(tmp_path / "m.png")
    ov = viz.visualize_overlap_gt(img, [5, 5, 30, 30], [6, 6, 31, 31],
                                  img, [10, 10, 40, 40], [11, 11, 39, 39])
    assert ov.shape == (64, 128, 3)
    np.testing.assert_array_equal(ov, j_viz.visualize_overlap_gt(
        img, [5, 5, 30, 30], [6, 6, 31, 31], img, [10, 10, 40, 40],
        [11, 11, 39, 39]))
    viz.plot_mma_curves({"ours": np.linspace(0.2, 0.9, 10)},
                        path=str(tmp_path / "mma.png"))
    viz.make_matching_plot(img, img, mk, mk, mk, mk, color, text=("t",),
                           path=str(tmp_path / "full.png"))
    assert os.path.exists(tmp_path / "mma.png")
    assert os.path.exists(tmp_path / "full.png")


def test_timer_and_streamer(tmp_path, rng):
    from oetr_tpu_torch.utils.timer import AverageTimer, VideoStreamer

    t = AverageTimer()
    t.update("stage1")
    t.update("stage2")
    t.print("test")
    assert "stage1" in t.times
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"f{i}.jpg"),
                    rng.uniform(0, 255, (32, 32)).astype(np.uint8))
    vs = VideoStreamer(str(tmp_path), resize=(16, 16))
    frames = []
    while True:
        f, ok = vs.next_frame()
        if not ok:
            break
        frames.append(f)
    assert len(frames) == 3 and frames[0].shape == (16, 16)
    assert 0.0 <= frames[0].min() and frames[0].max() <= 1.0
    with pytest.raises(ValueError):
        VideoStreamer(str(tmp_path / "nothing_here"))
