"""The port's host scene generator and pair-list generation
(``oetr_tpu_torch/data/synthetic.py``, ``data/preprocess.py``) against the
JAX package and cv2, on the CPU.

The port's renderers are numpy alone: ``_gaussian_blur`` stands for
``cv2.GaussianBlur(x, (0, 0), 1.2)`` on float32 and ``_remap_linear`` for
``cv2.remap(..., INTER_LINEAR, BORDER_REPLICATE)`` on uint8, so they run
where cv2 is missing. Each is held to cv2 here, then the renderers to
JAX's on the same ``numpy.random.Generator`` seeds, then the writers (the
port's own JPEG encoder and HDF5 writer, JAX's cv2 and h5py) to JAX's
files; ``tests/test_torch_port_evaluate.py`` holds the files themselves
byte for byte where both render the same pixels.

Bounds:
  _gaussian_blur       cv2's taps (read off an impulse) equal; values
                       within 4e-7 absolute (cv2's SIMD sums round apart)
  _remap_linear        equal to cv2.remap (out-of-image maps, ties too)
  _texture, images     within one 8-bit level on <= 0.1% of pixels
  depth maps           equal
  pair lines           equal (text)
  the writers' images  as _texture's, before the jpg encoder (JAX's
                       cv2.imwrite, the port's imwrite_jpeg)
"""
import importlib
import os

import cv2
import h5py
import numpy as np
import pytest
import torch

from oetr_tpu.data import preprocess as jpre
from oetr_tpu.data import synthetic as jsyn
from oetr_tpu_torch.data import preprocess as ppre
from oetr_tpu_torch.data import synthetic as psyn

torch.set_num_threads(2)

BLUR_ABS = 4e-7
LEVEL_SHARE = 1e-3


def _levels(a, b):
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    return d.max(), (d > 0).mean()


# ----------------------------------------------------------- cv2 stand-ins

def test_gaussian_blur_taps_are_cv2s():
    """An impulse blurred by cv2 gives its kernel's outer product: the tap
    count and the taps are the port's."""
    x = np.zeros((41, 41, 1), np.float32)
    x[20, 20] = 1.0
    ref = cv2.GaussianBlur(x, (0, 0), 1.2)
    support = np.nonzero(ref[20])[0]
    n = support.max() - support.min() + 1
    k = cv2.getGaussianKernel(int(n), 1.2, cv2.CV_32F).ravel()
    np.testing.assert_array_equal(ref[20 - n // 2:21 + n // 2,
                                      20 - n // 2:21 + n // 2],
                                  np.outer(k, k))
    np.testing.assert_array_equal(psyn._gaussian_blur(x[..., 0], 1.2), ref)


@pytest.mark.parametrize("shape", [(160, 150), (17, 13), (5, 4), (2, 3),
                                   (1, 7), (3, 1)])
def test_gaussian_blur_matches_cv2(shape):
    """Random normal images, the tiny ones reflected more than once at the
    border (BORDER_REFLECT_101)."""
    x = np.random.default_rng(sum(shape)).normal(0, 1, shape + (1,)).astype(
        np.float32)
    ref = cv2.GaussianBlur(x, (0, 0), 1.2).reshape(shape)
    out = psyn._gaussian_blur(x[..., 0], 1.2)
    assert out.dtype == np.float32 and out.shape == shape
    assert np.abs(out - ref).max() < BLUR_ABS


@pytest.mark.parametrize("case", ["inside", "outside", "ties"])
def test_remap_linear_matches_cv2(case):
    rng = np.random.default_rng(1)
    tex = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    if case == "inside":
        tx = rng.uniform(0, 51.9, (64, 80))
        ty = rng.uniform(0, 35.9, (64, 80))
    elif case == "outside":
        tx = rng.uniform(-300, 400, (64, 80))
        ty = rng.uniform(-300, 300, (64, 80))
    else:   # quarter pixels: many results exactly half a level apart
        tx = rng.integers(-8, 54 * 4, (64, 80)) / 4
        ty = rng.integers(-8, 38 * 4, (64, 80)) / 4
    tx, ty = tx.astype(np.float32), ty.astype(np.float32)
    ref = cv2.remap(tex, tx, ty, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REPLICATE)
    out = psyn._remap_linear(tex, tx, ty)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


# -------------------------------------------------------------- renderers

@pytest.mark.parametrize("hw", [(160, 160), (96, 130), (5, 9)])
def test_texture_matches_jax(hw):
    for seed in range(3):
        a = jsyn._texture(np.random.default_rng(seed), *hw)
        b = psyn._texture(np.random.default_rng(seed), *hw)
        assert b.shape == hw + (3,) and b.dtype == np.uint8
        top, share = _levels(a, b)
        assert top <= 1 and share <= LEVEL_SHARE


def test_rot_equal():
    for angles in np.random.default_rng(2).uniform(-1, 1, (8, 3)):
        np.testing.assert_array_equal(psyn._rot(*angles), jsyn._rot(*angles))


def _planes(mod, rng, hw, f):
    """A background plane and two floating planes, textures by ``mod``."""
    planes = [{"z": 12.0, "x0": -12.0, "y0": -12.0, "x1": 12.0, "y1": 12.0,
               "tex": mod._texture(rng, 300, 300), "ppw": 12.5}]
    for z, c in ((7.0, -1.0), (8.5, 1.5)):
        planes.append({"z": z, "x0": c - 1.5, "y0": c - 2.0, "x1": c + 1.5,
                       "y1": c + 1.0, "tex": mod._texture(rng, 80, 80),
                       "ppw": 20.0})
    return sorted(planes, key=lambda p: -p["z"])


@pytest.mark.parametrize("pose", ["identity", "rotated"])
def test_render_planes_matches_jax(pose):
    hw, f = 128, 115.2
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]])
    R, c = np.eye(3), np.zeros(3)
    if pose == "rotated":
        R = psyn._rot(0.05, -0.12, 0.2)
        c = np.array([0.8, -0.4, 1.5])
    ij, dj = jsyn._render_planes(_planes(jsyn, np.random.default_rng(4), hw,
                                         f), K, R, c, hw)
    ip, dp = psyn._render_planes(_planes(psyn, np.random.default_rng(4), hw,
                                         f), K, R, c, hw)
    assert ip.dtype == np.uint8 and dp.dtype == np.float32
    top, share = _levels(ij, ip)
    assert top <= 1 and share <= LEVEL_SHARE
    np.testing.assert_array_equal(dp, dj)
    assert len(np.unique(np.round(dp[dp > 0], 2))) > 1


# ---------------------------------------------------------------- writers

def _tree(base, pairs_path):
    lines = open(pairs_path).read().splitlines()
    depths = {}
    for name in sorted(os.listdir(os.path.join(base, "depths"))):
        with h5py.File(os.path.join(base, "depths", name), "r") as f:
            depths[name] = f["/depth"][()]
    return lines, depths


def _same_tree(tmp_path, monkeypatch, gen_j, gen_p, **kw):
    """Both generators' pair lines and depth maps equal, and the images
    each hands to its JPEG writer (JAX's ``cv2.imwrite`` in BGR, the
    port's ``imwrite_jpeg`` in RGB) within one level on <= 0.1% of pixels
    (compared before the encoder)."""
    written = {}
    real = cv2.imwrite
    real_port = psyn.imwrite_jpeg

    def imwrite(path, img):
        written[path] = img[..., ::-1].copy()
        return real(path, img)

    def imwrite_port(path, img):
        written[path] = img.copy()
        return real_port(path, img)

    monkeypatch.setattr(cv2, "imwrite", imwrite)
    monkeypatch.setattr(psyn, "imwrite_jpeg", imwrite_port)
    lj, dj = _tree(tmp_path / "j", gen_j(str(tmp_path / "j"), **kw))
    lp, dp = _tree(tmp_path / "p", gen_p(str(tmp_path / "p"), **kw))
    assert lp == lj and len(lp) == kw["n_pairs"]
    assert dp.keys() == dj.keys()
    for k in dj:
        np.testing.assert_array_equal(dp[k], dj[k])
    names = sorted(os.path.basename(k) for k in written
                   if k.startswith(str(tmp_path / "j")))
    assert len(names) == 2 * kw["n_pairs"]
    for n in names:
        top, share = _levels(written[str(tmp_path / "p" / "imgs" / n)],
                             written[str(tmp_path / "j" / "imgs" / n)])
        assert top <= 1 and share <= LEVEL_SHARE, n


@pytest.mark.parametrize("scale_range", [(1.0, 1.0), (2.0, 3.0)])
def test_generate_scene_matches_jax(tmp_path, monkeypatch, scale_range):
    _same_tree(tmp_path, monkeypatch, jsyn.generate_scene, psyn.generate_scene,
               n_pairs=3, image_hw=96, max_shift_px=24, seed=7,
               scale_range=scale_range)


def test_generate_scene_3d_matches_jax(tmp_path, monkeypatch):
    _same_tree(tmp_path, monkeypatch, jsyn.generate_scene_3d, psyn.generate_scene_3d,
               n_pairs=2, image_hw=128, seed=3, scale_range=(1.1, 1.5),
               rot_deg=10.0, tilt_deg=6.0, illum_range=(0.85, 1.15))


# ------------------------------------------------------------- preprocess

def _scene_info(ds, n_img=4):
    """tests/test_runner_and_utils.py's scene: alternating distances, so
    pairs differ in scale."""
    os.makedirs(ds / "scene_info", exist_ok=True)
    os.makedirs(ds / "depths", exist_ok=True)
    K = np.array([[50.0, 0, 24], [0, 50.0, 24], [0, 0, 1]])
    poses, dpaths, ipaths = [], [], []
    for i in range(n_img):
        T = np.eye(4)
        T[:3, 3] = [0.3 * i, 0.0, 0.0 if i % 2 == 0 else -5.0]
        poses.append(T)
        dp = f"depths/d{i}.h5"
        with h5py.File(ds / dp, "w") as f:
            f.create_dataset("/depth",
                             data=np.full((48, 48), 10.0 + 5 * (i % 2)))
        dpaths.append(dp)
        ipaths.append(f"imgs/im{i}.jpg")
    np.savez(ds / "scene_info" / "0000.0.npz",
             overlap_matrix=np.full((n_img, n_img), 0.4),
             scale_ratio_matrix=np.ones((n_img, n_img)),
             image_paths=np.array(ipaths), depth_paths=np.array(dpaths),
             intrinsics=np.array([K] * n_img), poses=np.array(poses))


@pytest.mark.parametrize("min_diff", [0.0, 1.0])
def test_process_scene_matches_jax(tmp_path, min_diff):
    _scene_info(tmp_path)
    kw = dict(pairs_per_scene=10, min_box_scale_diff=min_diff, seed=0)
    out_j = jpre.process_scene("0000", str(tmp_path), **kw)
    out_p = ppre.process_scene("0000", str(tmp_path), **kw)
    assert out_p == out_j and out_p.count("\n") > 0
    assert ppre.process_scene("9999", str(tmp_path)) == ""
    assert ppre.scale_diff([0, 0, 10, 10], [0, 0, 20, 20]) == 2.0
    for a, b in (([0, 0, 10, 10], [1, 2, 4, 30]), ([0, 0, 5, 5], [0, 0, 5, 5])):
        assert ppre.scale_diff(a, b) == jpre.scale_diff(a, b)
    args = ("a.jpg", "a.h5", np.eye(3), np.eye(4), [0, 0, 4, 4], "b.jpg",
            "b.h5", 2 * np.eye(3), np.eye(4), [1.5, 0, 4, 4])
    assert ppre.pair_line(*args) == jpre.pair_line(*args)


def test_generate_pairs_matches_jax(tmp_path):
    """The process pool over scenes (two scenes, one missing): the same
    count and lines as JAX's."""
    _scene_info(tmp_path)
    kw = dict(pairs_per_scene=10, min_box_scale_diff=0.0, seed=0)
    n_j = jpre.generate_pairs(["0000", "none"], str(tmp_path),
                              str(tmp_path / "j.txt"), workers=2, **kw)
    n_p = ppre.generate_pairs(["0000", "none"], str(tmp_path),
                              str(tmp_path / "p.txt"), workers=2, **kw)
    assert n_p == n_j > 0
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_renderers_run_without_cv2(monkeypatch):
    """With cv2 unimportable (the card's machine), the renderers give what
    they give with it."""
    hw, f = 64, 57.6
    K = np.array([[f, 0, hw / 2], [0, f, hw / 2], [0, 0, 1.0]])
    R, c = psyn._rot(0.0, -0.1, 0.0), np.array([0.5, 0.0, 0.2])
    ref = psyn._render_planes(_planes(psyn, np.random.default_rng(5), hw, f),
                              K, R, c, hw)
    monkeypatch.setitem(importlib.sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    out = psyn._render_planes(_planes(psyn, np.random.default_rng(5), hw, f),
                              K, R, c, hw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
