"""The port's ground-truth overlap boxes and on-device scene generator
against the JAX package, on the CPU.

``overlap_bbox_pair`` runs on the same poses, depths, crops and ratios in
both. The generator's renderers (``_texture``, ``_synthesize``,
``homography_from_draws``, ``warp_gray``, ``_bilinear``) run on the numbers
that JAX's own ``jax.random`` calls draw for a key: the test repeats the
key splits and draws of ``oetr_tpu/data/device_synth.py`` and hands them to
the port, so the two are compared on one input (the random streams of the
two frameworks differ by design). The JAX side runs with x64 off, as the
JAX package runs outside the tests (``tests/conftest.py`` turns it on).
Last, the port's own draws on a CPU generator: shapes, ranges and the
1/255 grid.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.data import device_synth as jsynth
from oetr_tpu.geometry import overlap as joverlap
from oetr_tpu_torch.data import device_synth as psynth
from oetr_tpu_torch.geometry import overlap as poverlap

torch.set_num_threads(2)

# Textures: the two frameworks' sin/exp and sums round differently in the
# last f32 bit, which can move a value across a rounding point of the
# 8-bit quantisation: at most one level, on at most this share of pixels.
LEVEL = 1.0 / 255.0
LEVEL_SHARE = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -------------------------------------------------------------- overlap --

def _rotation(rng, max_deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _pair_geometry(rng, h, w):
    """K, depth, world->camera pose, crop and ratio of both images: two
    cameras a little apart looking at a wavy surface ~10 units away, the
    second image's depth rendered as the first's shifted (so the occlusion
    test keeps some pixels and drops others)."""
    out = {}
    for i in (1, 2):
        f = rng.uniform(60, 90)
        out[f"K{i}"] = np.array([[f, 0, w / 2 + rng.uniform(-3, 3)],
                                 [0, f * rng.uniform(0.95, 1.05),
                                  h / 2 + rng.uniform(-3, 3)],
                                 [0, 0, 1]], np.float32)
        T = np.eye(4)
        T[:3, :3] = _rotation(rng, 8)
        T[:3, 3] = rng.uniform(-0.8, 0.8, 3)
        out[f"T{i}"] = T.astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        depth = 10 + 0.5 * np.sin(xx / 7.0 + i) + 0.3 * np.cos(yy / 5.0)
        depth[rng.random((h, w)) < 0.05] = 0.0            # holes
        out[f"depth{i}"] = depth.astype(np.float32)
        out[f"crop{i}"] = rng.uniform(0, 6, 2).astype(np.float32)
        out[f"ratio{i}"] = rng.uniform(0.8, 1.25, 2).astype(np.float32)
    return out


_ARGS = ("K1", "depth1", "T1", "crop1", "ratio1", "K2", "depth2", "T2",
         "crop2", "ratio2")


def test_rigid_inverse_matches_jax(rng):
    T = np.eye(4, dtype=np.float32)[None].repeat(3, 0)
    for i in range(3):
        T[i, :3, :3] = _rotation(rng, 40)
        T[i, :3, 3] = rng.normal(size=3)
    j = joverlap.rigid_inverse(jnp.asarray(T))
    p = poverlap.rigid_inverse(_t(T))
    np.testing.assert_allclose(_np(p), np.asarray(j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(p @ _t(T)), np.eye(4)[None].repeat(3, 0),
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_overlap_bbox_pair_matches_jax(seed):
    """Random rigid poses with crops and ratios, each pair alone and the
    batch of four at once: boxes, masks and validity exact."""
    h, w = 40, 56
    pairs = [_pair_geometry(np.random.default_rng(100 * seed + i), h, w)
             for i in range(4)]
    batched = poverlap.overlap_bbox_pair(
        *[_t(np.stack([p[a] for p in pairs])) for a in _ARGS])
    survivors = []
    for i, p in enumerate(pairs):
        with jax.enable_x64(False):
            j = joverlap.overlap_bbox_pair(*[jnp.asarray(p[a])
                                             for a in _ARGS])
        one = poverlap.overlap_bbox_pair(*[_t(p[a]) for a in _ARGS])
        for port_out in (one, [x[i] for x in batched]):
            for name, a, b in zip(("box1", "mask1", "box2", "mask2",
                                   "valid"), port_out, j):
                np.testing.assert_array_equal(_np(a), np.asarray(b),
                                              err_msg=f"pair {i} {name}")
        survivors.append(float(np.asarray(j[1]).mean()))
    # The poses leave part of each image co-visible, not all, not none.
    assert 0.05 < min(survivors) and max(survivors) < 0.95, survivors


def test_overlap_bbox_no_survivor_gives_zero_boxes():
    h, w = 12, 16
    K = np.array([[50, 0, 8], [0, 50, 6], [0, 0, 1]], np.float32)
    far = np.eye(4, dtype=np.float32)
    far[0, 3] = 100.0                                   # looks elsewhere
    args = dict(K1=K, depth1=np.full((h, w), 5, np.float32),
                T1=np.eye(4, dtype=np.float32), crop1=np.zeros(2, np.float32),
                ratio1=np.ones(2, np.float32), K2=K,
                depth2=np.full((h, w), 5, np.float32), T2=far,
                crop2=np.zeros(2, np.float32), ratio2=np.ones(2, np.float32))
    box1, mask1, box2, mask2, valid = poverlap.overlap_bbox_pair(
        *[_t(args[a]) for a in _ARGS])
    assert not bool(valid)
    assert _np(box1).tolist() == [0.0] * 4 == _np(box2).tolist()
    assert not _np(mask1).any() and not _np(mask2).any()


# ------------------------------------------------- draws, JAX's and ours --

def jax_texture_draws(key, h, w):
    """The numbers ``oetr_tpu.data.device_synth._texture`` draws for key,
    by the same splits and calls, in the port's draw dict."""
    k_wave, k_blob, k_rect, k_noise = jax.random.split(key, 4)
    kw = jax.random.split(k_wave, 3)
    kb = jax.random.split(k_blob, 4)
    kr = jax.random.split(k_rect, 5)
    u = jax.random.uniform
    d = {"wave_freq": u(kw[0], (6, 2), minval=0.01, maxval=0.08),
         "wave_phase": u(kw[1], (6,), maxval=2 * jnp.pi),
         "wave_color": u(kw[2], (6, 3)),
         "blob_y": u(kb[0], (25,), maxval=float(h)),
         "blob_x": u(kb[1], (25,), maxval=float(w)),
         "blob_sigma": u(kb[2], (25,), minval=2.0, maxval=12.0),
         "blob_color": u(kb[3], (25, 3), minval=-1.0, maxval=1.0),
         "rect_y": u(kr[0], (80,), maxval=float(h - 4)),
         "rect_x": u(kr[1], (80,), maxval=float(w - 4)),
         "rect_h": u(kr[2], (80,), minval=3.0, maxval=18.0),
         "rect_w": u(kr[3], (80,), minval=3.0, maxval=18.0),
         "rect_color_alpha": u(kr[4], (80, 4)),
         "noise": jax.random.normal(k_noise, (h, w))}
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def jax_scene_draws(key, hw, pad, scale_range):
    """The numbers ``_synthesize_one`` draws for key (texture included)."""
    k_tex, k_mode, k_scale, k_off, k_illum = jax.random.split(key, 5)
    side = hw + 2 * pad
    u = jax.random.uniform
    return {"texture": jax_texture_draws(k_tex, side, side),
            "mode": np.float32(u(k_mode, ())),
            "scale": np.float32(u(k_scale, (), minval=scale_range[0],
                                  maxval=scale_range[1])),
            "offset": np.asarray(u(k_off, (2,)), np.float32),
            "illum": np.float32(u(k_illum, ()))}


def stack_draws(draws):
    """A list of per-pair draw dicts -> one batched dict of tensors."""
    if isinstance(draws[0], dict):
        return {k: stack_draws([d[k] for d in draws]) for k in draws[0]}
    return _t(np.stack([np.asarray(d, np.float32) for d in draws]))


def assert_images_close(port_img, jax_img, what):
    diff = np.abs(_np(port_img).astype(np.float64)
                  - np.asarray(jax_img, np.float64))
    assert diff.max() <= LEVEL + 1e-6, (what, diff.max())
    share = (diff > 1e-6).mean()
    assert share <= LEVEL_SHARE, (what, share)
    return share


# ---------------------------------------------------------- renderers --

def test_bilinear_matches_jax(rng):
    canvas = rng.uniform(0, 1, (2, 9, 13, 3)).astype(np.float32)
    x = rng.uniform(-2, 15, (2, 5, 7)).astype(np.float32)
    y = rng.uniform(-2, 11, (2, 5, 7)).astype(np.float32)
    x[0, 0, :3] = [0.0, 12.0, 12.5]                     # on and past edges
    p = psynth._bilinear(_t(canvas), _t(x), _t(y))
    for i in range(2):
        j = jsynth._bilinear(jnp.asarray(canvas[i]), jnp.asarray(x[i]),
                             jnp.asarray(y[i]))
        np.testing.assert_allclose(_np(p[i]), np.asarray(j), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("h,w", [(40, 56), (64, 64)])
def test_texture_renders_jax_draws(h, w):
    keys = jax.random.split(jax.random.key(5), 3)
    with jax.enable_x64(False):
        draws = [jax_texture_draws(k, h, w) for k in keys]
        jimgs = [np.asarray(jsynth._texture(k, h, w)) for k in keys]
    pimgs = psynth._texture(stack_draws(draws), h, w)
    assert pimgs.shape == (3, h, w, 3) and pimgs.dtype == torch.float32
    for i in range(3):
        assert_images_close(pimgs[i], jimgs[i], f"texture {i}")


SCENE = dict(hw=48, pad=8, depth_z=10.0, focal=60.0, p_translate=0.5,
             illum_jitter=0.1)


def test_synthesize_renders_jax_draws():
    """Scene pairs from JAX's draws: images to one 8-bit level; GT boxes,
    validity, K, depths, poses and scale exact. The key gives both
    translated and dolly pairs."""
    hw, pad, scale_range = SCENE["hw"], SCENE["pad"], (1.0, 1.6)
    keys = jax.random.split(jax.random.key(11), 6)
    with jax.enable_x64(False):
        draws = [jax_scene_draws(k, hw, pad, scale_range) for k in keys]
        jout = [jsynth._synthesize_one(
            k, hw, pad, SCENE["depth_z"], SCENE["focal"], scale_range,
            SCENE["p_translate"], SCENE["illum_jitter"]) for k in keys]
        jout = {key: np.stack([np.asarray(o[key]) for o in jout])
                for key in jout[0]}
    pout = psynth._synthesize(stack_draws(draws), hw, pad, SCENE["depth_z"],
                              SCENE["focal"], SCENE["p_translate"],
                              SCENE["illum_jitter"])
    assert set(pout) == set(jout)
    translated = np.array([d["mode"] < SCENE["p_translate"] for d in draws])
    assert 0 < translated.sum() < len(keys)
    for key in ("image1", "image2"):
        assert_images_close(pout[key], jout[key], key)
    for key in sorted(set(jout) - {"image1", "image2"}):
        np.testing.assert_array_equal(_np(pout[key]), jout[key], err_msg=key)
        assert _np(pout[key]).dtype == jout[key].dtype, key
    assert jout["overlap_valid"].all()


def test_homography_and_warp_gray_match_jax():
    hw = 40
    keys = jax.random.split(jax.random.key(21), 4)
    kw = dict(max_rot_deg=25.0, scale_range=(0.55, 1.8), max_shift_frac=0.15,
              max_persp=5e-4)
    with jax.enable_x64(False):
        jH = np.stack([np.asarray(jsynth.random_homography_device(
            k, hw, **kw)) for k in keys])
        draws = []
        for k in keys:
            k_rot, k_scale, k_shift, k_persp = jax.random.split(k, 4)
            u = jax.random.uniform
            draws.append({
                "rot_deg": u(k_rot, (), minval=-25.0, maxval=25.0),
                "scale": u(k_scale, (), minval=0.55, maxval=1.8),
                "shift": u(k_shift, (2,), minval=-0.15, maxval=0.15),
                "persp": u(k_persp, (2,), minval=-5e-4, maxval=5e-4)})
        tex = np.asarray(jsynth._texture(jax.random.key(3), hw, hw))
        g = (0.299 * tex[..., 0] + 0.587 * tex[..., 1]
             + 0.114 * tex[..., 2]).astype(np.float32)
        jw = [jsynth.warp_gray(jnp.asarray(g), jnp.asarray(H), hw)
              for H in jH]
    pH = psynth.homography_from_draws(stack_draws(draws), hw)
    np.testing.assert_allclose(_np(pH), jH, rtol=1e-6, atol=1e-6)
    # The warp of one image by JAX's homographies.
    pw, pin = psynth.warp_gray(_t(np.repeat(g[None], 4, 0)), _t(jH), hw)
    assert min(float(np.asarray(ij).mean()) for _, ij in jw) < 1.0
    for i, (wj, ij) in enumerate(jw):
        ij = np.asarray(ij)
        assert ij.mean() > 0.2
        # An inverse that rounds otherwise can move a sample point across
        # the image's edge only where it lies within 1e-4 px of it.
        agree = _np(pin[i]) == ij
        assert agree.mean() >= 0.999, i
        np.testing.assert_allclose(_np(pw[i])[agree], np.asarray(wj)[agree],
                                   rtol=0, atol=1e-4)


# -------------------------------------------------------- the port's draws

def test_device_generator_draws_on_cpu():
    hw, b, scale_range = 40, 6, (1.0, 1.6)
    gen = psynth.make_device_generator(hw, b, scale_range=scale_range,
                                       p_translate=0.5, max_shift_px=8,
                                       device="cpu")
    out = gen(torch.Generator().manual_seed(3))
    shapes = {"image1": (b, hw, hw, 3), "image2": (b, hw, hw, 3),
              "overlap_box1": (b, 4), "overlap_box2": (b, 4),
              "overlap_valid": (b,), "K1": (b, 3, 3), "K2": (b, 3, 3),
              "depth1": (b, hw, hw), "depth2": (b, hw, hw),
              "pose1": (b, 4, 4), "pose2": (b, 4, 4), "crop1": (b, 2),
              "crop2": (b, 2), "ratio1": (b, 2), "ratio2": (b, 2),
              "scale": (b,)}
    assert {k: tuple(v.shape) for k, v in out.items()} == shapes
    for key in ("image1", "image2"):
        img = _np(out[key])
        assert img.min() >= 0.0 and img.max() <= 1.0
    on_grid = _np(out["image1"]) * 255.0
    np.testing.assert_allclose(on_grid, np.round(on_grid), atol=1e-4)
    s = _np(out["scale"])
    assert ((s == 1.0) | ((s >= scale_range[0]) & (s <= scale_range[1]))).all()
    assert _np(out["overlap_valid"]).all()
    boxes = _np(out["overlap_box1"])
    assert (boxes[:, 2:] > boxes[:, :2]).all() and (boxes <= hw - 1).all()
    # Another seed, other pairs; the same seed, the same pairs.
    again = gen(torch.Generator().manual_seed(3))
    other = gen(torch.Generator().manual_seed(4))
    assert torch.equal(again["image2"], out["image2"])
    assert not torch.equal(other["image1"], out["image1"])
    # The generator's GT boxes are the geometry path's on its own tensors.
    ref = poverlap.overlap_bbox_pair(out["K1"], out["depth1"], out["pose1"],
                                     out["crop1"], out["ratio1"], out["K2"],
                                     out["depth2"], out["pose2"],
                                     out["crop2"], out["ratio2"])
    assert torch.equal(ref[0], out["overlap_box1"])
    assert torch.equal(ref[2], out["overlap_box2"])


def test_draw_ranges():
    g = torch.Generator().manual_seed(0)
    d = psynth.draw_texture(g, 4, 30, 50)
    ranges = {"wave_freq": (0.01, 0.08), "wave_phase": (0, 2 * math.pi),
              "wave_color": (0, 1), "blob_y": (0, 30), "blob_x": (0, 50),
              "blob_sigma": (2, 12), "blob_color": (-1, 1), "rect_y": (0, 26),
              "rect_x": (0, 46), "rect_h": (3, 18), "rect_w": (3, 18),
              "rect_color_alpha": (0, 1)}
    for key, (lo, hi) in ranges.items():
        v = _np(d[key])
        assert v.shape[0] == 4 and lo <= v.min() and v.max() <= hi, key
    assert d["noise"].shape == (4, 30, 50)
    h = psynth.draw_homography(g, 5)
    assert (_np(h["rot_deg"]).__abs__() <= 25).all()
    assert ((0.55 <= _np(h["scale"])) & (_np(h["scale"]) <= 1.8)).all()


def test_homography_pair_generator_on_cpu():
    hw = 32
    gen = psynth.make_homography_pair_generator(hw, 3, device="cpu")
    im0, im1, H = gen(torch.Generator().manual_seed(1))
    assert im0.shape == im1.shape == (3, hw, hw, 1) and H.shape == (3, 3, 3)
    assert 0.0 <= float(im0.min()) and float(im0.max()) <= 1.0
    ref, _ = psynth.warp_gray(im0, H, hw)
    assert torch.equal(ref, im1)
    with pytest.raises(ValueError, match="generator"):
        psynth.make_device_generator(hw, 2, device="cuda")(
            torch.Generator().manual_seed(0))
