"""The port's matchers, extractors, COTR and registry against the JAX
package, on the CPU.

The same seeded numpy params (on the shapes of each flax model's ``init``,
converted by ``oetr_tpu_torch.interop``) and inputs go through both sides
in float32, the JAX side jitted. D2Net, R2D2 and DISK take one channel,
as on the pipeline's path (``build_model`` initialises every extractor on
a grayscale dummy). Keypoints are compared as sets of valid positions: the
top-k orders slots by score, so two keypoints whose scores differ by
rounding may trade slots, and the invalid slots' positions are ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.models import aslfeat as j_aslfeat
from oetr_tpu.models import cotr as j_cotr
from oetr_tpu.models import d2net as j_d2net
from oetr_tpu.models import disk as j_disk
from oetr_tpu.models import icp as j_icp
from oetr_tpu.models import matchers as j_matchers
from oetr_tpu.models import r2d2 as j_r2d2
from oetr_tpu.models import registry as j_registry
from oetr_tpu.models import sift_based as j_sift
from oetr_tpu_torch import interop
from oetr_tpu_torch.models import (aslfeat, cotr, d2net, disk, icp, layers,
                                   matchers, r2d2, registry, sift_based)
from oetr_tpu_torch.ops.nms import topk_stable
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _smooth(rng, shape, cell=4):
    """[B, H, W, C] in [0, 1] with structure at ``cell``-px scale."""
    b, h, w, c = shape
    small = rng.uniform(0, 1, (b, h // cell, w // cell, c))
    img = np.repeat(np.repeat(small, cell, axis=1), cell, axis=2)
    img = img + 0.05 * rng.normal(size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


# -------------------------------------------------------------- matchers --

def _descriptors(rng, b, m, n, d):
    """Unit descriptors with forced ties: desc1's rows 0-5 repeat desc0's
    rows 0-5 (identity pairs), rows 6 and 7 of desc1 are one vector (a
    tie for every row of desc0), and some rows are masked. desc0's row 10
    lies near that vector, so its nearest two tie exactly (not at the
    identity, where the ratio test would read the rounding of 1 - sim)."""
    d0 = rng.normal(size=(b, m, d))
    d1 = rng.normal(size=(b, n, d))
    d1[:, :6] = d0[:, :6]
    d1[:, 7] = d1[:, 6]
    d0[:, 10] = d1[:, 6] + 0.3 * rng.normal(size=(b, d))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    v0 = rng.random((b, m)) > 0.2
    v1 = rng.random((b, n)) > 0.2
    v0[:, :6] = v1[:, :8] = True
    v1[1] = False                            # every column masked: all tie
    return d0.astype(np.float32), d1.astype(np.float32), v0, v1


NN_CASES = {
    "mutual_dist.7": dict(distance_threshold=0.7, do_mutual_check=True),
    "ratio.9_no_mutual": dict(ratio_threshold=0.9, do_mutual_check=False),
    "plain": dict(do_mutual_check=False),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_nearest_neighbor_match_matches_jax(rng, case, masked):
    d0, d1, v0, v1 = _descriptors(rng, 3, 40, 48, 16)
    kw = NN_CASES[case]
    vj = (jnp.asarray(v0), jnp.asarray(v1)) if masked else (None, None)
    vp = (_t(v0), _t(v1)) if masked else (None, None)
    want = jax.jit(lambda a, b, *v: j_matchers.nearest_neighbor_match(
        a, b, *v, **kw))(jnp.asarray(d0), jnp.asarray(d1), *vj)
    got = matchers.nearest_neighbor_match(_t(d0), _t(d1), *vp, **kw)
    np.testing.assert_array_equal(_np(got["matches0"]),
                                  np.asarray(want["matches0"]))
    np.testing.assert_allclose(_np(got["matching_scores0"]),
                               np.asarray(want["matching_scores0"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_disk_brute_match_matches_jax(rng, masked):
    d0, d1, v0, v1 = _descriptors(rng, 3, 40, 48, 16)
    vj = (jnp.asarray(v0), jnp.asarray(v1)) if masked else (None, None)
    vp = (_t(v0), _t(v1)) if masked else (None, None)
    want = jax.jit(j_matchers.disk_brute_match)(jnp.asarray(d0),
                                                jnp.asarray(d1), *vj)
    got = matchers.disk_brute_match(_t(d0), _t(d1), *vp)
    np.testing.assert_array_equal(_np(got["matches0"]),
                                  np.asarray(want["matches0"]))
    np.testing.assert_array_equal(_np(got["matching_scores0"]),
                                  np.asarray(want["matching_scores0"]))
    assert (_np(got["matches0"]) > -1).sum() >= 6     # the identity rows


def test_top2_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0],
                      [-1e9, -1e9, -1e9, -1e9, -1e9],
                      [0.0, 0.0, 5.0, 0.0, 5.0]])
    vals, idx = topk_stable(x, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2], [0, 1], [2, 4]]


# -------------------------------------------------------- "SAME" padding --

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [15, 16])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv_same_matches_flax(rng, stride, k, size, dilation):
    import flax.linen as fnn

    x = rng.uniform(-1, 1, (2, size, size + 3, 4)).astype(np.float32)
    conv = fnn.Conv(5, (k, k), strides=(stride, stride),
                    kernel_dilation=(dilation, dilation), padding="SAME")
    params = seeded_params(jax.eval_shape(conv.init, jax.random.key(0),
                                          jnp.asarray(x)), k * 10 + dilation)
    want = jax.jit(conv.apply)(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(x))
    with torch.device("meta"):
        mine = layers.Conv(4, 5, k, stride, "SAME", dilation=dilation)
    mine = layers.materialize(mine, "cpu", None)
    mine.load_state_dict({
        "weight": _t(params["params"]["kernel"].transpose(3, 2, 0, 1)),
        "bias": _t(params["params"]["bias"])})
    with torch.no_grad():
        got = mine(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


def test_same_padding_puts_the_odd_pixel_at_the_end():
    assert layers.same_padding(16, 3, 2, 1) == (0, 1)
    assert layers.same_padding(15, 3, 2, 1) == (1, 1)
    assert layers.same_padding(16, 2, 1, 1) == (0, 1)
    assert layers.same_padding(16, 3, 1, 4) == (4, 4)


# ------------------------------------------------------------ extractors --

def _pair(jmodel, port_builder, converter, kwargs, shape, seed):
    """(JAX module, its params, port module) with the same seeded params
    on the shapes of the flax init at ``shape``."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros(shape, jnp.float32))
    params = seeded_params(shapes, seed)
    pm = port_builder(device="cpu", **kwargs)
    pm.load_state_dict(converter(params, **kwargs))
    return jax.tree.map(jnp.asarray, params), pm


def by_position(out, i):
    """Image i's valid slots: {(x, y): (score, descriptor)}."""
    xy, sc, de, v = (_np(out[k])[i] for k in ("keypoints", "scores",
                                                "descriptors", "valid"))
    return {tuple(p): (s, d) for p, s, d, ok in zip(xy, sc, de, v) if ok}


def assert_extractor_outputs(pout, jout, extra=()):
    """The valid counts equal, the valid keypoints equal as sets (two slots
    whose scores differ by rounding may trade places), their scores and
    descriptors within TOL (scores relative to the dense map's largest
    entry), and the dense maps within TOL of their largest entry."""
    v = np.asarray(jout["valid"])
    np.testing.assert_array_equal(_np(pout["valid"]).sum(-1), v.sum(-1))
    assert v.sum() > 0
    scale = max(1.0, float(np.abs(np.asarray(jout["dense_scores"])).max()))
    for i in range(v.shape[0]):
        mine, theirs = by_position(pout, i), by_position(jout, i)
        assert set(mine) == set(theirs), i
        for p, (s, d) in theirs.items():
            assert abs(mine[p][0] - s) <= TOL * scale, p
            np.testing.assert_allclose(mine[p][1], d, rtol=0, atol=TOL)
    for key in ("dense_scores",) + tuple(extra):
        want = np.asarray(jout[key])
        np.testing.assert_allclose(_np(pout[key]), want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()),
                                   err_msg=key)


EXTRACTORS = {
    # name: (JAX module, port builder, converter, kwargs, HW, extra maps)
    "d2net": (j_d2net.D2Net, d2net.build_d2net,
              interop.convert_d2net_params, dict(max_keypoints=128), 96, ()),
    "r2d2": (j_r2d2.R2D2, r2d2.build_r2d2, interop.convert_r2d2_params,
             dict(max_keypoints=256, reliability_thr=0.3,
                  repeatability_thr=0.3), 64,
             ("reliability", "repeatability")),
    "disk": (j_disk.DISK, disk.build_disk, interop.convert_disk_params,
             dict(max_keypoints=256), 64, ()),
    "aslfeat": (j_aslfeat.ASLFeat, aslfeat.build_aslfeat,
                interop.convert_aslfeat_params, dict(max_keypoints=256),
                128, ()),
}


@pytest.mark.parametrize("name", sorted(EXTRACTORS))
def test_extractor_matches_jax(rng, name):
    jcls, builder, converter, kw, hw, extra = EXTRACTORS[name]
    jm = jcls(**kw)
    shape = (2, hw, hw, 1)
    jparams, pm = _pair(jm, builder, converter, kw, shape, seed=len(name))
    image = _smooth(rng, shape)
    with jax.enable_x64(False):     # as in production (ASLFeat's fusion
        jout = jax.jit(jm.apply)(jparams, jnp.asarray(image))  # weights)
    with torch.no_grad():
        pout = pm(_t(image))
    assert_extractor_outputs(pout, jout, extra)


def test_r2d2_keeps_full_resolution_and_disk_odd_sizes(rng):
    """R2D2's dense maps at the input's size; DISK's U-Net on a size whose
    pools floor (100 -> 50 -> 25 -> 12) and whose upsampling is not x2."""
    kw = dict(max_keypoints=64)
    jm = j_disk.DISK(**kw)
    shape = (1, 100, 100, 1)
    jparams, pm = _pair(jm, disk.build_disk, interop.convert_disk_params, kw,
                        shape, seed=5)
    image = _smooth(rng, shape)
    jout = jax.jit(jm.apply)(jparams, jnp.asarray(image))
    with torch.no_grad():
        pout = pm(_t(image))
    assert pout["dense_scores"].shape == (1, 100, 100)
    assert_extractor_outputs(pout, jout)


# ------------------------------------------------------------------ COTR --

COTR_KW = dict(d_model=32, nhead=4, enc_layers=1, dec_layers=2,
               backbone_depth=18)


def _cotr_pair(seed):
    jm = j_cotr.COTR(**COTR_KW)
    comp = jnp.zeros((1, 64, 128, 3), jnp.float32)
    q = jnp.zeros((1, 8, 2), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), comp, q)
    params = seeded_params(shapes, seed)
    pm = cotr.build_cotr(device="cpu", **COTR_KW)
    pm.load_state_dict(interop.convert_cotr_params(params, **COTR_KW))
    return jm, jax.tree.map(jnp.asarray, params), pm


def test_cotr_and_cotr_match_match_jax(rng):
    jm, jparams, pm = _cotr_pair(seed=21)
    im0 = _smooth(rng, (2, 64, 64, 3))
    im1 = np.roll(im0, 5, axis=2)
    q = rng.uniform(0.05, 0.95, (2, 32, 2)).astype(np.float32)
    valid = rng.random((2, 32)) > 0.2
    comp = np.concatenate([im0, im1], axis=2)
    want = jax.jit(jm.apply)(jparams, jnp.asarray(comp), jnp.asarray(q),
                             jnp.asarray(valid))
    with torch.no_grad():
        got = pm(_t(comp), _t(q), _t(valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)

    jmatch = jax.jit(lambda p, a, b, qq: j_cotr.cotr_match(jm, p, a, b, qq))(
        jparams, jnp.asarray(im0), jnp.asarray(im1), jnp.asarray(q))
    pmatch = cotr.cotr_match(pm, _t(im0), _t(im1), _t(q))
    for key in ("mkpts0", "mkpts1", "cycle_error"):
        np.testing.assert_allclose(_np(pmatch[key]), np.asarray(jmatch[key]),
                                   rtol=0, atol=TOL, err_msg=key)
    # valid is a threshold on cycle_error: equal away from the threshold.
    near = np.abs(np.asarray(jmatch["cycle_error"]) - 0.02) < 1e-4
    agree = _np(pmatch["valid"]) == np.asarray(jmatch["valid"])
    assert (agree | near).all()


# ------------------------------------------------------------ ContextDesc --

def _keypoint_set(rng, b, k, hw):
    desc = rng.uniform(0, 1, (b, k, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    xy = rng.uniform(0, hw - 1, (b, k, 2)).astype(np.float32)
    scores = rng.uniform(0, 0.1, (b, k)).astype(np.float32)
    valid = rng.random((b, k)) > 0.2
    return desc, xy, scores, valid


def test_contextdesc_networks_match_jax(rng):
    hw, k = 96, 50
    jnet = j_sift.ContextDesc()
    image = _smooth(rng, (2, hw, hw, 1))
    desc, xy, scores, valid = _keypoint_set(rng, 2, k, hw)
    args = (image, desc, xy, scores, valid)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            *[jnp.asarray(a) for a in args])
    params = seeded_params(shapes, 31)
    pnet = sift_based.build_contextdesc(device="cpu")
    pnet.load_state_dict(interop.convert_contextdesc_params(params))
    jd, jmatch = jax.jit(jnet.apply)(jax.tree.map(jnp.asarray, params),
                                     *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        pd, pmatch = pnet(*[_t(a) for a in args])
    np.testing.assert_allclose(_np(pd), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(pmatch), np.asarray(jmatch), rtol=0,
                               atol=TOL)

    jaug = j_sift.ContextDescAugmenter()
    xy_norm = xy / hw - 0.5
    aargs = (desc, xy_norm.astype(np.float32), scores)
    shapes = jax.eval_shape(jaug.init, jax.random.key(0),
                            *[jnp.asarray(a) for a in aargs])
    params = seeded_params(shapes, 32)
    paug = sift_based.build_contextdesc_augmenter(device="cpu")
    paug.load_state_dict(interop.convert_contextdesc_augmenter_params(params))
    want = jax.jit(jaug.apply)(jax.tree.map(jnp.asarray, params),
                               *[jnp.asarray(a) for a in aargs])
    with torch.no_grad():
        got = paug(*[_t(a) for a in aargs])
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


def _blob_image(angle_deg, scale, shift, hw=320):
    """A textured uint8 image with one bright rotated rectangle (the
    foreground) on a dark background."""
    import cv2

    img = np.full((hw, hw), 30, np.uint8)
    box = cv2.boxPoints(((hw / 2 + shift[0], hw / 2 + shift[1]),
                         (180 * scale, 130 * scale), angle_deg))
    cv2.fillPoly(img, [box.astype(np.int32)], 220)
    noise = np.random.default_rng(3).integers(0, 20, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def test_sift_extractors_and_icp_match_jax():
    im0 = _blob_image(10, 1.0, (0, 0))
    im1 = _blob_image(25, 1.1, (12, -7))
    jl = j_sift.landmark_extract(im0, topk=128)
    pl = sift_based.landmark_extract(im0, topk=128)
    for key in jl:
        np.testing.assert_array_equal(pl[key], jl[key])
    assert pl["valid"].sum() > 4

    jnet = j_sift.ContextDesc()
    k = 64
    shapes = jax.eval_shape(
        jnet.init, jax.random.key(0), jnp.zeros((1, 320, 320, 1)),
        jnp.zeros((1, k, 128)), jnp.zeros((1, k, 2)), jnp.zeros((1, k)),
        jnp.zeros((1, k), bool))
    params = seeded_params(shapes, 33)
    pnet = sift_based.build_contextdesc(device="cpu")
    pnet.load_state_dict(interop.convert_contextdesc_params(params))
    jc = j_sift.contextdesc_extract(im0, jnet, jax.tree.map(jnp.asarray,
                                                            params), topk=k)
    pc = sift_based.contextdesc_extract(im0, pnet, topk=k)
    np.testing.assert_array_equal(pc["keypoints"], jc["keypoints"])
    np.testing.assert_array_equal(pc["valid"], jc["valid"])
    for key in ("descriptors", "scores"):
        np.testing.assert_allclose(pc[key], np.asarray(jc[key]), rtol=0,
                                   atol=TOL, err_msg=key)

    jicp = j_icp.icp_match(im0, im1)
    picp = icp.icp_match(im0, im1)
    np.testing.assert_array_equal(picp["contours0"], jicp["contours0"])
    np.testing.assert_array_equal(picp["contours1"], jicp["contours1"])
    np.testing.assert_allclose(picp["T"], jicp["T"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(picp["rmse"], jicp["rmse"], rtol=1e-4)
    assert picp["converged"] == jicp["converged"]


# -------------------------------------------------------------- registry --

def test_registry_entries_match_jax():
    assert registry.names() == j_registry.names()
    for kind in ("extractor", "matcher", "overlap"):
        assert registry.names(kind) == j_registry.names(kind)
    for name in j_registry.names():
        mine, theirs = registry.get(name), j_registry.get(name)
        assert (mine.kind, mine.defaults, mine.note) == \
            (theirs.kind, theirs.defaults, theirs.note), name


@pytest.mark.parametrize("name", ["superpoint_aachen", "d2net-ss",
                                  "r2d2-desc", "disk-desc", "aslfeat-desc",
                                  "superglue_disk", "cotr"])
def test_registry_builds_the_jax_models_shapes(name):
    """Each module entry's parameters, by the converter's map, have the
    shapes of the JAX model the registry builds (on a grayscale input for
    the extractors, as ``build_model`` initialises them)."""
    jm = j_registry.build(name)
    mine = registry.build(name, device="meta")
    if name == "superglue_disk":
        k, d = 8, 128
        dummy = {"keypoints0": jnp.zeros((1, k, 2)),
                 "keypoints1": jnp.zeros((1, k, 2)),
                 "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
                 "descriptors0": jnp.zeros((1, k, d)),
                 "descriptors1": jnp.zeros((1, k, d)),
                 "valid0": jnp.ones((1, k), bool),
                 "valid1": jnp.ones((1, k), bool),
                 "image_hw0": (64, 64), "image_hw1": (64, 64)}
        shapes = jax.eval_shape(lambda key: jm.init(key, dummy),
                                jax.random.key(0))
    elif name == "cotr":
        shapes = jax.eval_shape(jm.init, jax.random.key(0),
                                jnp.zeros((1, 64, 128, 3)),
                                jnp.zeros((1, 4, 2)))
    else:
        shapes = jax.eval_shape(jm.init, jax.random.key(0),
                                jnp.zeros((1, 128, 128, 1)))
    from oetr_tpu_torch.interop.from_flax import _state_dict, _unwrap
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = _state_dict(_unwrap(zeros), mine)
    assert set(state) == {n for n, _ in mine.named_parameters()}
