"""The port's sparse matching slice against the JAX package, on the CPU.

Warp, NMS/top-k, SuperPoint, Sinkhorn (K4's plain version), SuperGlue and
the whole ``SparsePipeline``: the same seeded numpy params and inputs go
through both, in float32. The JAX Sinkhorn runs its Pallas kernel (K4) in
interpret mode through ``log_optimal_transport(use_pallas=True)``, as the
JAX package's own test does; the port's ``use_cuda`` / ``cuda_sinkhorn``
switch takes the plain version on CPU tensors.

Keypoints are compared as sets of valid (x, y): the tiled top-k orders
slots by score and breaks ties differently in the two frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.models.superglue import SuperGlue as JaxSuperGlue
from oetr_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from oetr_tpu.ops import nms as jax_nms
from oetr_tpu.ops import sinkhorn as jax_sinkhorn
from oetr_tpu.ops import warp as jax_warp
from oetr_tpu.pipelines import PipelineConfig as JaxPipelineConfig
from oetr_tpu.pipelines import SparsePipeline as JaxSparsePipeline
from oetr_tpu_torch.interop import (convert_flax_params,
                                    convert_superglue_params,
                                    convert_superpoint_params)
from oetr_tpu_torch.ops import nms, sinkhorn, warp
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

# log_assignment of the plain and kernel paths, unmasked entries: f32 with
# other summation orders (and __expf on the card) over 30 iterations.
SINKHORN_TOL = 1e-4
MASKED = -1e8          # masked entries hold ~-1e9; both sides must be below
TIE = 1e-5             # matches may differ where the top two probs are this close


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _smooth_images(rng, b, h, w):
    """Images in [0, 1] with structure at 8-px scale."""
    small = rng.uniform(0, 1, (b, h // 8, w // 8, 3)).astype(np.float32)
    img = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)
    return np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1).astype(
        np.float32)


def keypoint_sets(xy, scores, valid):
    """Per batch row: {(x, y): score} over valid slots."""
    xy, scores, valid = _np(xy), _np(scores), _np(valid)
    return [{tuple(p): s for p, s, v in zip(xy[i], scores[i], valid[i]) if v}
            for i in range(xy.shape[0])]


def assert_same_sets(port_sets, jax_sets, score_tol):
    for ps, js in zip(port_sets, jax_sets):
        assert set(ps) == set(js)
        for p in ps:
            assert abs(ps[p] - js[p]) <= score_tol, p


def by_position(xy_int, values, valid):
    """Per batch row: {integer (x, y): value row} over valid slots."""
    xy_int, values, valid = _np(xy_int), _np(values), _np(valid)
    return [{tuple(p): v for p, v, ok in zip(xy_int[i], values[i], valid[i])
             if ok} for i in range(xy_int.shape[0])]


# ----------------------------------------------------------------- warp --

@pytest.mark.parametrize("box", [(5.0, 7.5, 41.0, 30.0),     # inside
                                 (-3.0, 10.0, 70.0, 52.0),   # past the edges
                                 (20.0, 20.0, 20.5, 21.0),   # degenerate
                                 (0.0, 0.0, 56.0, 40.0)])    # the full image
def test_crop_resize_matches_jax_and_gather(rng, box):
    image = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.asarray(box, np.float32)
    out_hw = (24, 32)
    j_canvas, j_ratio, j_valid = jax_warp.crop_resize(
        jnp.asarray(image), jnp.asarray(b), out_hw)
    p_canvas, p_ratio, p_valid = warp.crop_resize(_t(image), _t(b), out_hw)
    g_canvas, g_ratio, g_valid = warp.crop_resize_gather(_t(image), _t(b),
                                                         out_hw)
    np.testing.assert_allclose(_np(p_canvas), np.asarray(j_canvas), atol=1e-5)
    np.testing.assert_allclose(_np(p_canvas), _np(g_canvas), atol=1e-5)
    np.testing.assert_allclose(float(p_ratio), float(j_ratio), rtol=1e-7)
    assert float(g_ratio) == float(p_ratio)
    np.testing.assert_array_equal(_np(p_valid), np.asarray(j_valid))
    np.testing.assert_array_equal(_np(g_valid), _np(p_valid))


def test_crop_resize_batch_unwarp_and_resize_match_jax(rng):
    images = rng.uniform(0, 1, (3, 48, 40, 3)).astype(np.float32)
    boxes = np.array([[2, 3, 30, 40], [0, 0, 40, 48], [10.5, 4, 20, 44.5]],
                     np.float32)
    jc, jr, jv = jax_warp.crop_resize_batch(jnp.asarray(images),
                                            jnp.asarray(boxes), (32, 32))
    pc, pr, pv = warp.crop_resize_batch(_t(images), _t(boxes), (32, 32))
    np.testing.assert_allclose(_np(pc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(_np(pr), np.asarray(jr), rtol=1e-7)
    np.testing.assert_array_equal(_np(pv), np.asarray(jv))

    kpts = rng.uniform(0, 32, (3, 10, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(warp.unwarp_keypoints(_t(kpts), _t(boxes), pr)),
        np.asarray(jax_warp.unwarp_keypoints(jnp.asarray(kpts),
                                             jnp.asarray(boxes), jr)),
        atol=1e-5)

    jc, js, _ = jax_warp.resize_to_canvas(jnp.asarray(images[0]), (24, 24))
    pc, ps, _ = warp.resize_to_canvas(_t(images[0]), (24, 24))
    np.testing.assert_allclose(_np(pc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(float(ps), float(js), rtol=1e-6)


# ------------------------------------------------------------ nms / topk --

def _peaky_scores(rng, b, h, w):
    s = rng.uniform(0, 1, (b, h, w)) ** 4
    return s.astype(np.float32)


@pytest.mark.parametrize("radius", [1, 4])
def test_nms_and_borders_match_jax(rng, radius):
    s = _peaky_scores(rng, 2, 30, 44)
    j = jax_nms.remove_borders(jax_nms.simple_nms(jnp.asarray(s), radius), 4)
    p = nms.remove_borders(nms.simple_nms(_t(s), radius), 4)
    np.testing.assert_array_equal(_np(p), np.asarray(j))


@pytest.mark.parametrize("tile,k,threshold", [(0, 40, 0.05), (5, 40, 0.05),
                                              (5, 80, 0.0), (3, 100, 0.1)])
def test_topk_refine_and_descriptors_match_jax(rng, tile, k, threshold):
    raw = _peaky_scores(rng, 2, 40, 48)
    s = nms.simple_nms(_t(raw), max(tile - 1, 2)).numpy()
    j_xy, j_sc, j_v = jax_nms.topk_keypoints(jnp.asarray(s), k, threshold,
                                             nms_tile=tile)
    p_xy, p_sc, p_v = nms.topk_keypoints(_t(s), k, threshold, nms_tile=tile)
    assert_same_sets(keypoint_sets(p_xy, p_sc, p_v),
                     keypoint_sets(j_xy, j_sc, j_v), 1e-5)

    j_ref = jax_nms.refine_keypoints(jnp.asarray(raw), j_xy)
    p_ref = nms.refine_keypoints(_t(raw), p_xy)
    jr = by_position(j_xy, j_ref, j_v)
    pr = by_position(p_xy, p_ref, p_v)
    for a, b in zip(pr, jr):
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-4)

    desc_map = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    j_d = jax_nms.sample_descriptors(jnp.asarray(desc_map), j_ref, stride=8)
    p_d = nms.sample_descriptors(_t(desc_map), p_ref, stride=8)
    jd = by_position(j_xy, j_d, j_v)
    pd = by_position(p_xy, p_d, p_v)
    for a, b in zip(pd, jd):
        for key in a:
            np.testing.assert_allclose(a[key], b[key], atol=1e-4)


def test_bilinear_sample_matches_jax(rng):
    grid = rng.normal(size=(7, 9, 5)).astype(np.float32)
    xy = rng.uniform(-2, 11, (30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(nms.bilinear_sample(_t(grid), _t(xy))),
        np.asarray(jax_nms.bilinear_sample(jnp.asarray(grid),
                                           jnp.asarray(xy))), atol=1e-5)


# ------------------------------------------------------------ superpoint --

def _superpoint_pair(desc, k, hw, seed):
    kwargs = dict(max_keypoints=k, descriptor_dim=desc)
    jsp = JaxSuperPoint(**kwargs)
    shapes = jax.eval_shape(jsp.init, jax.random.key(0),
                            jnp.zeros((1, hw, hw, 1), jnp.float32))
    params = seeded_params(shapes, seed)
    psp = port.build_superpoint(device="cpu", **kwargs)
    psp.load_state_dict(convert_superpoint_params(params, **kwargs))
    return jsp, jax.tree.map(jnp.asarray, params), psp


@pytest.mark.parametrize("desc,k,hw", [(64, 64, 64), (256, 256, 128)])
def test_superpoint_matches_jax(rng, desc, k, hw):
    jsp, jparams, psp = _superpoint_pair(desc, k, hw, seed=desc)
    image = _smooth_images(rng, 2, hw, hw).mean(-1, keepdims=True)
    jout = jsp.apply(jparams, jnp.asarray(image))
    with torch.no_grad():
        pout = psp(_t(image))
    np.testing.assert_allclose(_np(pout["dense_scores"]),
                               np.asarray(jout["dense_scores"]), atol=1e-5)
    assert _np(pout["valid"]).sum() > k     # most slots hold a keypoint
    # Keypoints as sets, keyed by their refined positions rounded to the
    # integer pixel (refinement moves a point by at most 0.5 px).
    ints = lambda out: np.floor(_np(out["keypoints"]) + 0.5)
    p_sets = by_position(ints(pout), _np(pout["scores"]), pout["valid"])
    j_sets = by_position(ints(jout), np.asarray(jout["scores"]),
                         jout["valid"])
    assert_same_sets(p_sets, j_sets, 1e-5)
    for name, tol in (("keypoints", 1e-4), ("descriptors", 1e-4)):
        p = by_position(ints(pout), _np(pout[name]), pout["valid"])
        j = by_position(ints(jout), np.asarray(jout[name]), jout["valid"])
        for a, b in zip(p, j):
            for key in a:
                np.testing.assert_allclose(a[key], b[key], atol=tol,
                                           err_msg=name)


def test_grayscale_matches_jax(rng):
    from oetr_tpu.models.superpoint import grayscale as jax_grayscale
    img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(port.models.grayscale(_t(img))),
        np.asarray(jax_grayscale(jnp.asarray(img))), atol=1e-6)


# -------------------------------------------------------------- sinkhorn --

def _ot_inputs(rng, dtype):
    b, m, n = 3, 40, 56
    scores = rng.normal(0, 2, (b, m, n)).astype(np.float32)
    mask0 = rng.random((b, m)) > 0.15
    mask1 = rng.random((b, n)) > 0.1
    mask1[1, 30:] = False            # k1 != k0 valid
    mask0[2] = False                 # a pair with no valid keypoint
    mask1[2] = False
    js = jnp.asarray(scores).astype(dtype)
    ps = _t(scores).to(torch.bfloat16 if dtype == jnp.bfloat16
                       else torch.float32)
    return js, ps, mask0, mask1


def assert_log_assignment_close(port_la, jax_la, tol=SINKHORN_TOL):
    """Unmasked entries and dustbins within ``tol``; masked entries (the
    -1e9 sentinel) only below MASKED on both sides."""
    p, j = _np(port_la), np.asarray(jax_la)
    assert np.isfinite(p).all() and np.isfinite(j).all()
    masked = j <= MASKED
    np.testing.assert_array_equal(p <= MASKED, masked)
    np.testing.assert_allclose(p[~masked], j[~masked], rtol=0, atol=tol)


@pytest.mark.parametrize("use_cuda", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_log_optimal_transport_matches_jax_pallas(rng, use_cuda, dtype):
    js, ps, mask0, mask1 = _ot_inputs(rng, dtype)
    jla = jax_sinkhorn.log_optimal_transport(
        js, 0.7, 30, jnp.asarray(mask0), jnp.asarray(mask1), use_pallas=True)
    pla = sinkhorn.log_optimal_transport(ps, 0.7, 30, _t(mask0), _t(mask1),
                                         use_cuda=use_cuda)
    assert pla.dtype == torch.float32 and pla.shape == (3, 41, 57)
    assert_log_assignment_close(pla, jla)
    # The empty pair: finite, and only the corner carries mass, the 1e-9
    # floor of its dustbin marginals.
    assert abs(float(pla[2, -1, -1]) - np.log(1e-9)) < 1e-4


def test_log_sinkhorn_cuda_takes_plain_on_cpu(rng):
    cost = _t(rng.normal(size=(2, 9, 11)).astype(np.float32))
    mu = _t(np.full((2, 9), -np.log(9), np.float32))
    nu = _t(np.full((2, 11), -np.log(11), np.float32))
    before = sinkhorn.log_sinkhorn_cuda.launches
    out = sinkhorn.log_sinkhorn_cuda(cost, mu, nu, 7)
    assert sinkhorn.log_sinkhorn_cuda.launches == before   # no kernel here
    torch.testing.assert_close(out, sinkhorn.log_sinkhorn(cost, mu, nu, 7),
                               rtol=0, atol=0)
    # The kernel's plan on an H100 (132 SMs, 232,448 B a block): one pair
    # of 2049² a launch; 16 small pairs in one.
    assert sinkhorn.sinkhorn_plan(8, 2049, 2049, 132,
                                  232448).pairs_per_launch == 1
    assert sinkhorn.sinkhorn_plan(16, 21, 13, 132, 232448).launches == 1


def test_extract_matches_matches_jax(rng):
    la = rng.normal(0, 3, (2, 21, 17)).astype(np.float32)
    mask0 = rng.random((2, 20)) > 0.2
    mask1 = rng.random((2, 16)) > 0.2
    for thr in (0.0, 0.2):
        j = jax_sinkhorn.extract_matches(jnp.asarray(la), thr,
                                         jnp.asarray(mask0),
                                         jnp.asarray(mask1))
        p = sinkhorn.extract_matches(_t(la), thr, _t(mask0), _t(mask1))
        for a, b in zip(p, j):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


# ------------------------------------------------------------- superglue --

NEAR_TIES = {"narrow_2_layers": 2, "full_9_layers": 4}
SG_CASES = {
    "narrow_2_layers": dict(descriptor_dim=32, keypoint_encoder_layers=(8, 16),
                            gnn_layers=2, nhead=2),
    "full_9_layers": dict(),
}


def _superglue_pair(kwargs, k, seed):
    jsg = JaxSuperGlue(pallas_sinkhorn=True, **kwargs)
    d = jsg.descriptor_dim
    dummy = {"keypoints0": jnp.zeros((1, k, 2)),
             "keypoints1": jnp.zeros((1, k, 2)),
             "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
             "descriptors0": jnp.zeros((1, k, d)),
             "descriptors1": jnp.zeros((1, k, d)),
             "valid0": jnp.ones((1, k), bool), "valid1": jnp.ones((1, k), bool),
             "image_hw0": (64, 64), "image_hw1": (64, 64)}
    shapes = jax.eval_shape(lambda key: jsg.init(key, dummy),
                            jax.random.key(0))
    # The residual branches' last layers and the keypoint encoder's output
    # are scaled down: at N(0, 1/fan_in) each of the 2 x 9 rounds adds a
    # vector of norm ~sqrt(2d) and the scores reach |600|, where f32 itself
    # is coarser than the 1e-4 tolerance (in float64 the two GNNs agree to
    # the f32 Sinkhorn's rounding at that size).
    params = seeded_params(shapes, seed, shrink=("mlp2", "out"))
    psg = port.build_superglue(device="cpu", cuda_sinkhorn=True, **kwargs)
    psg.load_state_dict(convert_superglue_params(params, **kwargs))
    return jsg, jax.tree.map(jnp.asarray, params), psg


def _superglue_data(rng, b, k, d, hw):
    desc = rng.normal(size=(2, b, k, d)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    data = {"keypoints0": rng.uniform(0, hw, (b, k, 2)).astype(np.float32),
            "keypoints1": rng.uniform(0, hw, (b, k, 2)).astype(np.float32),
            "scores0": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "scores1": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "descriptors0": desc[0], "descriptors1": desc[1],
            "valid0": rng.random((b, k)) > 0.2,
            "valid1": rng.random((b, k)) > 0.1}
    return data


def match_ties(log_assignment, valid0, valid1):
    """[B, M] bool: valid rows whose top two probabilities over the valid
    columns differ by less than TIE, or whose argmax column's top two over
    the valid rows do."""
    probs = np.exp(np.asarray(log_assignment, np.float64)[:, :-1, :-1])
    probs = np.where(valid0[:, :, None] & valid1[:, None, :], probs, -1.0)
    top = np.sort(probs, axis=2)
    row_tie = top[..., -1] - top[..., -2] < TIE
    topc = np.sort(probs, axis=1)
    col_tie = topc[:, -1] - topc[:, -2] < TIE
    arg = probs.argmax(axis=2)
    return valid0 & (row_tie | np.take_along_axis(col_tie, arg, axis=1))


def assert_matches_agree(p_matches, j_matches, log_assignment, valid0,
                         valid1):
    """matches0 equal except at near-ties; returns the near-tie count."""
    p, j = _np(p_matches), np.asarray(j_matches)
    ties = match_ties(log_assignment, valid0, valid1)
    assert ((p == j) | ties).all()
    return int(ties.sum())


@pytest.mark.parametrize("case", sorted(SG_CASES))
def test_superglue_matches_jax(rng, case):
    kwargs = SG_CASES[case]
    k, hw = 64, 96
    jsg, jparams, psg = _superglue_pair(kwargs, k, seed=3)
    data = _superglue_data(rng, 2, k, jsg.descriptor_dim, hw)
    jout = jsg.apply(jparams, {**{n: jnp.asarray(v) for n, v in data.items()},
                               "image_hw0": (hw, hw), "image_hw1": (hw, hw)})
    before = sinkhorn.log_sinkhorn_cuda.launches
    with torch.no_grad():
        pout = psg({**{n: _t(v) for n, v in data.items()},
                    "image_hw0": (hw, hw), "image_hw1": (hw, hw)})
    assert sinkhorn.log_sinkhorn_cuda.launches == before   # CPU: plain
    assert_log_assignment_close(pout["log_assignment"],
                                jout["log_assignment"])
    ties = assert_matches_agree(pout["matches0"], jout["matches0"],
                                jout["log_assignment"], data["valid0"],
                                data["valid1"])
    # Re-extracted at threshold 0, where every mutual argmax counts.
    j0 = jax_sinkhorn.extract_matches(jout["log_assignment"], 0.0,
                                      jnp.asarray(data["valid0"]),
                                      jnp.asarray(data["valid1"]))[0]
    p0 = sinkhorn.extract_matches(pout["log_assignment"], 0.0,
                                  _t(data["valid0"]), _t(data["valid1"]))[0]
    ties0 = assert_matches_agree(p0, j0, jout["log_assignment"],
                                 data["valid0"], data["valid1"])
    assert (np.asarray(j0) > -1).sum() > 10
    # The seed gives NEAR_TIES[case] near-ties (top two within TIE); the
    # two frameworks pick the same match at each of them all the same.
    assert ties == ties0 == NEAR_TIES[case]
    np.testing.assert_allclose(_np(pout["matching_scores0"]),
                               np.asarray(jout["matching_scores0"]),
                               atol=1e-5)


# -------------------------------------------------------------- pipeline --

OETR_BB = dict(depth=18, stop_layer="layer3", last_layer=256)
OETR_NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1)
SP_KW = dict(max_keypoints=64)
SG_KW = dict(descriptor_dim=256, gnn_layers=2, match_threshold=0.0)


def _pipelines(seed):
    """The JAX and port pipelines with the same seeded weights: a small
    OETR (plain linear attention on both sides; the port's switches
    otherwise match the JAX ones), SuperPoint at k = 64 and a 2-layer
    SuperGlue with the Sinkhorn kernel switch on (JAX: Pallas, interpreted;
    port: K4's plain version on the CPU). Threshold 0 keeps random-weight
    match counts apart, so the retry fires for some pairs and not others."""
    canvas, oetr_hw = (96, 96), (160, 160)
    joetr = build_oetr(OETRConfig(backbone=BackboneConfig(**OETR_BB),
                                  neck=NeckConfig(**OETR_NECK)))
    zo = jnp.zeros((1,) + oetr_hw + (3,), jnp.float32)
    oparams = seeded_params(jax.eval_shape(joetr.init, jax.random.key(0),
                                           zo, zo), seed)
    jsp = JaxSuperPoint(**SP_KW)
    spp = seeded_params(jax.eval_shape(
        jsp.init, jax.random.key(0), jnp.zeros((1,) + canvas + (1,))),
        seed + 1)
    jsg, sgp, psg = _superglue_pair(SG_KW, SP_KW["max_keypoints"], seed + 2)

    pcfg_oetr = port.OETRConfig(backbone=port.BackboneConfig(**OETR_BB),
                                neck=port.NeckConfig(**OETR_NECK))
    poetr = port.build_oetr(pcfg_oetr, device="cpu")
    poetr.load_state_dict(convert_flax_params(oparams, pcfg_oetr))
    psp = port.build_superpoint(device="cpu", **SP_KW)
    psp.load_state_dict(convert_superpoint_params(spp, **SP_KW))

    kw = dict(canvas_hw=canvas, oetr_hw=oetr_hw, retry_batch=2)
    jpipe = JaxSparsePipeline(
        jsp, jax.tree.map(jnp.asarray, spp),
        lambda d: jsg.apply(sgp, d), oetr=joetr,
        oetr_params=jax.tree.map(jnp.asarray, oparams),
        cfg=JaxPipelineConfig(**kw))
    ppipe = port.SparsePipeline(psp, psg, oetr=poetr,
                                cfg=port.PipelineConfig(**kw))
    return jpipe, ppipe


def test_sparse_pipeline_matches_jax(rng):
    b, full = 5, 128
    im0 = _smooth_images(rng, b, full, full)
    im1 = np.roll(im0, (9, -6), axis=(1, 2)) * 0.9 + 0.05
    o0 = _smooth_images(rng, b, 160, 160)
    o1 = np.roll(o0, (12, -7), axis=(1, 2))
    hw = np.full((b, 2), full, np.int32)
    hw[3] = (120, 100)                               # a smaller valid extent
    sc = np.full((b, 2), full / 160.0, np.float32)
    jargs = [jnp.asarray(a) for a in (im0, im1, hw, hw, o0, o1, sc, sc)]
    pargs = [_t(a) for a in (im0, im1, hw, hw, o0, o1, sc, sc)]
    jpipe, ppipe = _pipelines(seed=11)

    # The overlap pass alone: boxes, gate and the counts the retry reads.
    jfirst = jpipe._jit_overlap(*jargs)
    pfirst = ppipe._run(*pargs, use_overlap=True)
    for key in ("bbox0", "bbox1"):
        np.testing.assert_allclose(_np(pfirst[key]), np.asarray(jfirst[key]),
                                   rtol=0, atol=5e-3, err_msg=key)
    np.testing.assert_array_equal(_np(pfirst["used_overlap"]),
                                  np.asarray(jfirst["used_overlap"]))
    counts = np.asarray(jfirst["num_matches"])
    np.testing.assert_array_equal(_np(pfirst["num_matches"]), counts)
    assert np.asarray(jfirst["used_overlap"]).all()
    # Retry every pair below the best pair's count: some pairs, not all.
    min_matches = int(counts.max())
    retried = counts < min_matches
    assert 0 < retried.sum() < b
    jpipe.cfg = dataclasses.replace(jpipe.cfg,
                                    fallback_min_matches=min_matches)
    ppipe.cfg = dataclasses.replace(ppipe.cfg,
                                    fallback_min_matches=min_matches)

    jout = jpipe(*jargs, with_overlap=True)
    before = sinkhorn.log_sinkhorn_cuda.launches
    pout = ppipe(*pargs, with_overlap=True)
    assert sinkhorn.log_sinkhorn_cuda.launches == before   # CPU: plain
    np.testing.assert_array_equal(_np(pout["used_overlap"]), ~retried)
    np.testing.assert_array_equal(np.asarray(jout["used_overlap"]), ~retried)
    for key in ("bbox0", "bbox1"):
        np.testing.assert_allclose(_np(pout[key]), np.asarray(jout[key]),
                                   rtol=0, atol=5e-3, err_msg=key)
    np.testing.assert_array_equal(_np(pout["num_matches"]),
                                  np.asarray(jout["num_matches"]))
    def match_set(out, i):
        """Pair i's matches as (xy0, xy1) keypoint positions, 1/8 px grid."""
        xy0, xy1 = (np.floor(_np(out[f"keypoints{s}"])[i] * 8 + 0.5)
                    for s in "01")
        m, v0 = _np(out["matches0"])[i], _np(out["valid0"])[i]
        return {(tuple(xy0[a]), tuple(xy1[m[a]]))
                for a in range(len(m)) if m[a] > -1 and v0[a]}

    for i in range(b):
        for s in "01":
            kp = np.floor(_np(pout[f"keypoints{s}"])[i] * 8 + 0.5)
            kj = np.floor(np.asarray(jout[f"keypoints{s}"])[i] * 8 + 0.5)
            assert ({tuple(p) for p in kp[_np(pout[f"valid{s}"])[i]]}
                    == {tuple(p) for p in kj[np.asarray(
                        jout[f"valid{s}"])[i]]}), (i, s)
        assert match_set(pout, i) == match_set(jout, i), i
