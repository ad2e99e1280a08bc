"""The port's LoFTR and dense pipeline against the JAX package, on the CPU.

The same seeded numpy params (the port's through ``convert_loftr_params``)
and inputs go through both, in float32: ``ResNetFPN_8_2``, the encoder
layer (linear and full attention, with and without masks), the
(self, cross) module, ``_gather_windows``, the whole ``LoFTR`` on every
output key, the trained ``.ckpt_loftr_r5`` at its full widths on scene
pairs, and ``DensePipeline`` with a small OETR and a small LoFTR (boxes,
the gate, the retry, the matches). LoFTR reaches no Pallas kernel in JAX,
and none in the port.

Random-weight LoFTRs give diffuse coarse confidences, so the small models
match at threshold 0: every mutual nearest neighbour counts. Their top K
holds every coarse cell (K >= N), so it has valid and invalid rows.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.models import loftr as jloftr
from oetr_tpu.pipelines import DensePipeline as JaxDensePipeline
from oetr_tpu.pipelines import PipelineConfig as JaxPipelineConfig
from oetr_tpu_torch.interop import convert_flax_params, convert_loftr_params
from oetr_tpu_torch.interop.from_flax import _state_dict
from oetr_tpu_torch.models import loftr as ploftr
from oetr_tpu_torch.models.layers import materialize
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / ".ckpt_loftr_r5" / "loftr"
SMALL = dict(d_coarse=64, d_fine=32, coarse_layers=1, fine_layers=1, nhead=4,
             match_threshold=0.0, max_matches=1024)
# float32 end to end, summed in other orders: features and coarse
# confidences to ~1e-6 of their scale; the soft-argmax positions (~100 px,
# where an f32 step is 7.6e-6) to ~1.3e-4 px.
FEAT_TOL = 1e-4
CONF_TOL = 1e-6
PX_TOL = 5e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _gray_pairs(rng, b, hw):
    """Grayscale pairs in [0, 1] with structure at the 8-px cell scale;
    image 1 is image 0 shifted, brightened a little."""
    small = rng.uniform(0, 1, (b, hw // 8, hw // 8, 1))
    im0 = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)
    im0 = np.clip(im0 + 0.05 * rng.normal(size=im0.shape), 0, 1)
    im1 = np.clip(np.roll(im0, (5, -3), axis=(1, 2)) * 0.9 + 0.05, 0, 1)
    return im0.astype(np.float32), im1.astype(np.float32)


def _loftr_pair(hw, seed, **kw):
    kwargs = {**SMALL, **kw}
    jm = jloftr.LoFTR(**kwargs)
    z = jnp.zeros((1, hw, hw, 1), jnp.float32)
    params = seeded_params(jax.eval_shape(jm.init, jax.random.key(0), z, z),
                           seed)
    pm = port.build_loftr(device="cpu", **kwargs)
    pm.load_state_dict(convert_loftr_params(params, **kwargs))
    return jm, jax.tree.map(jnp.asarray, params), pm


def _module_pair(jmodule, pmodule, init_args, seed):
    """A flax module and the port's module of the same shapes, with the
    same seeded params."""
    params = seeded_params(jax.eval_shape(jmodule.init, jax.random.key(0),
                                          *init_args), seed)
    pmodule = materialize(pmodule, "cpu", None)
    pmodule.load_state_dict(_state_dict(params["params"], pmodule))
    return jax.tree.map(jnp.asarray, params), pmodule


# ---------------------------------------------------------------- modules --

@pytest.mark.parametrize("hw", [64, 128])
def test_resnet_fpn_matches_jax(rng, hw):
    """The backbone alone, the FPN's two exact 2x bilinear resizes
    included (F.interpolate, half-pixel, edges renormalised)."""
    jm = jloftr.ResNetFPN_8_2(initial_dim=32, block_dims=(32, 48, 64),
                              d_fine=32)
    x = _gray_pairs(rng, 2, hw)[0]
    with torch.device("meta"):
        pm = ploftr.ResNetFPN_8_2(32, (32, 48, 64), 32)
    params, pm = _module_pair(jm, pm, (jnp.zeros((1, hw, hw, 1)),), seed=4)
    jc, jf = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        pc, pf = pm(_t(x))
    assert pc.shape == (2, hw // 8, hw // 8, 64)
    assert pf.shape == (2, hw // 2, hw // 2, 32)
    np.testing.assert_allclose(_np(pc), np.asarray(jc), rtol=0, atol=FEAT_TOL)
    np.testing.assert_allclose(_np(pf), np.asarray(jf), rtol=0, atol=FEAT_TOL)
    # 48 channels take 16 groups, the others 32.
    assert pm._BasicBlock_2.GroupNorm_0.num_groups == 16
    assert pm._BasicBlock_4.GroupNorm_0.num_groups == 32
    assert pm.GroupNorm_0.eps == 1e-6


def test_upsample_is_jax_bilinear_resize(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    j = jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), "bilinear")
    p = ploftr._upsample2(_t(x).permute(0, 3, 1, 2),
                          torch.zeros(2, 3, 10, 14)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(p), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("attention", ["linear", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_matches_jax(rng, attention, masked):
    d, b, n, s = 32, 2, 20, 13
    jm = jloftr.LoFTREncoderLayer(d, 4, attention)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    src = rng.normal(size=(b, s, d)).astype(np.float32)
    xm = rng.random((b, n)) > 0.2 if masked else None
    sm = rng.random((b, s)) > 0.2 if masked else None
    with torch.device("meta"):
        pm = ploftr.LoFTREncoderLayer(d, 4, attention)
    params, pm = _module_pair(jm, pm, (jnp.asarray(x), jnp.asarray(src)),
                              seed=5)
    j = jm.apply(params, jnp.asarray(x), jnp.asarray(src),
                 None if xm is None else jnp.asarray(xm),
                 None if sm is None else jnp.asarray(sm))
    with torch.no_grad():
        p = pm(_t(x), _t(src), None if xm is None else _t(xm),
               None if sm is None else _t(sm))
    np.testing.assert_allclose(_np(p), np.asarray(j), rtol=0, atol=FEAT_TOL)


def test_loftr_module_matches_jax(rng):
    d, b, n = 32, 2, 25
    jm = jloftr.LoFTRModule(d, 2, 4)
    f0, f1 = (rng.normal(size=(b, n, d)).astype(np.float32) for _ in "01")
    m0, m1 = rng.random((b, n)) > 0.1, rng.random((b, n)) > 0.1
    with torch.device("meta"):
        pm = ploftr.LoFTRModule(d, 2, 4)
    params, pm = _module_pair(jm, pm, (jnp.asarray(f0), jnp.asarray(f1)),
                              seed=6)
    assert sorted(params["params"]) == ["cross_0", "cross_1", "self_0",
                                        "self_1"]
    j = jm.apply(params, *(jnp.asarray(a) for a in (f0, f1, m0, m1)))
    with torch.no_grad():
        p = pm(*(_t(a) for a in (f0, f1, m0, m1)))
    for a, c in zip(p, j):
        np.testing.assert_allclose(_np(a), np.asarray(c), rtol=0,
                                   atol=FEAT_TOL)


def test_gather_windows_matches_jax(rng):
    feat = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    # Centres inside, on the edges and past them (clamped), fractional
    # (truncated toward zero).
    cen = rng.uniform(-1.5, 12.5, (2, 7, 2)).astype(np.float32)
    cen[0, 0] = [0.0, 0.0]
    cen[0, 1] = [10.9, 8.9]
    p = ploftr._gather_windows(_t(feat), _t(cen), 5)
    assert p.shape == (2, 7, 25, 6)
    for i in range(2):
        j = jloftr._gather_windows(jnp.asarray(feat[i]), jnp.asarray(cen[i]),
                                   5)
        np.testing.assert_array_equal(_np(p[i]), np.asarray(j))


def _assert_loftr_outputs_match(pout, jout):
    assert set(pout) == set(jout)
    np.testing.assert_allclose(_np(pout["coarse_conf"]),
                               np.asarray(jout["coarse_conf"]), rtol=0,
                               atol=CONF_TOL)
    # Every row of the top K, the invalid ones (row best 0, ordered by
    # index) included, in the same order.
    for key in ("valid", "cells0", "cells1", "mkpts0", "mkpts1_coarse"):
        np.testing.assert_array_equal(_np(pout[key]), np.asarray(jout[key]),
                                      err_msg=key)
    np.testing.assert_allclose(_np(pout["conf"]), np.asarray(jout["conf"]),
                               rtol=0, atol=CONF_TOL)
    np.testing.assert_allclose(_np(pout["mkpts1"]), np.asarray(jout["mkpts1"]),
                               rtol=0, atol=PX_TOL)


@pytest.mark.parametrize("hw", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_loftr_matches_jax(rng, hw, masked):
    jm, jp, pm = _loftr_pair(hw, seed=7)
    im0, im1 = _gray_pairs(rng, 2, hw)
    g = hw // 8
    m0 = rng.random((2, g, g)) > 0.15 if masked else None
    m1 = rng.random((2, g, g)) > 0.15 if masked else None
    args = [im0, im1] + ([m0, m1] if masked else [])
    jout = jm.apply(jp, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        pout = pm(*(_t(a) for a in args))
    valid = _np(pout["valid"])
    assert 0 < valid.sum() < valid.size       # valid and invalid rows
    _assert_loftr_outputs_match(pout, jout)


# ------------------------------------------------------------- converter --

def test_converter_is_strict():
    kw = dict(d_coarse=64, d_fine=32, coarse_layers=1)
    z = jnp.zeros((1, 64, 64, 1), jnp.float32)
    shapes = jax.eval_shape(jloftr.LoFTR(**kw).init, jax.random.key(0), z, z)
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = convert_loftr_params(params, **kw)
    assert len(state) == len(jax.tree.leaves(params))
    assert state["backbone._BasicBlock_2.Conv_2.weight"].shape == (48, 32, 1,
                                                                   1)
    assert state["coarse.self_0.Dense_0.weight"].shape == (128, 128)

    params["params"]["fine"]["self_0"]["extra"] = {
        "kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="does not have"):
        convert_loftr_params(params, **kw)
    del params["params"]["fine"]["self_0"]["extra"]
    del params["params"]["fine_proj"]["bias"]
    with pytest.raises(KeyError, match="left unset"):
        convert_loftr_params(params, **kw)


def test_bench_widths_parameter_count():
    """bench stage 6's LoFTR: the flax tree and the port's state_dict hold
    the same 5,912,736 parameters, leaf for leaf."""
    kw = dict(d_coarse=192, d_fine=96, coarse_layers=4)
    z = jnp.zeros((1, 64, 64, 1), jnp.float32)
    shapes = jax.eval_shape(jloftr.LoFTR(**kw).init, jax.random.key(0), z, z)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = port.build_loftr(device="meta", **kw)
    n_port = sum(p.numel() for p in model.parameters())
    assert n_flax == n_port == 5_912_736
    assert model.backbone._BasicBlock_2.GroupNorm_0.num_groups == 16


# ------------------------------------------------------- trained weights --

def test_trained_checkpoint_matches_jax():
    """.ckpt_loftr_r5 at its widths (bench stage 6), 256², on 2 scene pairs
    from JAX's generator: coarse_conf within 1e-5, the valid match sets
    (cells0 -> cells1) agree on >= 99%, and the agreed image-1 positions
    within 1e-3 px."""
    import orbax.checkpoint as ocp

    from oetr_tpu.data.device_synth import make_device_generator

    hw = 256
    kw = dict(d_coarse=192, d_fine=96, coarse_layers=4, max_matches=1024)
    model = jloftr.LoFTR(**kw)
    z = jnp.zeros((1, hw, hw, 1), jnp.float32)
    template = jax.jit(model.init)(jax.random.key(0), z, z)
    params = ocp.StandardCheckpointer().restore(str(CKPT), template)
    raw = make_device_generator(hw, 2, scale_range=(1.0, 2.0),
                                p_translate=0.5)(jax.random.key(991))
    lum = np.asarray([0.299, 0.587, 0.114], np.float32)
    g0 = (np.asarray(raw["image1"], np.float32) @ lum)[..., None]
    g1 = (np.asarray(raw["image2"], np.float32) @ lum)[..., None]
    jout = jax.jit(model.apply)(params, jnp.asarray(g0), jnp.asarray(g1))

    pm = port.build_loftr(device="cpu", **kw)
    pm.load_state_dict(convert_loftr_params(
        jax.tree.map(np.asarray, params), **kw))
    with torch.no_grad():
        pout = pm(_t(g0), _t(g1))

    np.testing.assert_allclose(_np(pout["coarse_conf"]),
                               np.asarray(jout["coarse_conf"]), rtol=0,
                               atol=1e-5)
    for i in range(2):
        def matches(out):
            v = _np(out["valid"])[i]
            c0, c1 = _np(out["cells0"])[i][v], _np(out["cells1"])[i][v]
            xy = _np(out["mkpts1"])[i][v]
            return {(a, b): p for a, b, p in zip(c0, c1, xy)}
        pm_, jm_ = matches(pout), matches(jout)
        assert len(jm_) >= 100, len(jm_)      # the trained model matches
        agreed = set(pm_) & set(jm_)
        assert len(agreed) >= 0.99 * max(len(pm_), len(jm_))
        err = max(np.abs(pm_[k] - jm_[k]).max() for k in agreed)
        assert err <= 1e-3, err


# ---------------------------------------------------------- the pipeline --

OETR_BB = dict(depth=18, stop_layer="layer3", last_layer=256)
OETR_NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1)
CANVAS, OETR_HW = (96, 96), (160, 160)


def _pipelines(seed):
    """The JAX and port dense pipelines with the same seeded weights: a
    small OETR (plain linear attention on both sides) and a small LoFTR at
    threshold 0."""
    joetr = build_oetr(OETRConfig(backbone=BackboneConfig(**OETR_BB),
                                  neck=NeckConfig(**OETR_NECK)))
    zo = jnp.zeros((1,) + OETR_HW + (3,), jnp.float32)
    oparams = seeded_params(jax.eval_shape(joetr.init, jax.random.key(0),
                                           zo, zo), seed)
    jlf, lparams, plf = _loftr_pair(CANVAS[0], seed + 1)
    pcfg_oetr = port.OETRConfig(backbone=port.BackboneConfig(**OETR_BB),
                                neck=port.NeckConfig(**OETR_NECK))
    poetr = port.build_oetr(pcfg_oetr, device="cpu")
    poetr.load_state_dict(convert_flax_params(oparams, pcfg_oetr))
    kw = dict(canvas_hw=CANVAS, oetr_hw=OETR_HW, retry_batch=2)
    jpipe = JaxDensePipeline(jlf, lparams, oetr=joetr,
                             oetr_params=jax.tree.map(jnp.asarray, oparams),
                             cfg=JaxPipelineConfig(**kw))
    ppipe = port.DensePipeline(plf, oetr=poetr,
                               cfg=port.PipelineConfig(**kw))
    return jpipe, ppipe


def _dense_inputs(rng, b, full):
    small = rng.uniform(0, 1, (b, full // 8, full // 8, 3))
    im0 = np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)
    im0 = np.clip(im0 + 0.05 * rng.normal(size=im0.shape), 0, 1)
    im1 = np.roll(im0, (9, -6), axis=(1, 2)) * 0.9 + 0.05
    o0 = rng.uniform(0, 1, (b,) + OETR_HW + (3,))
    o1 = np.roll(o0, (12, -7), axis=(1, 2))
    hw = np.full((b, 2), full, np.int32)
    hw[3] = (120, 100)                               # a smaller valid extent
    sc = np.full((b, 2), full / OETR_HW[0], np.float32)
    arrays = [a.astype(np.float32) if a.dtype.kind == "f" else a
              for a in (im0, im1, hw, hw, o0, o1, sc, sc)]
    return ([jnp.asarray(a) for a in arrays], [_t(a) for a in arrays])


def _assert_dense_match(pout, jout):
    assert set(pout) == set(jout)
    for key in ("bbox0", "bbox1"):
        np.testing.assert_allclose(_np(pout[key]), np.asarray(jout[key]),
                                   rtol=0, atol=5e-3, err_msg=key)
    for key in ("used_overlap", "num_matches", "valid"):
        np.testing.assert_array_equal(_np(pout[key]), np.asarray(jout[key]),
                                      err_msg=key)
    # The crops agree to ~1e-6 (the two crop_resize_batch sum in other
    # orders); the random-weight network takes that to ~2e-4 of a coarse
    # confidence, enough to swap neighbours of the top K whose confidences
    # lie closer. So each pair's valid matches are compared as a set,
    # paired by their image-0 position (cells are >= 6 px apart).
    v = np.asarray(jout["valid"])
    for i in range(v.shape[0]):
        p0 = _np(pout["mkpts0"])[i][v[i]]
        j0 = np.asarray(jout["mkpts0"])[i][v[i]]
        dist = np.abs(p0[:, None] - j0[None]).max(-1)
        assert (dist.min(1) <= 1e-3).all(), i
        perm = dist.argmin(1)
        assert len(set(perm.tolist())) == len(perm), i
        for key, rtol, atol in (("mkpts1", 0, 1e-3), ("conf", 1e-3, 1e-6)):
            np.testing.assert_allclose(
                _np(pout[key])[i][v[i]], np.asarray(jout[key])[i][v[i]][perm],
                rtol=rtol, atol=atol, err_msg=f"pair {i} {key}")


@pytest.mark.parametrize("with_overlap", [True, False])
def test_dense_pipeline_matches_jax(rng, with_overlap):
    b, full = 5, 128
    jargs, pargs = _dense_inputs(rng, b, full)
    jpipe, ppipe = _pipelines(seed=21)
    # No pair retries here: that is the next test's.
    for pipe in (jpipe, ppipe):
        pipe.cfg = dataclasses.replace(pipe.cfg, fallback_min_matches=0)
    jout = jpipe(*jargs, with_overlap=with_overlap)
    pout = ppipe(*pargs, with_overlap=with_overlap)
    assert _np(pout["used_overlap"]).all() == with_overlap
    assert _np(pout["num_matches"]).min() > 0
    _assert_dense_match(pout, jout)


def test_dense_pipeline_retry_matches_jax(rng):
    """Pairs below the best pair's match count take the full-image retry
    (retry_batch 2): some pairs, not all."""
    b, full = 5, 128
    jargs, pargs = _dense_inputs(rng, b, full)
    jpipe, ppipe = _pipelines(seed=21)
    first = ppipe._run(*pargs, use_overlap=True)
    counts = _np(first["num_matches"])
    np.testing.assert_array_equal(
        counts, np.asarray(jpipe._jit_run(*jargs)["num_matches"]))
    min_matches = int(counts.max())
    retried = counts < min_matches
    assert 0 < retried.sum() < b
    for pipe in (jpipe, ppipe):
        pipe.cfg = dataclasses.replace(pipe.cfg,
                                       fallback_min_matches=min_matches)
    jout = jpipe(*jargs)
    pout = ppipe(*pargs)
    np.testing.assert_array_equal(_np(pout["used_overlap"]), ~retried)
    _assert_dense_match(pout, jout)
    # A retried pair carries the full-image call's results.
    plain = ppipe._run(*[a[_t(retried)] for a in pargs[:4]])
    np.testing.assert_array_equal(_np(pout["num_matches"])[retried],
                                  _np(plain["num_matches"]))
