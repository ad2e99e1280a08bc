"""The OETR variants of the port against the JAX package, on the CPU.

The frozen BatchNorm and LayerNorm backbones, the space-to-depth stem (and
its kernel map), DETR's positional embedding, PatchEmbed and the CBAM
gates, each against its JAX module; the whole OETR with each variant; and
the profiling helpers (one train step with each of two variants:
``test_torch_port_variants_train.py``). The same
seeded numpy inputs and params go to both sides (the port's through
``convert_flax_params`` and its module converters). JAX runs jitted with
x64 off, as in production; float32 unless stated.

Bounds:
  FrozenBatchNorm f32                 1e-6 of max(1, |ref|)
                  bf16                equal
  the encoders                        1e-4 of max(1, the largest |ref|)
  space_to_depth_kernel               bit-equal
  s2d stem against the 7x7 stem       1e-5 of max(1, the largest |ref|)
                                      (the port against itself)
  detr_position_embedding             1e-5 (its phases reach 2*pi)
  PatchEmbed, ChannelAttention,
  SpatialAttention                    1e-6
  the whole OETR                      test_torch_port_oetr.py's: boxes
                                      5e-3 px, heat map 2e-6, ...
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.models import oetr as joetr
from oetr_tpu.models import resnet as jresnet
from oetr_tpu.models import transformer as jtransformer
from oetr_tpu.utils import profiling as jprofiling
from oetr_tpu_torch.interop import (convert_channelattention_params,
                                    convert_flax_params,
                                    convert_patchembed_params,
                                    convert_spatialattention_params)
from oetr_tpu_torch.interop.from_flax import _state_dict
from oetr_tpu_torch.models import oetr as poetr
from oetr_tpu_torch.models import resnet as presnet
from oetr_tpu_torch.models import transformer as ptransformer
from oetr_tpu_torch.utils import profiling as pprofiling
from test_torch_port_oetr import TOLS, seeded_params

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def variant_params(shapes, seed):
    """``seeded_params``, with a frozen BatchNorm's statistics as a trained
    network has them: means ~ N(0, 0.1²), variances in [0.5, 1.5]."""
    params = seeded_params(shapes, seed)
    rng = np.random.default_rng(seed + 1000)

    def stats(path, w):
        if path[-1].key == "mean":
            return (0.1 * rng.normal(size=w.shape)).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, w.shape).astype(np.float32)
        return w

    return jax.tree_util.tree_map_with_path(stats, params)


def _jit_apply(module, params, *args):
    with jax.enable_x64(False):
        out = jax.jit(module.apply)(jax.tree.map(jnp.asarray, params),
                                    *map(jnp.asarray, args))
        return jax.tree.map(np.asarray, out)


# ----------------------------------------------------------- modules --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batchnorm_matches_jax(dtype):
    """Statistics and affine from one seed; the multiplier and shift are
    formed in f32 and cast to the compute dtype on both sides."""
    rng = np.random.default_rng(0)
    c = 48
    x = (3 * rng.normal(size=(2, 5, 6, c))).astype(np.float32)
    params = {"params": {
        "scale": (1 + 0.3 * rng.normal(size=c)).astype(np.float32),
        "bias": (0.5 * rng.normal(size=c)).astype(np.float32),
        "mean": rng.normal(size=c).astype(np.float32),
        "var": rng.uniform(0.1, 3.0, c).astype(np.float32)}}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = _jit_apply(jresnet.FrozenBatchNorm(dtype=jdt), params,
                      x.astype(jdt)).astype(np.float32)
    tdt = getattr(torch, dtype)
    module = presnet.FrozenBatchNorm(c, tdt)
    module.load_state_dict({"weight": _t(params["params"]["scale"]),
                            "bias": _t(params["params"]["bias"]),
                            "mean": _t(params["params"]["mean"]),
                            "var": _t(params["params"]["var"])})
    with torch.no_grad():
        got = module(_nchw(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * max(1, np.abs(want).max()))
    else:
        # Two bf16 roundings (the product, then the sum) on both sides; a
        # multiply-add rounded once differs on ~30% of these entries.
        assert np.array_equal(got, want)


ENCODER_CASES = [(norm, s2d) for norm in ("gn", "ln", "bn")
                 for s2d in (False, True)]


@pytest.mark.parametrize("norm,s2d", ENCODER_CASES)
def test_encoder_matches_jax(norm, s2d):
    """ResNet-18 to layer3 at 64x64 with the fused-stem switch on: JAX and
    the port take K3 with 'gn' only (the port's plain version here)."""
    enc = jresnet.ResNetEncoder(depth=18, stop_layer="layer3", norm=norm,
                                stem_s2d=s2d, fused_stem=True)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    params = variant_params(
        jax.eval_shape(enc.init, jax.random.key(0), jnp.asarray(x)), seed=2)
    want = _jit_apply(enc, params, x)
    with torch.device("meta"):
        model = presnet.ResNetEncoder(18, "layer3", True, True,
                                      torch.float32, norm, s2d)
    state = _state_dict(params["params"], model)
    model = presnet.ResNetEncoder(18, "layer3", True, True, torch.float32,
                                  norm, s2d)
    model.load_state_dict(state)
    assert model.fused_stem == (norm == "gn")
    with torch.no_grad():
        got = model(_t(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1, np.abs(want).max()))


def test_space_to_depth_kernel_bit_equal():
    rng = np.random.default_rng(3)
    k7 = rng.normal(size=(7, 7, 3, 64)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jresnet.space_to_depth_kernel(jnp.asarray(k7)))
    got = presnet.space_to_depth_kernel(_t(k7.transpose(3, 2, 0, 1)))
    assert got.shape == (64, 12, 4, 4)
    assert np.array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("norm", ["gn", "ln", "bn"])
def test_s2d_stem_equals_7x7_stem(norm):
    """The port's s2d encoder with the 7x7 kernel mapped equals its 7x7
    encoder (tests/test_oetr_model.py's check of JAX's), to 1e-5 of the
    features' scale: the two convolutions sum in other orders."""
    g = torch.Generator().manual_seed(4)
    x = torch.rand(2, 64, 64, 3, generator=g)
    plain = presnet.ResNetEncoder(18, "layer2", norm=norm)
    s2d = presnet.ResNetEncoder(18, "layer2", norm=norm, stem_s2d=True)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3 + 1.0
                    if p.ndim == 1 else
                    torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
        state = dict(plain.state_dict())
        state["Conv_0.weight"] = presnet.space_to_depth_kernel(
            state["Conv_0.weight"])
        s2d.load_state_dict(state)
        a, b = plain(x), s2d(x)
    torch.testing.assert_close(b, a, rtol=0,
                               atol=1e-5 * max(1, a.abs().max().item()))


@pytest.mark.parametrize("normalize,scale", [(True, None), (False, None),
                                             (True, 1.0)])
def test_detr_position_embedding_matches_jax(normalize, scale):
    """Padded masks (a valid top-left block of each image, rows and columns
    beyond it padding), as DETR's batches have them."""
    mask = np.zeros((3, 6, 7), bool)
    for i, (h, w) in enumerate(((6, 7), (4, 5), (2, 7))):
        mask[i, :h, :w] = True
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(
            lambda m: joetr.detr_position_embedding(
                m, 32, normalize=normalize, scale=scale))(jnp.asarray(mask)))
    got = poetr.detr_position_embedding(_t(mask), 32, normalize=normalize,
                                        scale=scale)
    assert got.shape == (3, 6, 7, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _module_case(name, rng):
    """(JAX module, its input (NHWC or tokens), the port's module, the
    port's input layout permute or None, the converter's kwargs)."""
    if name.startswith("patch_embed"):
        hw = (8, 8) if name == "patch_embed" else (10, 9)
        x = rng.normal(size=(2, *hw, 16)).astype(np.float32)
        return (joetr.PatchEmbed(patch_size=4, embed_dim=24), x,
                convert_patchembed_params, poetr.PatchEmbed,
                dict(in_chans=16, patch_size=4, embed_dim=24), True)
    if name == "channel_attention":
        x = rng.normal(size=(2, 16, 32)).astype(np.float32)
        return (jtransformer.ChannelAttention(d_model=32, reduction=4), x,
                convert_channelattention_params,
                ptransformer.ChannelAttention,
                dict(d_model=32, reduction=4), False)
    k = int(name[-1])
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    return (jtransformer.SpatialAttention(kernel_size=k), x,
            convert_spatialattention_params, ptransformer.SpatialAttention,
            dict(kernel_size=k), True)


@pytest.mark.parametrize("name", ["patch_embed", "patch_embed_same_pad",
                                  "channel_attention", "spatial_attention_3",
                                  "spatial_attention_7"])
def test_parity_module_matches_jax(name):
    rng = np.random.default_rng(5)
    jmod, x, convert, cls, kwargs, image = _module_case(name, rng)
    params = seeded_params(
        jax.eval_shape(jmod.init, jax.random.key(0), jnp.asarray(x)), seed=6)
    want = _jit_apply(jmod, params, x)
    model = cls(**kwargs)
    model.load_state_dict(convert(params, **kwargs))
    with torch.no_grad():
        got = model(_nchw(x) if image else _t(x))
    if image:
        got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ models --

HW = 160
BB = dict(depth=18, stop_layer="layer3", last_layer=256)
NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1)
VARIANTS = {"bn": dict(norm="bn"), "ln": dict(norm="ln"),
            "s2d": dict(norm="gn", stem_s2d=True)}


def _configs(variant, neck=NECK):
    """(JAX config, the port's), the kernel switches on in both: the fused
    stem (taken with 'gn' only) and the fused encoder sublayer."""
    bb = dict(BB, fused_stem=True, **VARIANTS[variant])
    return (OETRConfig(backbone=BackboneConfig(**bb),
                       neck=NeckConfig(attention="linear:pallas", **neck)),
            port.OETRConfig(backbone=port.BackboneConfig(**bb),
                            neck=port.NeckConfig(attention="linear:cuda",
                                                 **neck)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_oetr_variant_matches_jax(monkeypatch, variant):
    """The whole OETR at 160x160 with masks, JAX's K2 in Pallas interpret
    mode, at test_torch_port_oetr.py's bounds."""
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    jcfg, pcfg = _configs(variant)
    model = build_oetr(jcfg)
    zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
    params = variant_params(
        jax.eval_shape(model.init, jax.random.key(0), zeros, zeros), seed=7)
    rng = np.random.default_rng(8)
    im1, im2 = rng.uniform(0, 1, (2, 2, HW, HW, 3)).astype(np.float32)
    m1, m2 = rng.random((2, 2, HW // 32, HW // 32)) > 0.2
    with jax.enable_x64(False):
        jout = jax.jit(model.apply)(jax.tree.map(jnp.asarray, params),
                                    im1, im2, m1, m2)
        jout = jax.tree.map(np.asarray, jout)
    pm = port.build_oetr(pcfg, device="cpu")
    pm.load_state_dict(convert_flax_params(params, pcfg))
    with torch.no_grad():
        pout = pm(_t(im1), _t(im2), _t(m1), _t(m2))
    assert set(pout) == set(jout)
    for key in sorted(jout):
        np.testing.assert_allclose(
            pout[key].numpy(), jout[key], atol=TOLS[key.rstrip("12")],
            rtol=1e-4 if key.startswith("mem") else 0, err_msg=key)
    inner = pout["pred_bbox1"].numpy()
    assert ((inner > 0) & (inner < HW)).any()


# --------------------------------------------------------- profiling --

def test_speed_of_light_matches_jax():
    for flops, nbytes in ((1e9, 1e6), (1e6, 1e9), (0.0, 0.0)):
        peaks = dict(peak_flops=pprofiling.PEAK_OPS_PER_S["bfloat16"],
                     peak_bw=pprofiling.HBM_BYTES_PER_S)
        want = jprofiling.speed_of_light(flops, nbytes, **peaks)
        assert pprofiling.speed_of_light(flops, nbytes, **peaks) == want
        # The port's defaults are the H100's peaks.
        assert pprofiling.speed_of_light(flops, nbytes) == want
    assert pprofiling.HBM_BYTES_PER_S == 3.35e12
    assert pprofiling.PEAK_OPS_PER_S == {"bfloat16": 989e12,
                                         "float32": 67e12}


def test_benchmark_trace_and_memory_on_cpu(tmp_path):
    a = torch.rand(64, 64)
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x @ x], "n": 3}

    res = pprofiling.benchmark(fn, a, iters=5, warmup=2)
    assert len(calls) == 7 and set(res) == {"mean_s", "per_s"}
    assert res["mean_s"] > 0 and res["per_s"] == pytest.approx(
        1 / res["mean_s"])
    with pprofiling.trace(str(tmp_path / "t")) as prof:
        torch.mm(a, a)
    assert any(e.name == "aten::mm" for e in prof.events())
    text = (tmp_path / "t" / "trace.json").read_text()
    assert "traceEvents" in text and "aten::mm" in text
    # No statistics for the CPU, as JAX's on a backend without them.
    assert pprofiling.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert pprofiling.device_memory_stats() == {}
