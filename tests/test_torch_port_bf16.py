"""The port in bfloat16 against the JAX package in bfloat16, on the CPU.

The card runs bf16, and the two frameworks round at different places
(the JAX package's XLA ops against torch's), so bf16 cannot be held to
float32 bounds. Each case holds the port's bf16 output to twice JAX's own
bf16-vs-f32 gap on the same weights and inputs: two independent bf16
roundings of one float32 computation land about sqrt(2) of that gap apart,
so 2x leaves room for chance without letting a fault through (a broken
port path moves the port alone, not JAX's gap). Measured on these inputs
when the bounds were set (port vs JAX in bf16, against JAX's own gap):
OETR boxes 0.276 px against 0.341 px with linear attention, 0.321 against
0.567 with full attention; SuperGlue log_assignment 0.133 against 0.081.

Cases: the flagship OETR at 160x160 with its kernel switches on (JAX's
Pallas kernels interpreted, the port's plain twins), with linear attention
(K2) and full attention (K5); SuperGlue with 9 layers at k = 256;
SuperPoint at k = 256 on 128x128 images, whose keypoint sets must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu_torch.interop import convert_flax_params
from test_torch_port_oetr import seeded_params
from test_torch_port_sparse import (MASKED, _np, _smooth_images,
                                    _superglue_data, _superglue_pair,
                                    _superpoint_pair, _t, by_position)

torch.set_num_threads(2)

HW = 160
BOX_KEYS = ("pred_bbox1", "pred_bbox2", "center1", "center2")


def _box_gap(a, b):
    """Largest difference (px) over the boxes and centers."""
    return max(float(np.abs(np.asarray(a[k], np.float32)
                            - np.asarray(b[k], np.float32)).max())
               for k in BOX_KEYS)


@pytest.mark.parametrize("kind,jax_kind", [("linear:cuda", "linear:pallas"),
                                           ("full:cuda", "full:pallas")])
def test_oetr_bf16_matches_jax(monkeypatch, kind, jax_kind):
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(8)
    im1 = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    im2 = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    outs = {}
    params = None
    for dtype in ("float32", "bfloat16"):
        jcfg = OETRConfig(backbone=BackboneConfig(fused_stem=True),
                          neck=NeckConfig(attention=jax_kind), dtype=dtype)
        pcfg = port.oetr_r50_kernels_config(dtype, kind)
        model = build_oetr(jcfg)
        if params is None:
            zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
            params = seeded_params(jax.eval_shape(
                model.init, jax.random.key(0), zeros, zeros), seed=7)
        outs["jax", dtype] = model.apply(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(im1), jnp.asarray(im2))
        pm = port.build_oetr(pcfg, device="cpu")
        pm.load_state_dict(convert_flax_params(params, pcfg))
        with torch.no_grad():
            pout = pm(torch.from_numpy(im1), torch.from_numpy(im2))
        outs["port", dtype] = {k: v.numpy() for k, v in pout.items()}
    # float32 parity first (tests/test_torch_port_oetr.py's bound).
    assert _box_gap(outs["port", "float32"], outs["jax", "float32"]) < 5e-3
    jax_gap = _box_gap(outs["jax", "bfloat16"], outs["jax", "float32"])
    port_vs_jax = _box_gap(outs["port", "bfloat16"], outs["jax", "bfloat16"])
    assert 0 < jax_gap < 16.0      # bf16 moves JAX's boxes, by little
    assert port_vs_jax <= 2 * jax_gap, (port_vs_jax, jax_gap)


def _superglue_outputs(dtype_name, kwargs, k, hw, data):
    jsg, jparams, psg = _superglue_pair(kwargs, k, seed=3)
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    jsg = jsg.clone(dtype=jdt)
    jout = jsg.apply(jparams, {**{n: jnp.asarray(v) for n, v in data.items()},
                               "image_hw0": (hw, hw), "image_hw1": (hw, hw)})
    psg = port.build_superglue(device="cpu", cuda_sinkhorn=True,
                               dtype=getattr(torch, dtype_name), **kwargs)
    _, _, p32 = _superglue_pair(kwargs, k, seed=3)
    psg.load_state_dict(p32.state_dict())
    with torch.no_grad():
        pout = psg({**{n: _t(v) for n, v in data.items()},
                    "image_hw0": (hw, hw), "image_hw1": (hw, hw)})
    return np.asarray(jout["log_assignment"]), _np(pout["log_assignment"])


def test_superglue_bf16_matches_jax():
    k, hw = 256, 128
    data = _superglue_data(np.random.default_rng(42), 2, k, 256, hw)
    j32, p32 = _superglue_outputs("float32", {}, k, hw, data)
    j16, p16 = _superglue_outputs("bfloat16", {}, k, hw, data)
    masked = j32 <= MASKED
    for la in (p32, j16, p16):
        np.testing.assert_array_equal(la <= MASKED, masked)
    gap = lambda a, b: float(np.abs(a[~masked] - b[~masked]).max())
    assert gap(p32, j32) < 1e-3
    jax_gap = gap(j16, j32)
    assert 0 < jax_gap < 1.0
    assert gap(p16, j16) <= 2 * jax_gap, (gap(p16, j16), jax_gap)


def test_superpoint_bf16_matches_jax():
    k, hw = 256, 128
    jsp, jparams, psp = _superpoint_pair(256, k, hw, seed=256)
    image = _smooth_images(np.random.default_rng(5), 2, hw,
                           hw).mean(-1, keepdims=True)
    outs = {}
    for dtype_name, jdt in (("float32", jnp.float32),
                            ("bfloat16", jnp.bfloat16)):
        jout = jsp.clone(dtype=jdt).apply(jparams, jnp.asarray(image))
        pb = port.build_superpoint(device="cpu", max_keypoints=k,
                                   descriptor_dim=256,
                                   dtype=getattr(torch, dtype_name))
        pb.load_state_dict(psp.state_dict())
        with torch.no_grad():
            pout = pb(_t(image))
        outs["jax", dtype_name] = {n: np.asarray(v) for n, v in jout.items()}
        outs["port", dtype_name] = {n: _np(v) for n, v in pout.items()}

    def sets(out):
        ints = np.floor(out["keypoints"] + 0.5)
        return by_position(ints, out["scores"], out["valid"])

    for a, b in zip(sets(outs["port", "bfloat16"]),
                    sets(outs["jax", "bfloat16"])):
        assert set(a) == set(b)
        assert len(a) > k // 2
    # Scores at the shared keypoints: within twice JAX's own bf16 gap.
    def score_gap(x, y):
        return max(abs(float(xs[p]) - float(ys[p]))
                   for xs, ys in zip(sets(x), sets(y))
                   for p in xs.keys() & ys.keys())
    jax_gap = score_gap(outs["jax", "bfloat16"], outs["jax", "float32"])
    assert score_gap(outs["port", "bfloat16"],
                     outs["jax", "bfloat16"]) <= 2 * jax_gap
