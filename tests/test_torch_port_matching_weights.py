"""convert_superpoint_params / convert_superglue_params: flax trees -> the
port's state_dicts, and the trained matching checkpoint carried across.

Every flax leaf is used exactly once and every port parameter is set; a
stray, missing or misshapen leaf raises. The trained SuperPoint and
SuperGlue of ``.ckpt_matching_r5`` (restored through orbax against
templates from the JAX models, as ``bench.py``'s trained stage does:
descriptor 128, keypoint threshold 0) give the JAX keypoints and matches on
a seeded 128² pair. Converted weights are made at test time and not kept.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.models.superglue import SuperGlue as JaxSuperGlue
from oetr_tpu.models.superpoint import SuperPoint as JaxSuperPoint
from oetr_tpu.models.superpoint import SuperPointNet as JaxSuperPointNet
from oetr_tpu_torch.interop import (convert_superglue_params,
                                    convert_superpoint_params)

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / ".ckpt_matching_r5"
SG_WIDTHS = {
    "narrow": dict(descriptor_dim=32, keypoint_encoder_layers=(8, 16),
                   gnn_layers=2, nhead=2),
    "full": dict(),
}


def _zeros(shapes):
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _sg_dummy(k, d):
    return {"keypoints0": jnp.zeros((1, k, 2)),
            "keypoints1": jnp.zeros((1, k, 2)),
            "scores0": jnp.zeros((1, k)), "scores1": jnp.zeros((1, k)),
            "descriptors0": jnp.zeros((1, k, d)),
            "descriptors1": jnp.zeros((1, k, d)),
            "valid0": jnp.ones((1, k), bool), "valid1": jnp.ones((1, k), bool),
            "image_hw0": (64, 64), "image_hw1": (64, 64)}


def _sg_shapes(kwargs):
    jsg = JaxSuperGlue(**kwargs)
    return jax.eval_shape(
        lambda key: jsg.init(key, _sg_dummy(8, jsg.descriptor_dim)),
        jax.random.key(0))


@pytest.mark.parametrize("desc", [64, 256])
@pytest.mark.parametrize("under_net", [True, False])
def test_superpoint_every_leaf_used_once(desc, under_net):
    zeros = jnp.zeros((1, 32, 32, 1))
    if under_net:     # the extractor's tree: {"params": {"net": {...}}}
        shapes = jax.eval_shape(JaxSuperPoint(descriptor_dim=desc).init,
                                jax.random.key(0), zeros)
    else:             # the bare network's tree, as the checkpoint holds it
        shapes = jax.eval_shape(JaxSuperPointNet(descriptor_dim=desc).init,
                                jax.random.key(0), zeros)
    params = _zeros(shapes)
    state = convert_superpoint_params(params, descriptor_dim=desc)
    names = {n for n, _ in port.build_superpoint(
        device="meta", descriptor_dim=desc).named_parameters()}
    assert len(state) == len(jax.tree.leaves(params)) == len(names)
    assert set(state) == names
    assert state["net.conv1a.weight"].shape == (64, 1, 3, 3)
    assert state["net.convDb.weight"].shape == (desc, 256, 1, 1)
    port.build_superpoint(device="cpu", descriptor_dim=desc).load_state_dict(
        state)


@pytest.mark.parametrize("width", sorted(SG_WIDTHS))
def test_superglue_every_leaf_used_once(width):
    kwargs = SG_WIDTHS[width]
    params = _zeros(_sg_shapes(kwargs))
    params["params"]["bin_score"] = np.float32(2.5)
    state = convert_superglue_params(params, **kwargs)
    names = {n for n, _ in port.build_superglue(
        device="meta", **kwargs).named_parameters()}
    assert len(state) == len(jax.tree.leaves(params)) == len(names)
    assert set(state) == names
    assert state["bin_score"].shape == () and float(state["bin_score"]) == 2.5
    d = kwargs.get("descriptor_dim", 256)
    assert state["self_0.mlp1.weight"].shape == (2 * d, 2 * d)
    assert state["self_0.mlp1.bias"].shape == (2 * d,)
    assert state["kenc.ln0.weight"].shape == (kwargs.get(
        "keypoint_encoder_layers", (32,))[0],)
    port.build_superglue(device="cpu", **kwargs).load_state_dict(state)


def test_layouts_are_transposed(rng):
    kwargs = SG_WIDTHS["narrow"]
    params = _zeros(_sg_shapes(kwargs))
    inner = params["params"]
    inner["final_proj"]["kernel"] = rng.normal(size=(32, 32)).astype(
        np.float32)
    state = convert_superglue_params(params, **kwargs)
    np.testing.assert_array_equal(state["final_proj.weight"].numpy(),
                                  inner["final_proj"]["kernel"].T)
    sp = _zeros(jax.eval_shape(JaxSuperPointNet(descriptor_dim=64).init,
                               jax.random.key(0), jnp.zeros((1, 16, 16, 1))))
    conv = rng.normal(size=(3, 3, 64, 128)).astype(np.float32)
    sp["params"]["conv3a"]["kernel"] = conv
    state = convert_superpoint_params(sp, descriptor_dim=64)
    np.testing.assert_array_equal(state["net.conv3a.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))


def test_stray_missing_and_misshapen_leaves_raise():
    kwargs = SG_WIDTHS["narrow"]
    params = _zeros(_sg_shapes(kwargs))
    del params["params"]["bin_score"]
    with pytest.raises(KeyError, match="left unset"):
        convert_superglue_params(params, **kwargs)

    params = _zeros(_sg_shapes(kwargs))
    params["params"]["self_0"]["q"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no rule"):
        convert_superglue_params(params, **kwargs)

    params = _zeros(_sg_shapes(kwargs))
    params["params"]["self_9"] = {"q": {"kernel": np.zeros((32, 32),
                                                           np.float32)}}
    with pytest.raises(KeyError, match="does not have"):
        convert_superglue_params(params, **kwargs)

    params = _zeros(_sg_shapes(kwargs))
    with pytest.raises(ValueError, match="convDb"):
        convert_superpoint_params(
            _zeros(jax.eval_shape(JaxSuperPointNet(descriptor_dim=64).init,
                                  jax.random.key(0),
                                  jnp.zeros((1, 16, 16, 1)))),
            descriptor_dim=128)


def test_trained_checkpoint_gives_jax_keypoints_and_matches():
    import orbax.checkpoint as ocp

    from oetr_tpu.data.device_synth import make_device_generator

    k, desc, hw = 256, 128, 128
    ck = ocp.StandardCheckpointer()
    net_tmpl = jax.jit(JaxSuperPointNet(descriptor_dim=desc).init)(
        jax.random.key(0), jnp.zeros((1, 128, 128, 1)))
    sp_raw = ck.restore(str(CKPT / "superpoint"), net_tmpl)
    sp_kw = dict(max_keypoints=k, keypoint_threshold=0.0,
                 descriptor_dim=desc)
    jsp = JaxSuperPoint(**sp_kw)
    sp_params = {"params": {"net": sp_raw["params"]}}
    jsg = JaxSuperGlue(descriptor_dim=desc, pallas_sinkhorn=True)
    sg_tmpl = jax.jit(lambda key, d: jsg.init(
        key, dict(d, image_hw0=(hw, hw), image_hw1=(hw, hw))))(
            jax.random.key(2),
            {n: v for n, v in _sg_dummy(k, desc).items()
             if not n.startswith("image_hw")})
    sg_params = ck.restore(str(CKPT / "superglue"), sg_tmpl)

    batch = make_device_generator(hw, 1)(jax.random.key(3))
    gray = [np.asarray(batch[f"image{i}"], np.float32).mean(-1, keepdims=True)
            for i in (1, 2)]
    je = [jsp.apply(sp_params, jnp.asarray(g)) for g in gray]
    jdata = {"image_hw0": (hw, hw), "image_hw1": (hw, hw)}
    for i, e in enumerate(je):
        for name, key in (("keypoints", "keypoints"), ("scores", "scores"),
                          ("descriptors", "descriptors"), ("valid", "valid")):
            jdata[f"{key}{i}"] = e[name]
    jm = jsg.apply(sg_params, jdata)

    psp = port.build_superpoint(device="cpu", **sp_kw)
    psp.load_state_dict(convert_superpoint_params(
        jax.tree.map(np.asarray, sp_params), **sp_kw))
    psg = port.build_superglue(device="cpu", descriptor_dim=desc,
                               cuda_sinkhorn=True)
    psg.load_state_dict(convert_superglue_params(
        jax.tree.map(np.asarray, sg_params), descriptor_dim=desc))
    with torch.no_grad():
        pe = [psp(torch.from_numpy(g)) for g in gray]
        pdata = {"image_hw0": (hw, hw), "image_hw1": (hw, hw)}
        for i, e in enumerate(pe):
            for name in ("keypoints", "scores", "descriptors", "valid"):
                pdata[f"{name}{i}"] = e[name]
        pm = psg(pdata)

    def grid(xy):       # positions on a 1/8 px grid: the set tolerance
        return np.floor(np.asarray(xy) * 8 + 0.5)

    for i in range(2):
        jk, pk = grid(je[i]["keypoints"][0]), grid(pe[i]["keypoints"][0])
        jv, pv = np.asarray(je[i]["valid"][0]), pe[i]["valid"][0].numpy()
        assert pv.sum() > 100
        assert {tuple(p) for p in pk[pv]} == {tuple(p) for p in jk[jv]}
        np.testing.assert_allclose(
            np.sort(pe[i]["scores"][0].numpy()[pv]),
            np.sort(np.asarray(je[i]["scores"][0])[jv]), atol=1e-5)

    def match_set(e0, e1, m):
        xy0, xy1 = grid(e0["keypoints"][0]), grid(e1["keypoints"][0])
        m = np.asarray(m[0])
        return {(tuple(xy0[a]), tuple(xy1[m[a]]))
                for a in range(len(m)) if m[a] > -1}

    jset = match_set(je[0], je[1], jm["matches0"])
    pset = match_set(pe[0], pe[1], pm["matches0"])
    assert len(jset) >= 20          # trained weights: the pair does match
    assert pset == jset
