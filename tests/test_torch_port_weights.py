"""convert_flax_params: the flax param tree -> the port's state_dict.

Every flax leaf is used exactly once and every port parameter is set; a
stray, missing or misshapen leaf raises. The trained flagship checkpoint
(.ckpt_oetr_r5/params, restored through orbax against a template from
``jax.jit(model.init)``) carried over gives the JAX model's boxes.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.models.oetr import decode_boxes as jax_decode_boxes
from oetr_tpu_torch.interop import convert_flax_params

torch.set_num_threads(2)

CKPT = Path(__file__).resolve().parents[1] / ".ckpt_oetr_r5" / "params"
SMALL_BB = dict(depth=18, stop_layer="layer3", last_layer=256)
SMALL_NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1)


def _small_params(fused: bool):
    cfg = OETRConfig(backbone=BackboneConfig(fused_stem=fused, **SMALL_BB),
                     neck=NeckConfig(**SMALL_NECK))
    zeros = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(build_oetr(cfg).init, jax.random.key(0), zeros,
                            zeros)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _port_cfg(fused: bool):
    return port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=fused, **SMALL_BB),
        neck=port.NeckConfig(attention="linear:cuda" if fused else "linear",
                             **SMALL_NECK))


@pytest.mark.parametrize("fused", [False, True])
def test_every_leaf_used_once_every_parameter_set(fused):
    """Both switches share one name map: the fused modules keep the plain
    branches' parameter names."""
    params = _small_params(fused)
    cfg = _port_cfg(fused)
    state = convert_flax_params(params, cfg)
    n_leaves = len(jax.tree.leaves(params))
    names = {n for n, _ in port.build_oetr(cfg, device="meta")
             .named_parameters()}
    assert len(state) == n_leaves == len(names)
    assert set(state) == names
    assert state["backbone.Conv_0.weight"].shape == (64, 3, 7, 7)
    assert state["transformer.enc_self_0.q_proj.weight"].shape == (64, 64)
    # the converted dict loads with strict=True into the other switch too
    port.build_oetr(_port_cfg(not fused), device="cpu").load_state_dict(state)


def test_layouts_are_transposed(rng):
    params = _small_params(False)
    inner = params["params"]
    inner["tlbr_fc2"]["kernel"] = rng.normal(size=(64, 4)).astype(np.float32)
    conv = rng.normal(size=(7, 7, 3, 64)).astype(np.float32)
    inner["backbone"]["Conv_0"]["kernel"] = conv
    inner["hm_gn"]["scale"] = np.arange(64, dtype=np.float32)
    state = convert_flax_params(params, _port_cfg(False))
    np.testing.assert_array_equal(state["tlbr_fc2.weight"].numpy(),
                                  inner["tlbr_fc2"]["kernel"].T)
    np.testing.assert_array_equal(state["backbone.Conv_0.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["hm_gn.weight"].numpy(),
                                  np.arange(64, dtype=np.float32))


def test_stray_missing_and_misshapen_leaves_raise():
    cfg = _port_cfg(False)
    params = _small_params(False)
    params["params"]["backbone"]["Conv_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no rule"):
        convert_flax_params(params, cfg)

    params = _small_params(False)
    params["params"]["stray"] = {"kernel": np.zeros((4, 4), np.float32)}
    with pytest.raises(KeyError, match="does not have"):
        convert_flax_params(params, cfg)

    params = _small_params(False)
    del params["params"]["transformer"]["dec_0"]["norm3"]
    with pytest.raises(KeyError, match="left unset"):
        convert_flax_params(params, cfg)

    params = _small_params(False)
    params["params"]["query_embed1"] = np.zeros((1, 32), np.float32)
    with pytest.raises(ValueError, match="query_embed1"):
        convert_flax_params(params, cfg)


def test_trained_checkpoint_gives_jax_boxes():
    import orbax.checkpoint as ocp

    from oetr_tpu.data.device_synth import make_device_generator

    hw = 160
    model = build_oetr(OETRConfig())
    zeros = jnp.zeros((1, 64, 64, 3), jnp.float32)
    template = jax.jit(model.init)(jax.random.key(0), zeros, zeros)
    params = ocp.StandardCheckpointer().restore(str(CKPT), template)
    batch = make_device_generator(hw, 2)(jax.random.key(3))
    im1 = np.asarray(batch["image1"], np.float32)
    im2 = np.asarray(batch["image2"], np.float32)
    jout = model.apply(params, jnp.asarray(im1), jnp.asarray(im2))

    cfg = port.oetr_r50_kernels_config("float32")
    pm = port.build_oetr(cfg, device="cpu")
    pm.load_state_dict(convert_flax_params(
        jax.tree.map(np.asarray, params), cfg))
    with torch.no_grad():
        pout = pm(torch.from_numpy(im1), torch.from_numpy(im2))

    # float32 on both sides: boxes agree to ~1e-5 of the image side.
    tol_px = 0.02
    for key in ("pred_bbox1", "pred_bbox2", "center1", "center2"):
        np.testing.assert_allclose(pout[key].numpy(), np.asarray(jout[key]),
                                   rtol=0, atol=tol_px, err_msg=key)
    jh = jax_decode_boxes({k: v for k, v in jout.items()}, (hw, hw),
                          (hw, hw), source="heatmap")
    ph = port.decode_boxes(pout, (hw, hw), (hw, hw), source="heatmap")
    for a, b in zip(ph, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol_px)
