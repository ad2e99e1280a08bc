"""The port's OETR forward against the JAX OETR, on the CPU, in float32.

Both models get the same seeded numpy params (the port's through
``convert_flax_params``) and the same images. The slice's switches are on
in both: the JAX model runs the fused encoder sublayer (K2) in Pallas
interpret mode (OETR_PALLAS_INTERPRET=1) and the fused stem (K3), which
interprets on the CPU by itself; the port's wrappers take their plain
versions on CPU tensors. 160x160 images give a 5x5 token grid, so the
encoder reaches K2, and a stem that K3's row tile divides.
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

torch.set_num_threads(2)

HW = 160
# float32 end to end; the two frameworks sum in other orders, which moves
# each output by ~1e-6..1e-5 of its scale (pixels for boxes, ~1 for tlbr
# and the encoder tokens, ~1/N for the heatmap).
TOLS = {"pred_bbox": 5e-3, "center": 5e-3, "tlbr": 2e-5, "prob_map": 2e-6,
        "mem": 1e-4}

CASES = {
    "small": (dict(depth=18, stop_layer="layer3", last_layer=256),
              dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1),
              True),
    "flagship": ({}, {}, False),
}


def seeded_params(shapes, seed, shrink=("tlbr_fc2",)):
    """numpy params for a flax tree of shapes: kernels ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1²), biases ~ N(0, 0.1²), other leaves (OETR's
    queries, SuperGlue's bin_score) ~ N(0, 1). The kernels of the layers
    named in ``shrink`` are scaled by 0.1: by default the box head's last,
    so that its sigmoids stay off their flat ends, where box differences
    would vanish."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            w = rng.normal(size=s.shape) / np.sqrt(fan_in)
            if path[-2].key in shrink:
                w *= 0.1
        elif name == "scale":
            w = 1 + 0.1 * rng.normal(size=s.shape)
        elif name == "bias":
            w = 0.1 * rng.normal(size=s.shape)
        else:
            w = rng.normal(size=s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_forward_matches_jax(monkeypatch, case):
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    bb, neck, masked = CASES[case]
    jcfg = OETRConfig(backbone=BackboneConfig(fused_stem=True, **bb),
                      neck=NeckConfig(attention="linear:pallas", **neck))
    pcfg = port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=True, **bb),
        neck=port.NeckConfig(attention="linear:cuda", **neck))
    model = build_oetr(jcfg)
    zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
    params = seeded_params(
        jax.eval_shape(model.init, jax.random.key(0), zeros, zeros), seed=7)

    rng = np.random.default_rng(8)
    im1 = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    im2 = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    grid = HW // 32
    m1 = rng.random((2, grid, grid)) > 0.2 if masked else None
    m2 = rng.random((2, grid, grid)) > 0.2 if masked else None

    jp = jax.tree.map(jnp.asarray, params)
    jout = model.apply(jp, jnp.asarray(im1), jnp.asarray(im2),
                       None if m1 is None else jnp.asarray(m1),
                       None if m2 is None else jnp.asarray(m2))

    pm = port.build_oetr(pcfg, device="cpu")
    pm.load_state_dict(convert_flax_params(params, pcfg))
    with torch.no_grad():
        pout = pm(torch.from_numpy(im1), torch.from_numpy(im2),
                  None if m1 is None else torch.from_numpy(m1),
                  None if m2 is None else torch.from_numpy(m2))

    assert set(pout) == set(jout)
    for key in sorted(jout):
        tol = TOLS[key.rstrip("12")]
        np.testing.assert_allclose(pout[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-4 if key.startswith("mem") else 0,
                                   atol=tol, err_msg=key)
    # The boxes must not sit on the image border, where clamping would
    # hide a difference.
    inner = pout["pred_bbox1"].numpy()
    assert ((inner > 0) & (inner < HW)).any()
