"""The port's attention kernels (K1, K5, K6) and OETR with full attention,
against the JAX package on the CPU.

(a) Each kernel's plain version against the Pallas kernel it ports, run in
    interpret mode as ``tests/test_pallas_kernels.py`` runs it, in float32
    and in bfloat16 (the plain versions round where the kernels round).
(b) The port's ``_attend`` on CPU tensors against JAX's ``_attend`` for the
    kernel kinds, above and below the 8-token threshold.
(c) The OETR forward with full attention: JAX's ``'full:pallas'`` against
    the port's ``'full:cuda'`` (K5), and ``'full:flash'`` against
    ``'full:flash'`` (K6), at the small width with masks and at the
    flagship width, 160x160, float32, with ``OETR_PALLAS_INTERPRET=1``.
(d) ``oetr_fc_r50_config`` (layer4, d_model 512, 8 heads of 64) with
    ``'linear:pallas'`` / ``'linear:cuda'`` at 256x256: 16 tokens, so the
    encoder reaches K2's plain twin at D = 64.
Inputs come from numpy seeds; the port's wrappers run their plain versions
on CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.config import oetr_fc_r50_config as jax_fc_config
from oetr_tpu.models import build_oetr
from oetr_tpu.models.transformer import _attend as jax_attend
from oetr_tpu.ops.pallas_attention import (flash_attention_pallas,
                                           full_attention_pallas,
                                           linear_attention_pallas)
from oetr_tpu_torch.interop import convert_flax_params
from oetr_tpu_torch.models.transformer import _attend
from oetr_tpu_torch.ops import attention_kernels as ak
from test_torch_port_oetr import TOLS, seeded_params

torch.set_num_threads(2)

# (a)/(b): float32, the two frameworks differ in summation order only
# (outputs are O(1): ~1e-7 apart). bfloat16: the same rounding points, so
# an order difference can flip one rounding by one bf16 step (2^-8
# relative) of the output's scale.
F32_ATOL = 2e-5
BF16_STEPS = 2 ** -7


def _qkv(seed, b, l, s, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.5, (b, l, h, d)).astype(dtype)
    k = rng.normal(0, 0.5, (b, s, h, d)).astype(dtype)
    v = rng.normal(0, 1.0, (b, s, h, d)).astype(dtype)
    qm = rng.random((b, l)) > 0.2
    km = rng.random((b, s)) > 0.2
    if b > 2:
        km[0] = False        # a batch row with no visible key
    return q, k, v, qm, km


def _to_torch(arrs, dtype):
    return [None if a is None else
            (torch.from_numpy(a) if a.dtype == np.bool_
             else torch.from_numpy(a).to(dtype)) for a in arrs]


def _to_jax(arrs, dtype):
    return [None if a is None else
            (jnp.asarray(a) if a.dtype == np.bool_
             else jnp.asarray(a).astype(dtype)) for a in arrs]


def _close(out, ref, dtype):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "bfloat16":
        atol = BF16_STEPS * max(1.0, float(np.abs(ref).max()))
    else:
        atol = F32_ATOL
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


MASKS = {"none": (False, False), "both": (True, True), "q_only": (True, False)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("masks", sorted(MASKS))
@pytest.mark.parametrize("kernel", ["linear", "full", "flash"])
def test_plain_version_matches_pallas(kernel, masks, dtype):
    tdt, jdt = DTYPES[dtype]
    use_q, use_k = MASKS[masks]
    # L and S off K6's 32-row query and 64-key blocks; 3 batch rows, the
    # first with every key masked when the key mask is used.
    q, k, v, qm, km = _qkv(1, 3, 75, 130, 2, 16)
    qm, km = (qm if use_q else None), (km if use_k else None)
    tq, tk, tv = _to_torch((q, k, v), tdt)
    tqm, tkm = _to_torch((qm, km), tdt)
    jq, jk, jv = _to_jax((q, k, v), jdt)
    jqm, jkm = _to_jax((qm, km), jdt)
    if kernel == "linear":
        ref = linear_attention_pallas(jq, jk, jv, jqm, jkm, interpret=True)
        out = ak.linear_attention_reference(tq, tk, tv, tqm, tkm)
    elif kernel == "full":
        ref = full_attention_pallas(jq, jk, jv, jqm, jkm, interpret=True)
        out = ak.full_attention_reference(tq, tk, tv, tqm, tkm)
    else:
        ref = flash_attention_pallas(jq, jk, jv, jqm, jkm, block_q=32,
                                     block_k=64, interpret=True)
        out = ak.flash_attention_reference(tq, tk, tv, tqm, tkm, block_k=64)
    assert out.dtype == tdt and out.shape == q.shape
    _close(out, ref, dtype)
    if kernel != "linear" and use_q and not use_k:
        # The q_mask-only quirk: masked query rows give 0.
        assert (out[torch.from_numpy(~qm)] == 0).all()


@pytest.mark.parametrize("l,s", [(40, 56), (1, 56), (40, 5)])
@pytest.mark.parametrize("kind,jax_kind", [("linear:cuda", "linear:pallas"),
                                           ("full:cuda", "full:pallas"),
                                           ("full:flash", "full:flash")])
def test_attend_matches_jax_dispatch(monkeypatch, kind, jax_kind, l, s):
    """Above 8 tokens both dispatch to the kernel (the port's plain twin,
    JAX's kernel interpreted); below, both take the plain op, which for
    full attention with only a q_mask applies no mask."""
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    q, k, v, qm, _ = _qkv(2, 2, l, s, 2, 16)
    for km in (None, np.random.default_rng(3).random((2, s)) > 0.3):
        tq, tk, tv, tqm, tkm = _to_torch((q, k, v, qm, km), torch.float32)
        jq, jk, jv, jqm, jkm = _to_jax((q, k, v, qm, km), jnp.float32)
        ref = jax_attend(jax_kind, jq, jk, jv, jqm, jkm)
        out = _attend(kind, tq, tk, tv, tqm, tkm)
        _close(out, ref, "float32")


def _forward_pair(jcfg, pcfg, hw, masked, seed):
    """(JAX outputs, port outputs) for one seeded model and image pair."""
    model = build_oetr(jcfg)
    zeros = jnp.zeros((1, hw, hw, 3), jnp.float32)
    params = seeded_params(
        jax.eval_shape(model.init, jax.random.key(0), zeros, zeros), seed=seed)
    rng = np.random.default_rng(seed + 1)
    im1 = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    im2 = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    stride = 32 if jcfg.backbone.stop_layer == "layer3" else 64
    grid = hw // stride
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
    return jout, pout


# The slice's float32 bounds (tests/test_torch_port_oetr.py), but for the
# heat map: it is a softmax over the tokens of logits that carry the
# encoder's summation-order noise (~5e-5 on the tokens here, with either
# attention), which moves its largest entries (~0.07) by up to ~3e-6.
FORWARD_TOLS = dict(TOLS, prob_map=5e-6)


def _assert_forward_close(jout, pout):
    assert set(pout) == set(jout)
    for key in sorted(jout):
        np.testing.assert_allclose(pout[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-4 if key.startswith("mem") else 0,
                                   atol=FORWARD_TOLS[key.rstrip("12")],
                                   err_msg=key)


SLICE_CASES = {
    "small": (dict(depth=18, stop_layer="layer3", last_layer=256),
              dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1),
              True),
    "flagship": ({}, {}, False),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
@pytest.mark.parametrize("kind,jax_kind", [("full:cuda", "full:pallas"),
                                           ("full:flash", "full:flash")])
def test_full_attention_forward_matches_jax(monkeypatch, case, kind, jax_kind):
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    bb, neck, masked = SLICE_CASES[case]
    jcfg = OETRConfig(backbone=BackboneConfig(fused_stem=True, **bb),
                      neck=NeckConfig(attention=jax_kind, **neck))
    pcfg = port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=True, **bb),
        neck=port.NeckConfig(attention=kind, **neck))
    counts = lambda: (ak.full_attention_cuda.launches,
                      ak.flash_attention_cuda.launches)
    before = counts()
    jout, pout = _forward_pair(jcfg, pcfg, 160, masked, seed=11)
    _assert_forward_close(jout, pout)
    # CPU tensors run the plain versions and launch nothing.
    assert counts() == before
    inner = pout["pred_bbox1"].numpy()
    assert ((inner > 0) & (inner < 160)).any()


def test_fc_config_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    jbase, pbase = jax_fc_config(), port.oetr_fc_r50_config()
    assert pbase.neck.d_model // pbase.neck.nhead == 64
    assert (pbase.backbone.stop_layer, pbase.backbone.last_layer,
            pbase.neck.d_model) == (jbase.backbone.stop_layer,
                                    jbase.backbone.last_layer,
                                    jbase.neck.d_model)
    jcfg = OETRConfig(backbone=jbase.backbone,
                      neck=NeckConfig(d_model=512, attention="linear:pallas"))
    pcfg = port.replace(pbase, neck=port.replace(pbase.neck,
                                                 attention="linear:cuda"))
    jout, pout = _forward_pair(jcfg, pcfg, 256, False, seed=13)
    assert pout["mem1"].shape == (2, 16, 512)
    _assert_forward_close(jout, pout)


def test_k1_phases_stamps_the_current_kernel():
    """Every text that k1_phases patches is in csrc/linear_attention.cu
    once, and the patched copy stamps each phase boundary once."""
    from oetr_tpu_torch import k1_phases
    src = k1_phases.stamped_source()
    for k in range(len(k1_phases.PHASES) + 1):
        assert src.count(f"STAMP({k}, clock64());") == 1, k
    assert src.count("global_ns());") == 2
    assert 'extern "C" int oetr_k1_stamps(' in src
