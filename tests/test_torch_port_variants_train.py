"""One OETR train step with the variant backbones against the JAX
package's, on the CPU, in float32: a LayerNorm backbone with the
space-to-depth stem, and the frozen BatchNorm backbone (whose statistics
AdamW moves too, as optax does: they are parameters). The step, the
params (converted with ``convert_flax_params``) and the bounds are
``test_torch_port_training.py``'s: each loss entry 1e-5 relative, the
gradient norm 1e-4, each gradient 1e-4 of max(1, |ref|), the parameters
after the step within 2·lr (1e-6 where |g| is clear of rounding).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.config import TrainConfig as JTrainConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.training import train as jt
from oetr_tpu_torch.interop import convert_flax_params
from oetr_tpu_torch.models.transformer import Dropout
from oetr_tpu_torch.training import train as ptr
from test_torch_port_training import (ADAM_BOUND, STEP_G_FLOOR, _close, _np,
                                      _train_batch)
from test_torch_port_variants import BB, NECK, variant_params

torch.set_num_threads(2)


@pytest.mark.parametrize("variant", ["ln_s2d", "bn"])
def test_train_step_variant_matches_jax(monkeypatch, variant):
    """One step of ``make_train_step`` (cycle=True, AdamW) from the same
    params and batch, dropout off on both sides, at
    test_torch_port_training.py's bounds; with 'bn' AdamW moves the
    frozen statistics too, as optax does (they are parameters)."""
    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    bb = dict(BB, fused_stem=True,
              **({"norm": "ln", "stem_s2d": True} if variant == "ln_s2d"
                 else {"norm": "bn"}))
    neck = dict(NECK, max_shape=(4, 4))
    jcfg = OETRConfig(backbone=BackboneConfig(**bb), neck=NeckConfig(**neck))
    pcfg = port.OETRConfig(backbone=port.BackboneConfig(**bb),
                           neck=port.NeckConfig(attention="linear:cuda",
                                                **neck))
    jmodel = build_oetr(jcfg)
    hw = 64
    zeros = jnp.zeros((1, hw, hw, 3), jnp.float32)
    params = variant_params(
        jax.eval_shape(jmodel.init, jax.random.key(0), zeros, zeros), seed=3)
    batch = _train_batch(5)
    with jax.enable_x64(False):
        tx = jt.make_optimizer(JTrainConfig(), steps_per_epoch=1)
        jparams = jax.tree.map(jnp.asarray, params)
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=tx.init(jparams))
        state, jmetrics = jt.make_train_step(jmodel, tx, cycle=True)(
            state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        jmetrics = jax.tree.map(np.asarray, jmetrics)
        jnew = jax.tree.map(np.asarray, state.params)
        jgrads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                              state.opt_state[0].mu)

    model = port.build_oetr(pcfg, device="cpu")
    model.load_state_dict(convert_flax_params(params, pcfg))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    pstate = ptr.TrainState(0, model, *ptr.make_optimizer(
        port.TrainConfig(), model.parameters(), 1))
    pstate, metrics = ptr.make_train_step(cycle=True)(
        pstate, ptr.batch_to(batch, "cpu"), None)
    for k in jmetrics:
        np.testing.assert_allclose(_np(metrics[k]), jmetrics[k], rtol=1e-5,
                                   atol=0, err_msg=k)
    ref_g = convert_flax_params(jgrads, pcfg)
    g_norm = float(ptr.global_grad_norm(model))
    j_norm = float(torch.sqrt(sum((v.double() ** 2).sum()
                                  for v in ref_g.values())))
    assert abs(g_norm - j_norm) <= 1e-4 * j_norm, (g_norm, j_norm)
    ref_p = convert_flax_params(jnew, pcfg)
    for name, p in model.named_parameters():
        rg = ref_g[name]
        _close(p.grad, rg, 1e-4, name)
        diff = (p.detach() - ref_p[name]).abs()
        assert (diff <= ADAM_BOUND + 1e-6 * ref_p[name].abs()).all(), name
        firm = rg.abs() > max(STEP_G_FLOOR * rg.abs().max().item(), 1e-6)
        assert (diff[firm] <= 1e-6 * torch.clamp(
            ref_p[name].abs()[firm], min=1.0)).all(), name
