"""Gradients through the port's kernels against JAX's, on the CPU, in f32.

JAX makes K1, K5 and K6 differentiable with ``_with_xla_vjp``, K2 with its
own ``custom_vjp`` and K3 as ``groupnorm_relu_maxpool_trainable``: each
backward is the VJP of a plain function, recomputed from the saved inputs.
The port does the same with ``ops.autograd.KernelFunction``, which its
wrappers take when grad mode is on and an input requires grad; on CPU
tensors the forward is the kernel's plain version, so the backward runs
here. Each case feeds the same seeded numpy inputs and output gradient to
``jax.vjp`` through the Pallas wrapper (interpret mode) and to the port's
wrapper, and compares every input's gradient. Then one small OETR forward
and backward: JAX with ``'linear:pallas'`` and the fused stem, the port with
``'linear:cuda'`` and ``fused_stem``, on the weights that
``interop.convert_flax_params`` converts, every parameter's gradient mapped
by the same converter.

Tolerances: float32 on both sides, differing in summation order only:
1e-5 of max(1, the reference's largest |gradient|) for each op, 1e-4 for
OETR's parameter gradients (a deeper chain of such differences).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.models import build_oetr
from oetr_tpu.ops.pallas_attention import (flash_attention_pallas,
                                           full_attention_pallas,
                                           linear_attention_pallas,
                                           linear_encoder_attention_pallas)
from oetr_tpu.ops.pallas_norm import groupnorm_relu_maxpool_trainable
from oetr_tpu_torch import ops
from oetr_tpu_torch.interop import convert_flax_params
from oetr_tpu_torch.ops import autograd
from oetr_tpu_torch.ops.attention_kernels import linear_attention_cluster
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

OP_TOL = 1e-5
OETR_TOL = 1e-4


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


def _port_grads(fn, inputs, rest, g):
    """The port's output and the gradients of ``fn(*inputs, *rest)``
    against the output gradient g, for every tensor in ``inputs``."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves, *rest)
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in leaves]


def _jax_grads(fn, inputs, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return out, vjp(jnp.asarray(g))


def _qkv(seed, b, l, s, h, d, masks):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.5, (b, l, h, d)).astype(np.float32)
    k = rng.normal(0, 0.5, (b, s, h, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (b, s, h, d)).astype(np.float32)
    g = rng.normal(0, 1.0, (b, l, h, d)).astype(np.float32)
    qm = rng.random((b, l)) > 0.2 if masks in ("both", "q_only") else None
    km = rng.random((b, s)) > 0.2 if masks == "both" else None
    return q, k, v, g, qm, km


PALLAS = {
    "linear": (lambda *a: linear_attention_pallas(*a, interpret=True),
               ops.linear_attention_cuda),
    "full": (lambda *a: full_attention_pallas(*a, interpret=True),
             ops.full_attention_cuda),
    "flash": (lambda *a: flash_attention_pallas(*a, block_q=16, block_k=16,
                                                interpret=True),
              ops.flash_attention_cuda),
}


@pytest.mark.parametrize("masks", ["none", "both", "q_only"])
@pytest.mark.parametrize("kernel", sorted(PALLAS))
def test_attention_grads_match_jax(kernel, masks):
    """K1, K5, K6: dq, dk, dv against jax.vjp through the Pallas wrapper,
    whose backward is the XLA op's VJP with both masks."""
    jax_fn, port_fn = PALLAS[kernel]
    q, k, v, g, qm, km = _qkv(3, 2, 24, 40, 2, 16, masks)
    jqm = None if qm is None else jnp.asarray(qm)
    jkm = None if km is None else jnp.asarray(km)
    tqm = None if qm is None else torch.from_numpy(qm)
    tkm = None if km is None else torch.from_numpy(km)
    ref_out, ref_grads = _jax_grads(lambda a, b, c: jax_fn(a, b, c, jqm, jkm),
                                    (q, k, v), g)
    out, grads = _port_grads(port_fn, (q, k, v), (tqm, tkm), g)
    _close(out, ref_out, OP_TOL, "out")
    for name, got, ref in zip("qkv", grads, ref_grads):
        _close(got, ref, OP_TOL, f"d{name}")


@pytest.mark.parametrize("pos_batch,masked", [(1, True), (2, False)])
def test_linear_encoder_grads_match_jax(pos_batch, masked):
    """K2: the gradients of all nine inputs against JAX's custom_vjp. The
    port's weights are [out, in], flax's [in, out]; a positional encoding
    with a batch of 1 gets its gradient summed over the batch."""
    rng = np.random.default_rng(5)
    b, l, s, c, nhead = 2, 12, 20, 32, 4
    f32 = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(
        np.float32)
    x, src = f32(b, l, c), f32(b, s, c)
    xpos, spos = f32(pos_batch, l, c, scale=0.5), f32(pos_batch, s, c,
                                                      scale=0.5)
    lnq = np.stack([1 + f32(c, scale=0.1), f32(c, scale=0.1)])
    lnkv = np.stack([1 + f32(c, scale=0.1), f32(c, scale=0.1)])
    wq, wk, wv = (f32(c, c, scale=c ** -0.5) for _ in range(3))   # [in, out]
    g = f32(b, l, c)
    qm = rng.random((b, l)) > 0.2 if masked else None
    km = rng.random((b, s)) > 0.2 if masked else None
    jm = [None if m is None else jnp.asarray(m) for m in (qm, km)]
    tm = [None if m is None else torch.from_numpy(m) for m in (qm, km)]

    inputs = (x, src, xpos, spos, lnq, lnkv, wq, wk, wv)
    ref_out, ref_grads = _jax_grads(
        lambda *a: linear_encoder_attention_pallas(*a, *jm, nhead=nhead,
                                                   interpret=True),
        inputs, g)
    port_inputs = inputs[:6] + tuple(np.ascontiguousarray(w.T)
                                     for w in (wq, wk, wv))
    out, grads = _port_grads(
        lambda *a: ops.linear_encoder_attention(*a, *tm, nhead=nhead),
        port_inputs, (), g)
    _close(out, ref_out, OP_TOL, "out")
    names = ("x", "source", "x_pos", "s_pos", "lnq", "lnkv", "wq", "wk", "wv")
    for i, (name, got, ref) in enumerate(zip(names, grads, ref_grads)):
        got = got.T if i >= 6 else got
        _close(got, ref, OP_TOL, name)


@pytest.mark.parametrize("shape,groups,toh", [((2, 40, 24, 8), 4, 5),
                                              ((1, 32, 32, 64), 32, 4)])
def test_gn_pool_grads_match_jax(shape, groups, toh):
    """K3: dx, dgamma, dbeta against groupnorm_relu_maxpool_trainable,
    whose backward is the reference's VJP (flax's two-pass variance). f32:
    exact ties in a pooling window, where the two frameworks may route
    the gradient to different elements, are vanishingly rare."""
    rng = np.random.default_rng(shape[1])
    x = (2 * rng.normal(size=shape) + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    beta = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    b, h, w, c = shape
    g = rng.normal(size=(b, h // 2, w // 2, c)).astype(np.float32)
    ref_out, ref_grads = _jax_grads(
        lambda *a: groupnorm_relu_maxpool_trainable(*a, groups, 1e-5, toh),
        (x, gamma, beta), g)
    out, grads = _port_grads(
        lambda *a: ops.groupnorm_relu_maxpool(*a, num_groups=groups),
        (x, gamma, beta), (), g)
    _close(out, ref_out, OP_TOL, "out")
    for name, got, ref in zip(("x", "gamma", "beta"), grads, ref_grads):
        _close(got, ref, OP_TOL, name)


def _loss_weights(jout, seed):
    rng = np.random.default_rng(seed)
    return {key: rng.normal(size=np.shape(jout[key])).astype(np.float32)
            for key in sorted(jout)}


def test_small_oetr_grads_match_jax(monkeypatch):
    """One f32 forward and backward of the small OETR (ResNet18 to
    layer3, d_model 64, one encoder and one decoder layer, masks) with the
    kernel switches on in both: every parameter's gradient of one scalar
    that reaches every output."""
    monkeypatch.setenv("OETR_PALLAS_INTERPRET", "1")
    bb = dict(depth=18, stop_layer="layer3", last_layer=256, fused_stem=True)
    neck = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1)
    jcfg = OETRConfig(backbone=BackboneConfig(**bb),
                      neck=NeckConfig(attention="linear:pallas", **neck))
    pcfg = port.OETRConfig(backbone=port.BackboneConfig(**bb),
                           neck=port.NeckConfig(attention="linear:cuda",
                                                **neck))
    hw = 160
    model = build_oetr(jcfg)
    zeros = jnp.zeros((1, hw, hw, 3), jnp.float32)
    params = seeded_params(
        jax.eval_shape(model.init, jax.random.key(0), zeros, zeros), seed=7)
    rng = np.random.default_rng(8)
    im1, im2 = rng.uniform(0, 1, (2, 2, hw, hw, 3)).astype(np.float32)
    m1, m2 = rng.random((2, 2, hw // 32, hw // 32)) > 0.2
    jargs = [jnp.asarray(a) for a in (im1, im2, m1, m2)]
    weights = _loss_weights(
        jax.eval_shape(lambda p: model.apply(p, *jargs),
                       jax.tree.map(jnp.asarray, params)), seed=9)

    def jax_loss(p):
        out = model.apply(p, *jargs)
        return sum(jnp.mean(out[key] * weights[key]) for key in weights)

    jgrads = jax.grad(jax_loss)(jax.tree.map(jnp.asarray, params))

    pm = port.build_oetr(pcfg, device="cpu")
    pm.load_state_dict(convert_flax_params(params, pcfg))
    pout = pm(*(torch.from_numpy(a) for a in (im1, im2, m1, m2)))
    loss = sum((pout[key] * torch.from_numpy(weights[key])).mean()
               for key in weights)
    loss.backward()

    ref = convert_flax_params(jax.tree.map(np.asarray, jgrads), pcfg)
    names = [name for name, _ in pm.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in pm.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, ref[name].numpy(), OETR_TOL, name)


def test_wrappers_skip_the_function_without_grad(monkeypatch):
    """Under no_grad and inference_mode, and for inputs that need no
    gradient, no wrapper builds the autograd Function; with grad on, each
    does."""
    built = []
    real = autograd.KernelFunction.apply
    monkeypatch.setattr(autograd.KernelFunction, "apply",
                        lambda *a: built.append(a[0]) or real(*a))
    q, k, v, _, qm, km = _qkv(1, 1, 8, 8, 1, 16, "both")
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 32)).astype(
        np.float32)
    gamma, beta = np.ones(32, np.float32), np.zeros(32, np.float32)

    def run(requires_grad):
        tq, tk, tv, tx = (torch.from_numpy(a).requires_grad_(requires_grad)
                          for a in (q, k, v, x))
        for fn in (ops.linear_attention_cuda, ops.full_attention_cuda,
                   ops.flash_attention_cuda):
            fn(tq, tk, tv, torch.from_numpy(qm), torch.from_numpy(km))
        ops.groupnorm_relu_maxpool(tx, torch.from_numpy(gamma),
                                   torch.from_numpy(beta))

    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            run(True)
    run(False)
    assert built == []
    run(True)
    assert len(built) == 4


def test_sinkhorn_kernel_checks_grad_before_launch():
    """K4 has no backward: off the CPU, with grad on and an input that
    requires grad, it raises before it reaches the card (meta tensors stand
    in for CUDA ones here); under no_grad the same call goes on to the
    device checks. On CPU tensors the plain version runs, differentiable."""
    cost = torch.zeros(1, 5, 6, device="meta", requires_grad=True)
    mu, nu = torch.zeros(1, 5, device="meta"), torch.zeros(1, 6,
                                                           device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.log_sinkhorn_cuda(cost, mu, nu, 3)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device"):
        ops.log_sinkhorn_cuda(cost, mu, nu, 3)
    cpu = torch.randn(1, 5, 6, requires_grad=True)
    ops.log_sinkhorn_cuda(cpu, torch.zeros(1, 5), torch.zeros(1, 6),
                          3).sum().backward()
    assert torch.isfinite(cpu.grad).all()


# Clusters of 1, 2, 4 and 8 blocks a card holds at once, as
# cudaOccupancyMaxActiveClusters might count them.
CAPACITY = {1: 264, 2: 132, 4: 60, 8: 32}


@pytest.mark.parametrize("bh,longer,want", [
    (64, 400, 2),      # OETR's [8, 400, 8, 32]: 64 clusters of 4 overflow
    (16, 2500, 8),     # 1600x1600: 16 pairs, the largest cluster
    (40, 100, 4),      # 8 blocks would keep fewer than 16 rows each
    (512, 400, 1),     # not even single blocks fit one wave
    (4, 3, 1),         # too few rows to split
    (4, 130, 8),       # the longer side decides
])
def test_linear_attention_cluster(bh, longer, want):
    """K1's plan: the largest cluster whose clusters all run at once."""
    assert linear_attention_cluster(bh, longer, CAPACITY) == want
