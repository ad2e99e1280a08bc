"""The port's ops (oetr_tpu_torch.ops) against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
plain torch version, in float32. The JAX kernels run in Pallas interpret
mode, as the JAX package's own tests run them.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.ops import attention as jax_attention
from oetr_tpu.ops.pallas_attention import (linear_encoder_attention_pallas,
                                           linear_encoder_attention_xla)
from oetr_tpu.ops.pallas_norm import (groupnorm_relu_maxpool,
                                      groupnorm_relu_maxpool_reference)
from oetr_tpu_torch import ops
from oetr_tpu_torch.ops import _build

torch.set_num_threads(2)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _encoder_inputs(rng, b, l, s, c, masked):
    x, src = _f32(rng, b, l, c), _f32(rng, b, s, c)
    xp, sp = _f32(rng, 1, l, c, scale=0.5), _f32(rng, 1, s, c, scale=0.5)
    lnq = np.stack([1 + _f32(rng, c, scale=0.1), _f32(rng, c, scale=0.1)])
    lnkv = np.stack([1 + _f32(rng, c, scale=0.1), _f32(rng, c, scale=0.1)])
    # flax kernels are [in, out]
    wq, wk, wv = (_f32(rng, c, c, scale=c ** -0.5) for _ in range(3))
    qm = rng.random((b, l)) > 0.2 if masked else None
    km = rng.random((b, s)) > 0.2 if masked else None
    return x, src, xp, sp, lnq, lnkv, wq, wk, wv, qm, km


def _port_encoder_args(args):
    x, src, xp, sp, lnq, lnkv, wq, wk, wv, qm, km = args
    mask = lambda m: None if m is None else _t(m)
    return (_t(x), _t(src), _t(xp), _t(sp), _t(lnq), _t(lnkv), _t(wq.T),
            _t(wk.T), _t(wv.T), mask(qm), mask(km))


def _jax_encoder_args(args):
    return tuple(None if a is None else jnp.asarray(a) for a in args)


@pytest.mark.parametrize("l,s,masked", [(16, 24, True), (24, 16, True),
                                        (16, 16, False)])
def test_linear_encoder_reference_matches_jax(rng, l, s, masked):
    args = _encoder_inputs(rng, 2, l, s, 32, masked)
    ref = ops.linear_encoder_attention_reference(*_port_encoder_args(args),
                                                 nhead=4).numpy()
    jargs = _jax_encoder_args(args)
    pallas = linear_encoder_attention_pallas(*jargs, nhead=4, interpret=True)
    xla = linear_encoder_attention_xla(*jargs, nhead=4)
    np.testing.assert_allclose(ref, np.asarray(pallas), atol=2e-5)
    np.testing.assert_allclose(ref, np.asarray(xla), atol=2e-5)


def test_gn_pool_reference_matches_jax(rng):
    x = _f32(rng, 2, 40, 40, 64, scale=2.0) + 0.5
    g, bt = 1 + _f32(rng, 64, scale=0.1), _f32(rng, 64, scale=0.1)
    ref = ops.groupnorm_relu_maxpool_reference(_t(x), _t(g), _t(bt)).numpy()
    pallas = groupnorm_relu_maxpool(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(bt), toh=5, interpret=True)
    jref = groupnorm_relu_maxpool_reference(jnp.asarray(x), jnp.asarray(g),
                                            jnp.asarray(bt))
    np.testing.assert_allclose(ref, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(ref, np.asarray(jref), atol=1e-5)


def test_gn_scale_shift_folds_groupnorm(rng):
    x = _t(_f32(rng, 2, 8, 6, 64))
    g, bt = _t(1 + _f32(rng, 64, scale=0.1)), _t(_f32(rng, 64, scale=0.1))
    scale, shift = ops.gn_scale_shift(x, g, bt, 32, 1e-5)
    folded = x * scale[:, None, None, :] + shift[:, None, None, :]
    gn = torch.nn.functional.group_norm(x.permute(0, 3, 1, 2), 32, g, bt,
                                        1e-5).permute(0, 2, 3, 1)
    torch.testing.assert_close(folded, gn, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["linear", "full"])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_ops_match_jax(rng, kind, masked):
    q, k, v = _f32(rng, 2, 12, 4, 8), _f32(rng, 2, 20, 4, 8), \
        _f32(rng, 2, 20, 4, 8)
    qm = rng.random((2, 12)) > 0.3 if masked else None
    km = rng.random((2, 20)) > 0.3 if masked else None
    port_fn = getattr(ops, f"{kind}_attention")
    jax_fn = getattr(jax_attention, f"{kind}_attention")
    mask = lambda m, conv: None if m is None else conv(m)
    out = port_fn(_t(q), _t(k), _t(v), mask(qm, _t), mask(km, _t)).numpy()
    ref = jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 mask(qm, jnp.asarray), mask(km, jnp.asarray))
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


def test_full_attention_masked_rows_are_zero(rng):
    q, k, v = (_t(_f32(rng, 1, 6, 2, 4)) for _ in range(3))
    km = torch.zeros(1, 6, dtype=torch.bool)
    out = ops.full_attention(q, k, v, None, km)
    assert torch.count_nonzero(out) == 0


def test_cpu_tensors_take_the_plain_versions(rng):
    """A CPU tensor reaches the plain version and launches nothing."""
    args = _port_encoder_args(_encoder_inputs(rng, 2, 16, 16, 32, True))
    before = ops.linear_encoder_attention.launches
    out = ops.linear_encoder_attention(*args, nhead=4)
    torch.testing.assert_close(
        out, ops.linear_encoder_attention_reference(*args, nhead=4),
        atol=0, rtol=0)
    assert ops.linear_encoder_attention.launches == before

    x = _t(_f32(rng, 1, 8, 8, 64))
    g, bt = torch.ones(64), torch.zeros(64)
    before = ops.groupnorm_relu_maxpool.launches
    torch.testing.assert_close(ops.groupnorm_relu_maxpool(x, g, bt),
                               ops.groupnorm_relu_maxpool_reference(x, g, bt),
                               atol=0, rtol=0)
    assert ops.groupnorm_relu_maxpool.launches == before


def test_wrappers_raise_without_a_kernel(rng):
    """No silent fallback: a device with no kernel raises, and K3 refuses
    odd sizes on every device, as the JAX kernel's assert does."""
    x = torch.empty(1, 8, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.groupnorm_relu_maxpool(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="even"):
        ops.groupnorm_relu_maxpool(torch.zeros(1, 7, 8, 64), torch.ones(64),
                                   torch.zeros(64))
    t = torch.empty(1, 16, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    ln = torch.empty(2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.linear_encoder_attention(t, t, t, t, ln, ln, w, w, w, nhead=4)


def test_build_module_imports_without_nvcc(monkeypatch):
    """Importing the loader runs no compiler; the commands it would run
    target sm_90a, compile each source on its own and link one library."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    build = importlib.reload(_build)
    srcs = build.sources()
    assert {s.name for s in srcs} == {
        "flash_attention.cu", "full_attention.cu", "gn_relu_maxpool.cu",
        "linear_attention.cu", "linear_encoder.cu", "log_sinkhorn.cu"}
    compiles, link = build.build_commands("nvcc", build.BUILD_DIR,
                                          build.BUILD_DIR / "lib.so", srcs)
    assert len(compiles) == len(srcs)
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
        assert "-fPIC" in cmd and "-O3" in cmd and "-std=c++17" in cmd
    assert "-shared" in link and link[-1].endswith("lib.so")
    assert len(build.build_key(srcs)) == 16
    for src in srcs + build.headers():
        text = src.read_text()
        assert "torch/extension.h" not in text and "#include <torch" not in text
