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


@pytest.mark.parametrize("l,s,masked,dtype,c,nhead", [
    (16, 24, True, "float32", 32, 4), (24, 16, True, "float32", 32, 4),
    (16, 16, False, "float32", 32, 4),
    (16, 24, True, "bfloat16", 64, 2),      # D = 32, the flagship's head
    (24, 16, True, "float32", 128, 2),      # D = 64, the fc config's head
    (24, 16, True, "bfloat16", 128, 2),
], ids=["16-24-True", "24-16-True", "16-16-False", "bf16-C64-H2",
        "f32-C128-H2", "bf16-C128-H2"])
def test_linear_encoder_reference_matches_jax(rng, l, s, masked, dtype, c,
                                              nhead):
    """The plain version, which the kernel is held to on the card, rounds
    where the Pallas kernel rounds. f32: 2e-5. bf16 (x, source and the
    encodings in bf16 on both sides): two bf16 steps of max(1, |ref|), since
    an f32 sum taken in another order can move a rounding by a step; the
    XLA twin rounds elsewhere and is compared in f32 only."""
    args = _encoder_inputs(rng, 2, l, s, c, masked)
    port_args = list(_port_encoder_args(args))
    jargs = list(_jax_encoder_args(args))
    if dtype == "bfloat16":
        for i in range(4):
            port_args[i] = port_args[i].to(torch.bfloat16)
            jargs[i] = jargs[i].astype(jnp.bfloat16)
    ref = ops.linear_encoder_attention_reference(*port_args, nhead=nhead)
    ref = ref.float().numpy()
    pallas = linear_encoder_attention_pallas(*jargs, nhead=nhead,
                                             interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32))
    if dtype == "bfloat16":
        tol = 2 * 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(ref, pallas, rtol=0, atol=tol)
        return
    xla = linear_encoder_attention_xla(*jargs, nhead=nhead)
    np.testing.assert_allclose(ref, pallas, atol=2e-5)
    np.testing.assert_allclose(ref, np.asarray(xla), atol=2e-5)


def test_bf16_weight_copy_follows_the_weight():
    """K2's bf16 path reads each weight rounded to bf16 once: the copy is
    kept while the weight is unchanged, made anew after an in-place change
    (an optimizer step, load_state_dict), and dropped with the weight; f32
    weights pass as they are."""
    import gc

    from oetr_tpu_torch.ops.linear_encoder import _ROUNDED, _weight_as

    bf16 = torch.bfloat16
    w = torch.randn(64, 64)
    first = _weight_as(w, bf16)
    assert first.dtype == bf16 and torch.equal(first, w.to(bf16))
    assert _weight_as(w, bf16) is first
    assert _weight_as(w, torch.float32) is w
    with torch.no_grad():
        w.mul_(-3.0)
    second = _weight_as(w, bf16)
    assert second is not first and torch.equal(second, w.to(bf16))

    layer = torch.nn.Linear(8, 8, bias=False)
    before = _weight_as(layer.weight, bf16)
    layer.load_state_dict({"weight": torch.full((8, 8), 0.3)})
    after = _weight_as(layer.weight, bf16)
    assert after is not before
    assert torch.equal(after, torch.full((8, 8), 0.3).to(bf16))

    key = id(w)
    del w
    gc.collect()
    assert key not in _ROUNDED


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


def test_ptxas_resources_by_kernel():
    """The build record's registers and spill bytes per kernel, parsed from
    ptxas -v as nvcc prints it."""
    log = """ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'
ptxas info    : Function properties for _Zk1
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 102 registers, used 1 barriers
ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'
ptxas info    : Function properties for _Zk2
    24 bytes stack frame, 24 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 24 bytes cumulative stack size
"""
    assert _build.ptxas_resources(["", log]) == {
        "_Zk1": {"spill_stores": 0, "spill_loads": 0, "registers": 102},
        "_Zk2": {"spill_stores": 24, "spill_loads": 8, "registers": 80}}


def test_softmax_kernels_one_design_per_dtype():
    """K5 and K6: the bf16 entry points launch the tensor-core kernels, the
    f32 ones the FP32-pipe kernels, and the FP32-pipe header takes no bf16;
    nothing chooses between designs at run time."""
    csrc = _build.SRC_DIR
    for src in ("full_attention.cu", "flash_attention.cu"):
        text = (csrc / src).read_text()
        bf16 = text.split("_attention_bf16(")[1]
        f32 = text.split("_attention_f32(")[1].split("extern")[0]
        assert "softmax_mma::launch_d" in bf16 and "softmax::" not in bf16
        assert "softmax::launch_d" in f32 and "softmax_mma" not in f32
        assert "getenv" not in text
    assert "bfloat16" not in (csrc / "softmax_attention.cuh").read_text()
    mma = (csrc / "mma_sync.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in mma


def test_mask_pointers_need_no_copy():
    """A contiguous bool mask is passed as it is; any other is made one."""
    from oetr_tpu_torch.ops.linear_encoder import _mask_ptr
    m = torch.rand(2, 5) > 0.5
    same, ptr = _mask_ptr("m", m, (2, 5), m.device)
    assert same is m and ptr == m.data_ptr()
    conv, _ = _mask_ptr("m", m.to(torch.uint8).t().contiguous().t(), (2, 5),
                        m.device)
    assert conv.dtype == torch.bool and conv.is_contiguous()
    assert torch.equal(conv, m)
    with pytest.raises(ValueError, match="expected"):
        _mask_ptr("m", m[:, :4], (2, 5), m.device)


def test_unaligned_inputs_are_copied():
    """K2 reads its inputs 16 bytes at a time: a tensor whose data does not
    start on a 16-byte boundary reaches it as an aligned copy, an aligned
    one as it is."""
    from oetr_tpu_torch.ops.linear_encoder import _aligned
    base = torch.arange(40, dtype=torch.float32)
    off = base[1:33].view(4, 8)               # starts 4 bytes in
    assert off.data_ptr() % 16 != 0
    fixed = _aligned(off)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    assert _aligned(base) is base


def test_reused_library_keeps_its_resource_report(monkeypatch, tmp_path):
    """A library built by an earlier run in the same checkout is loaded
    with its build's ptxas report, so the smoke run's build phase lists the
    fourteen bf16 kernels on mma.sync (K2's eight, K5/K6's six) whether it
    built the library or reused it; a library whose report is gone is built
    again."""
    import sys
    import types

    import chip_smoke

    names = [f"_ZN12_GLOBAL__N_121linear_encoder_kernelI13__nv_bfloat16Li{d}ELb{s}"
             "EEEvNS_6ParamsE" for d in (16, 32, 48, 64) for s in (0, 1)]
    names.append("_ZN12_GLOBAL__N_121linear_encoder_kernelIfLi32ELb1EEEvNS_6ParamsE")
    names += [f"_ZN11softmax_mma20mma_attention_kernelILi{d}ELb{f}EEEvPKv"
              for d in (16, 32, 64) for f in (0, 1)]
    names.append("_ZN7softmax16attention_kernelIfLi32ELb0EEEvPKv")
    log = "".join(
        f"ptxas info    : Compiling entry function '{n}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {80 + i} registers, used 1 barriers\n"
        for i, n in enumerate(names))

    def commands(nvcc, work, lib, srcs):
        return ([[sys.executable, "-c", f"print({log!r})"]],
                [sys.executable, "-c", f"open({str(lib)!r}, 'w').close()"])

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "build_commands", commands)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeCDLL)
    records = []
    try:
        for drop_report in (False, False, True):
            _build.load_library.cache_clear()
            if drop_report:
                next(tmp_path.glob("oetr_kernels_*.json")).unlink()
            records.append(_build.load_library()[1])
    finally:
        _build.load_library.cache_clear()
    built, reused, rebuilt = records
    assert (built["built"], reused["built"], rebuilt["built"]) == (
        True, False, True)
    assert reused["so"] == built["so"] and reused["steps_s"] == {}
    for rec in records:
        assert rec["resources"] == built["resources"]
        assert rec["ptxas"] == built["ptxas"] and len(rec["ptxas"]) == 32
        rows = chip_smoke.tensor_core_resources(rec["resources"])
        assert [r["kernel"] for r in rows] == [
            f"K2 bf16 DP={d} {side}" for d in (16, 32, 48, 64)
            for side in ("query", "source")] + [
            f"K{k} bf16 D={d}" for k in (5, 6) for d in (16, 32, 64)]
        assert rows[0] == {"kernel": "K2 bf16 DP=16 query", "spill_stores": 0,
                           "spill_loads": 0, "registers": 80}
        assert rows[8] == {"kernel": "K5 bf16 D=16", "spill_stores": 0,
                           "spill_loads": 0, "registers": 89}
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".json", ".so"]
