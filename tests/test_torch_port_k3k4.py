"""K4's launch plan and the CPU paths of K3 and K4, on the CPU.

``sinkhorn_plan`` decides how K4 spreads pairs over a grid of one block per
SM; it is plain Python, so its invariants are checked here: every row of
every pair is owned by exactly one block, no block asks for more shared
memory than the card has, and the rows kept in shared memory are as many as
fit. On a CPU tensor K3's and K4's wrappers run their plain versions, which
the same seeded inputs hold against the JAX package's functions. The
stamped copy of K4 that ``k4_phases`` builds on the card is made here from
the kernel's current source, so an edit that breaks its text patch fails
without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oetr_tpu.ops.pallas_norm import gn_scale_shift as jax_gn_scale_shift
from oetr_tpu.ops.pallas_sinkhorn import log_sinkhorn_pallas
from oetr_tpu_torch import k4_phases, ops
from oetr_tpu_torch.ops.sinkhorn import (SinkhornPlan, sinkhorn_plan,
                                         sinkhorn_smem_bytes)

torch.set_num_threads(2)

H100 = (132, 232448)     # SMs, opt-in shared memory a block (bytes)


def _owners(plan: SinkhornPlan, b: int, m: int) -> np.ndarray:
    """How many blocks own each row of each pair, launch by launch."""
    owned = np.zeros((b, m), np.int64)
    for first in range(0, b, plan.pairs_per_launch):
        for pair in range(first, min(b, first + plan.pairs_per_launch)):
            for block in range(plan.blocks_per_pair):
                r0 = block * plan.rows_per_block
                owned[pair, r0:min(m, r0 + plan.rows_per_block)] += 1
    return owned


@pytest.mark.parametrize("b,m,n,sms,smem", [
    (8, 2049, 2049, *H100),       # SuperGlue at k = 2048
    (3, 2049, 2049, *H100),
    (1, 3001, 3001, *H100),       # over the grid's shared memory
    (1, 4097, 4097, *H100),
    (16, 21, 13, *H100),          # small pairs, all in one launch
    (8, 1025, 1025, *H100),       # k = 1024: 4 pairs a launch
    (7, 513, 700, *H100),
    (200, 10, 10, *H100),         # more pairs than SMs
    (5, 100, 90, 7, 6000),        # few SMs, little shared memory
    (3, 131, 149, 4, 9000),
])
def test_sinkhorn_plan_covers_every_row_once(b, m, n, sms, smem):
    plan = sinkhorn_plan(b, m, n, sms, smem)
    assert (_owners(plan, b, m) == 1).all()
    assert plan.pairs_per_launch * plan.blocks_per_pair <= sms
    assert plan.launches == -(-b // plan.pairs_per_launch)
    assert 0 <= plan.resident_rows <= plan.rows_per_block
    assert plan.smem_bytes == sinkhorn_smem_bytes(n, plan.rows_per_block,
                                                  plan.resident_rows)
    assert plan.smem_bytes <= smem
    if plan.resident_rows < plan.rows_per_block:     # as many as fit
        assert plan.pairs_per_launch == 1
        assert sinkhorn_smem_bytes(n, plan.rows_per_block,
                                   plan.resident_rows + 1) > smem


def test_sinkhorn_plan_at_superglue_size():
    """One pair of 2049² a launch (16.8 MB in 132 × 227 KB), 16 rows a
    block, all in shared memory; a pair of 3001² keeps 16 of its 23."""
    plan = sinkhorn_plan(8, 2049, 2049, *H100)
    assert plan.pairs_per_launch == 1 and plan.launches == 8
    assert plan.blocks_per_pair == 132
    assert plan.rows_per_block == plan.resident_rows == 16
    big = sinkhorn_plan(1, 3001, 3001, *H100)
    assert (big.rows_per_block, big.resident_rows) == (23, 16)
    small = sinkhorn_plan(16, 21, 13, *H100)
    assert small.pairs_per_launch == 16 and small.launches == 1


def test_sinkhorn_plan_refuses_a_width_that_never_fits():
    with pytest.raises(ValueError, match="shared memory"):
        sinkhorn_plan(1, 100, 60000, *H100)


def test_sinkhorn_cpu_path_matches_jax_kernel():
    """On a CPU tensor log_sinkhorn_cuda runs the plain version (no launch),
    which agrees with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    cost = rng.normal(0, 2, (2, 13, 9)).astype(np.float32)
    mu = np.full((2, 13), -np.log(13), np.float32)
    nu = np.full((2, 9), -np.log(9), np.float32)
    before = ops.log_sinkhorn_cuda.launches
    out = ops.log_sinkhorn_cuda(torch.from_numpy(cost), torch.from_numpy(mu),
                                torch.from_numpy(nu), 20)
    assert ops.log_sinkhorn_cuda.launches == before
    torch.testing.assert_close(
        out, ops.log_sinkhorn(torch.from_numpy(cost), torch.from_numpy(mu),
                              torch.from_numpy(nu), 20), rtol=0, atol=0)
    ref = log_sinkhorn_pallas(jnp.asarray(cost), jnp.asarray(mu),
                              jnp.asarray(nu), iters=20, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("c", [32, 64, 96])
def test_gn_cpu_paths_match_jax(c):
    """On a CPU tensor K3's wrappers run the plain versions: the statistics
    agree with JAX's gn_scale_shift, and nothing is launched."""
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(2, 10, 6, c)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bt = (0.1 * rng.normal(size=c)).astype(np.float32)
    xt, gt, btt = map(torch.from_numpy, (x, g, bt))
    before = ops.groupnorm_relu_maxpool.launches
    scale, shift = ops.gn_scale_shift_cuda(xt, gt, btt, 32, 1e-5)
    out = ops.groupnorm_relu_maxpool(xt, gt, btt)
    assert ops.groupnorm_relu_maxpool.launches == before
    ref_scale, ref_shift = ops.gn_scale_shift(xt, gt, btt, 32, 1e-5)
    torch.testing.assert_close(scale, ref_scale, rtol=0, atol=0)
    torch.testing.assert_close(shift, ref_shift, rtol=0, atol=0)
    torch.testing.assert_close(
        out, ops.groupnorm_relu_maxpool_reference(xt, gt, btt), rtol=0,
        atol=0)
    j_scale, j_shift = jax_gn_scale_shift(jnp.asarray(x), jnp.asarray(g),
                                          jnp.asarray(bt), 32, 1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(shift.numpy(), np.asarray(j_shift),
                               rtol=1e-5, atol=1e-6)


def test_k4_phases_stamps_the_current_kernel():
    """Every text that k4_phases patches is in csrc/log_sinkhorn.cu once,
    and the patched copy stamps each phase once, the kernel takes the
    stamps' buffer and the launch passes it."""
    src = k4_phases.stamped_source()
    for k in range(len(k4_phases.PHASES)):
        assert src.count(f"STAMP({k});") == 1, k
    assert "int resident, long long* stamps) {" in src
    assert "(void*)&g_stamps};" in src
    assert 'extern "C" void oetr_set_stamps(void* p)' in src
