"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA card and nvcc and skip without them. They need nothing
of the JAX test set-up in ``tests/conftest.py``; run them on the card
without it:

    python -m pytest --noconftest -q tests/test_torch_port_gpu.py

The cases reach what the flagship shapes in ``chip_smoke.py`` do not:
head widths below 32 and above (up to 64, at C = 512 and 1024), widths off
the 16-column tiles, per-batch positional encodings, no masks, single
tokens, row counts at and around K2's row tiles, S >> L and L >> S, a batch
row with every key masked, weights changed between calls, small and
non-square images; for the
attention kernels (K1, K5, K6) batches of 1 and 3, L != S, lengths off the
64-row tiles, head widths 16, 32 and 64, a batch row with every key masked,
a q_mask alone, K5's keys staged whole and in chunks (f32) and its two
passes over up to 64 key tiles, and bf16 K5 and K6 at every query and key
count in (1, 15, 16, 17, 63, 65, 400); for the Sinkhorn
kernel (K4) M != N, sizes off the 16-column merge tiles, 0 and 1
iterations, a pair with every keypoint masked, batches of 1 and 16, several
launches a call (SuperGlue's k = 2048 at 3 and 8 pairs), 16 small pairs in
one launch, a pair too large for the grid's shared memory and the same
bits on every run at N = 1500 and 2000; for K3's statistics kernels against
``gn_scale_shift``, widths off 8 pixels, C = 32, 64 and 96, C not a
multiple of 8, over 2048 channels and x at an element offset; for K1's
clusters, head widths 1 to 64 off the 16-column tiles and off 16-byte
rows, 1, 2, 4 and 8 blocks per (batch row, head) with S or L of 1, 2 or 3
(blocks with no rows), and the same bits on every run; the inputs the
kernels refuse; and the gradients: through K1, K2, K3, K5 and K6 in f32
and bf16 the same bits as plain autograd of the functions JAX
differentiates, K2's reaching its f32 weights and a positional encoding
with a batch of 1, K4 refusing a gradient, inference keeping the launch
path, and a small OETR backward with the switches on against off; the
train step with the switches on against off, a bf16 step renewing K2's
cached bf16 weights, no device -> host copy in a step, a checkpoint in
JAX's orbax layout resumed to the same bits, and ``probe_heatmap_boxes``'s
box half on such a state, every K2 and K3 call against its plain version. For the public API: D2-Net, R2D2, DISK,
ASLFeat, COTR and ContextDesc on the card against the CPU, the matchers'
tie-breaking on CUDA, the ``"SAME"`` convolution at strides 1 and 2 with
dilations 1, 2 and 4, and ``build_model`` / ``get_matches``'s helper /
``get_pose`` on the card against the CPU, and the trained SuperGlue of
``build_shipped_model`` on the card against the CPU. For the
pose path: the eigh kernel against LAPACK (8-point normal matrices, 3x3
Gram matrices, n = 1 and 16, batch dimensions, zero and repeated
eigenvalues, the lower triangle, NaN and what it refuses), each n from 1
to 16 at batches 1, 7, 65 and 4096 and the path's own shapes against
LAPACK and its plain twin (``eigh_jacobi_reference``), the
3x3 SVD built on it, estimate_pose and validation_error on the card
against the CPU on the card's draws, the host syncs of a call (none with
the 5-point stage off), float64 refused on the card, and the float32
refinement returning its input. For the matching trainers (SuperPoint's
joint step with HA labels, SuperGlue, LoFTR with the fine loss,
ContextDesc, the FCOS head): one step on the card against the CPU, no
device -> host copy in a step, and the HA labeler on the card against the
CPU on the same draws. For the OETR variants (frozen BatchNorm, LayerNorm,
the space-to-depth stem with the fused GroupNorm stem): every K2 and K3
call of a forward against its plain version, the BatchNorm model on the
card against the CPU, and the profiling utilities on the card. For the
parallel layer: NCCL at one rank, DDP and FSDP2 (K2's cached bf16 weights
following FSDP's gathers) against one process at 160² under cuDNN's
deterministic algorithms and at 64² under its defaults, ring attention.
For the demo programs: one step of each train phase (train_demo's OETR
with K2 and K3, train_matching_demo's SuperPoint and SuperGlue,
train_loftr_demo's LoFTR) on the card against the CPU. For the all-trained
path (the committed OETR, SuperPoint and SuperGlue at 256²): every K2 and
K3 call of the trained OETR in bf16 against its plain version, the f32
OETR on the card against the CPU, and stage 5 with every switch on
against off.
"""
import json

import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu_torch import ops
from oetr_tpu_torch.ops.sinkhorn import (augment_scores, device_limits,
                                         sinkhorn_plan)

pytestmark = pytest.mark.gpu
# The losses at one NCCL rank against one process at 64² under cuDNN's
# defaults, relative: DDP (f32) 1e-4; FSDP2 (bf16, lr 1e-2) 5e-3, three
# times the spread of the one-process run itself when only its parameters'
# storage moves to an offset, as FSDP's gathers lay it out (1.68e-3 at the
# second step: bf16 GEMMs sum in another order on other alignments and
# Adam's first step at lr 1e-2 turns that into ±lr; read by
# test_nccl_one_rank_layouts_match_local_64 under ``pytest -s``, H100,
# 700 W). Against a one-process run with its parameters so laid out,
# FSDP2 is held at 1e-4 (it was bit-equal).
NCCL_64_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(out_ref, dtype):
    """f32: the two versions differ in summation order only. bf16: they
    round at the same points, so an order difference flips a rounding by
    at most about one step (2^-7 relative) per stage."""
    scale = max(1.0, out_ref.float().abs().max().item())
    return (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4) * scale


def _encoder_args(dev, dtype, b, l, s, c, pos_batch, masked, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    pb = b if pos_batch else 1
    lnq = torch.stack([1 + 0.1 * rn(c), 0.1 * rn(c)])
    lnkv = torch.stack([1 + 0.1 * rn(c), 0.1 * rn(c)])
    ws = [rn(c, c) * c ** -0.5 for _ in range(3)]
    qm = rn(b, l) > -1.0 if masked else None
    km = rn(b, s) > -1.0 if masked else None
    if masked == "kv_row_off":     # batch row 0 sees no key: ΣK = 0
        km[0] = False
    return (rn(b, l, c).to(dtype), rn(b, s, c).to(dtype),
            (0.5 * rn(pb, l, c)).to(dtype), (0.5 * rn(pb, s, c)).to(dtype),
            lnq, lnkv, *ws, qm, km)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,s,c,nhead,pos_batch,masked", [
    (2, 5, 7, 32, 4, False, True),       # D=8, fewer rows than warps
    (3, 33, 17, 64, 2, True, False),     # D=32, per-batch pos, no masks
    (1, 1, 1, 256, 8, False, True),      # one token each side
    (2, 40, 56, 128, 8, True, True),     # D=16
    (1, 8, 8, 512, 16, False, False),    # C=512, D=32: weights in smem
    (2, 40, 33, 512, 8, True, True),     # C=512, D=64 (the fc config)
    (2, 10, 6, 96, 2, False, True),      # D=48: lanes own 2 columns
    # Row tiles (64 rows in bf16, 32 in f32): one short of, at, one past.
    (2, 63, 64, 256, 8, False, True),
    (1, 65, 129, 256, 8, True, True),
    (1, 129, 65, 128, 4, False, False),
    (2, 64, 63, 64, 2, True, True),
    (1, 8, 1000, 256, 8, False, True),   # S >> L: 16-32 source tiles a head
    (2, 1000, 3, 256, 8, False, True),   # L >> S
    (2, 40, 50, 256, 8, False, "kv_row_off"),
    (1, 100, 100, 512, 8, False, True),  # B = 1 at the fc width: 16 blocks
    (1, 40, 50, 1024, 16, True, True),   # C = 1024: the A tile in slabs
    (1, 20, 30, 96, 8, False, True),     # D = 12, padded to 16
])
def test_linear_encoder_kernel_matches_plain(cuda, dtype, b, l, s, c, nhead,
                                             pos_batch, masked):
    args = _encoder_args(cuda, dtype, b, l, s, c, pos_batch, masked, seed=l)
    before = ops.linear_encoder_attention.launches
    out = ops.linear_encoder_attention(*args, nhead=nhead)
    ref = ops.linear_encoder_attention_reference(*args, nhead=nhead)
    torch.cuda.synchronize()
    assert ops.linear_encoder_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, l, c)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_encoder_kernel_follows_weight_changes(cuda, dtype):
    """The bf16 path keeps each weight rounded once: a weight changed in
    place (as load_state_dict or an optimizer step changes it) and one with
    new storage both reach the kernel on the next call."""
    args = list(_encoder_args(cuda, dtype, 2, 40, 33, 256, False, True, 3))
    ops.linear_encoder_attention(*args, nhead=8)
    g = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        args[6].copy_(torch.randn(256, 256, generator=g, device=cuda) / 16)
    args[7] = -args[7]
    out = ops.linear_encoder_attention(*args, nhead=8)
    ref = ops.linear_encoder_attention_reference(*args, nhead=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))


def test_linear_encoder_kernel_refuses(cuda):
    wide = _encoder_args(cuda, torch.float32, 2, 8, 8, 128, False, True, 0)
    with pytest.raises(ValueError, match="C / nhead"):
        ops.linear_encoder_attention(*wide, nhead=1)       # D = 128 > 64
    args = list(_encoder_args(cuda, torch.float32, 2, 8, 8, 64, False, True,
                              seed=0))
    bad = list(args)
    bad[2] = args[2].to(torch.bfloat16)
    with pytest.raises(ValueError, match="x_pos"):
        ops.linear_encoder_attention(*bad, nhead=4)
    bad = list(args)
    bad[1] = torch.randn(2, 64, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.linear_encoder_attention(*bad, nhead=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 2, 32), (2, 6, 10, 64),
                                   (3, 8, 8, 96), (2, 34, 18, 64),
                                   (2, 22, 26, 64),     # W off 8 pixels
                                   (3, 50, 46, 96),     # C = 96, 2 runs
                                   (2, 80, 60, 32)])    # C = 32, 3 runs
def test_gn_pool_kernel_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = (torch.randn(*shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    before = ops.groupnorm_relu_maxpool.launches
    out = ops.groupnorm_relu_maxpool(x, gamma, beta)
    ref = ops.groupnorm_relu_maxpool_reference(x, gamma, beta)
    torch.cuda.synchronize()
    assert ops.groupnorm_relu_maxpool.launches == before + 1
    b, h, w, _ = shape
    assert out.shape == (b, h // 2, w // 2, c) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype) / 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 10, 64), (1, 64, 48, 64),
                                   (3, 50, 46, 96), (2, 80, 60, 32),
                                   (2, 160, 160, 64)])
def test_gn_stats_kernel_matches_plain(cuda, dtype, shape):
    """K3's statistics kernels against gn_scale_shift: float32 sums taken
    in another order, within 1e-5 of the largest |scale| and |shift|."""
    g = torch.Generator(device=cuda).manual_seed(shape[2])
    x = (torch.randn(*shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    c = shape[-1]
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    scale, shift = ops.gn_scale_shift_cuda(x, gamma, beta, 32, 1e-5)
    ref_scale, ref_shift = ops.gn_scale_shift(x, gamma, beta, 32, 1e-5)
    torch.cuda.synchronize()
    for out, ref in ((scale, ref_scale), (shift, ref_shift)):
        assert out.shape == (shape[0], c) and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,offset", [
    ((2, 6, 10, 12), 4, 0),        # C not a multiple of 8: 1 channel a thread
    ((2, 10, 6, 20), 5, 0),
    ((2, 6, 10, 64), 32, 1),       # x at an element offset, not 16-byte aligned
    ((1, 4, 6, 2080), 32, 0),      # over 256 groups of 8 channels
    ((1, 4, 6, 2088), 8, 3),       # the same at 1 channel a thread
])
def test_gn_pool_kernel_any_channels_and_offset(cuda, dtype, shape, groups,
                                                offset):
    """K3 takes any C that the groups divide, at any element offset: whole
    and the statistics alone against the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(shape[-1] + offset)
    x = (torch.randn(*shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:] = x.flatten()
        x = buf[offset:].view(shape)
    c = shape[-1]
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda)
    out = ops.groupnorm_relu_maxpool(x, gamma, beta, num_groups=groups)
    ref = ops.groupnorm_relu_maxpool_reference(x, gamma, beta, groups)
    scale, shift = ops.gn_scale_shift_cuda(x, gamma, beta, groups, 1e-5)
    ref_scale, ref_shift = ops.gn_scale_shift(x, gamma, beta, groups, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype) / 2)
    for k, r in ((scale, ref_scale), (shift, ref_shift)):
        torch.testing.assert_close(k, r, rtol=0,
                                   atol=1e-5 * r.abs().max().item())


def test_gn_pool_kernel_refuses(cuda):
    gamma, beta = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="even"):
        ops.groupnorm_relu_maxpool(torch.zeros(1, 6, 5, 64, device=cuda),
                                   gamma, beta)
    x = torch.zeros(1, 64, 6, 6, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.groupnorm_relu_maxpool(x, gamma, beta)
    with pytest.raises(ValueError, match="dtype"):
        ops.groupnorm_relu_maxpool(torch.zeros(1, 6, 6, 64, device=cuda,
                                               dtype=torch.float16),
                                   gamma, beta)


def test_small_forward_on_card_matches_cpu(cuda):
    """The whole port, small config, f32: the card (kernels) against the
    CPU (plain versions) with the same weights and images."""
    cfg = port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=True),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, attention="linear:cuda"))
    on_card = port.build_oetr(cfg, device=cuda)
    on_cpu = port.build_oetr(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    g = torch.Generator().manual_seed(0)
    im1, im2 = torch.rand(2, 2, 160, 160, 3, generator=g)
    mask = torch.rand(2, 5, 5, generator=g) > 0.2
    before = ops.linear_encoder_attention.launches
    with torch.inference_mode():
        a = on_card(im1.to(cuda), im2.to(cuda), mask.to(cuda), mask.to(cuda))
        b = on_cpu(im1, im2, mask, mask)
    assert ops.linear_encoder_attention.launches == before + 4
    for key in b:
        torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                   atol=1e-3, msg=key)


def _k4_close(out, ref):
    """K4's tolerance, as chip_smoke.py states it: unmasked entries within
    1e-4, or 16 float32 ulps of the pair's largest unmasked |entry| where
    that is more; masked entries both <= -1e8."""
    assert torch.isfinite(out).all() and torch.isfinite(ref).all()
    masked = ref <= -1e8
    assert torch.equal(out <= -1e8, masked)
    scale = torch.where(masked, 0.0, ref.abs()).amax(dim=(1, 2))
    tol = torch.clamp(16 * torch.finfo(torch.float32).eps * scale,
                      min=1e-4)[:, None, None].expand_as(ref)[~masked]
    err = (out[~masked] - ref[~masked]).abs()
    assert (err <= tol).all(), err.max().item()


def _k4_inputs(dev, b, m, n, seed, empty_pair=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn(b, m, n, generator=g, device=dev)
    mask0 = torch.rand(b, m, generator=g, device=dev) > 0.1
    mask1 = torch.rand(b, n, generator=g, device=dev) > 0.1
    if empty_pair is not None:
        mask0[empty_pair] = False
        mask1[empty_pair] = False
    return augment_scores(scores, 0.7, mask0, mask1)[:3]


@pytest.mark.parametrize("b,m,n,iters", [
    (2, 40, 56, 30),       # M != N
    (1, 33, 65, 20),       # B = 1; neither M+1 nor N+1 near a multiple of 32
    (16, 47, 31, 10),      # B = 16; N+1 = 32
    (2, 64, 64, 0),        # no iteration: C itself
    (2, 64, 64, 1),
    (3, 2048, 2048, 30),   # SuperGlue's size: 3 pairs, one launch each
    (8, 2048, 2048, 30),   # the sparse pipeline's call: 8 launches
    (16, 20, 12, 30),      # 16 small pairs packed into one launch
    (1, 3000, 3000, 30),   # over the grid's shared memory: rows from L2
])
def test_sinkhorn_kernel_matches_plain(cuda, b, m, n, iters):
    cost, mu, nu = _k4_inputs(cuda, b, m, n, seed=m + n)
    before = ops.log_sinkhorn_cuda.launches
    out = ops.log_sinkhorn_cuda(cost, mu, nu, iters)
    ref = ops.log_sinkhorn(cost, mu, nu, iters)
    torch.cuda.synchronize()
    assert ops.log_sinkhorn_cuda.launches == before + 1
    assert out.shape == cost.shape and out.dtype == torch.float32
    if iters == 0:
        assert torch.equal(out, cost)
    _k4_close(out, ref)
    plan = sinkhorn_plan(b, m + 1, n + 1, *device_limits(cuda.index or 0))
    if m == 2048:
        assert plan.pairs_per_launch == 1 < b and plan.launches == b
    if b == 16:
        assert plan.launches == 1
    if m == 3000:
        assert plan.resident_rows < plan.rows_per_block


@pytest.mark.parametrize("m", [1499, 1999])
def test_sinkhorn_kernel_same_bits_every_run(cuda, m):
    """No result depends on timing: at N = 1500 and 2000 the last threads of
    the column pass take their own column twice, and three calls give the
    same bits."""
    cost, mu, nu = _k4_inputs(cuda, 2, m, m, seed=m)
    outs = [ops.log_sinkhorn_cuda(cost, mu, nu, 30) for _ in range(3)]
    torch.cuda.synchronize()
    _k4_close(outs[0], ops.log_sinkhorn(cost, mu, nu, 30))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_sinkhorn_kernel_every_keypoint_masked(cuda):
    """A pair with no valid keypoint (ms = ns = 0): finite, as the plain
    version, beside pairs that have keypoints."""
    cost, mu, nu = _k4_inputs(cuda, 3, 50, 70, seed=1, empty_pair=1)
    out = ops.log_sinkhorn_cuda(cost, mu, nu, 30)
    ref = ops.log_sinkhorn(cost, mu, nu, 30)
    torch.cuda.synchronize()
    _k4_close(out, ref)
    assert (out[1, :-1, :] <= -1e8).all() and (out[1, :, :-1] <= -1e8).all()


def test_sinkhorn_kernel_refuses(cuda):
    cost, mu, nu = _k4_inputs(cuda, 2, 16, 24, seed=0)
    with pytest.raises(ValueError, match="float32"):
        ops.log_sinkhorn_cuda(cost.to(torch.bfloat16), mu, nu, 5)
    with pytest.raises(ValueError, match="contiguous"):
        ops.log_sinkhorn_cuda(cost.transpose(1, 2).contiguous()
                              .transpose(1, 2), mu, nu, 5)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.log_sinkhorn_cuda(cost, mu.cpu(), nu, 5)
    with pytest.raises(ValueError, match="do not fit"):
        ops.log_sinkhorn_cuda(cost, nu, mu, 5)


# ------------------------------------------------- K1, K5, K6 (attention) --

ATTENTION = {"linear": (ops.linear_attention_cuda,
                        ops.linear_attention_reference),
             "full": (ops.full_attention_cuda, ops.full_attention_reference),
             "flash": (ops.flash_attention_cuda,
                       ops.flash_attention_reference)}


def _attention_args(dev, dtype, b, l, s, h, d, seed, masks):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    q, k = (0.5 * rn(b, l, h, d)).to(dtype), (0.5 * rn(b, s, h, d)).to(dtype)
    v = rn(b, s, h, d).to(dtype)
    qm = rn(b, l) > -0.8 if masks in ("both", "q_only") else None
    km = rn(b, s) > -0.8 if masks == "both" else None
    if km is not None and b > 1:
        km[1] = False          # a batch row with no visible key
    return q, k, v, qm, km


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(ATTENTION))
@pytest.mark.parametrize("b,l,s,h,d,masks", [
    (1, 8, 8, 1, 16, "none"),
    (3, 75, 130, 2, 16, "both"),        # off the 64-row tiles; an empty row
    (3, 75, 130, 2, 32, "q_only"),      # masked query rows give 0
    (2, 400, 400, 8, 32, "both"),       # OETR's 20x20 tokens
    (1, 33, 257, 4, 64, "both"),        # D = 64, S one past 4 tiles
    (2, 130, 70, 4, 64, "none"),
    (2, 2500, 2500, 2, 32, "both"),     # OETR at 1600x1600: 40 key tiles
    (1, 4096, 4096, 2, 32, "q_only"),   # 64 key tiles, K5's two passes
    (2, 400, 2500, 2, 64, "both"),      # L != S over many tiles at D = 64
])
def test_attention_kernel_matches_plain(cuda, dtype, kernel, b, l, s, h, d,
                                        masks):
    wrapper, plain = ATTENTION[kernel]
    q, k, v, qm, km = _attention_args(cuda, dtype, b, l, s, h, d, l + s,
                                      masks)
    before = wrapper.launches
    out = wrapper(q, k, v, qm, km)
    ref = plain(q, k, v, qm, km)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))
    if kernel != "linear" and qm is not None:
        assert (out[~qm] == 0).all()
    if km is not None and kernel != "linear" and b > 1:
        assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 8, 12, 24, 33, 48, 50, 64])
def test_linear_kernel_any_head_width(cuda, dtype, d):
    """K1 at head widths off the 16-column tiles and off 16-byte rows
    (element-by-element loads and stores), masks on."""
    q, k, v, qm, km = _attention_args(cuda, dtype, 3, 70, 90, 3, d, d, "both")
    out = ops.linear_attention_cuda(q, k, v, qm, km)
    ref = ops.linear_attention_reference(q, k, v, qm, km)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("l,s", [(1, 1), (2, 3), (3, 2), (1, 400), (400, 1),
                                 (3, 130), (130, 3)])
def test_linear_kernel_rows_short_of_the_cluster(cuda, dtype, cluster, l, s):
    """K1 with as many blocks per (batch row, head) as asked: S and L
    below the cluster size leave blocks with no key rows or no query rows;
    S = 1 and L = 1; batch row 1 with every key masked."""
    from oetr_tpu_torch.ops.attention_kernels import _linear_launch
    q, k, v, qm, km = _attention_args(cuda, dtype, 2, l, s, 2, 32, l + s,
                                      "both")
    out = _linear_launch(q, k, v, qm, km, 1e-6, cluster)
    ref = ops.linear_attention_reference(q, k, v, qm, km)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))
    assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 400, 400, 8, 32), (2, 2500, 2500, 8, 32),
                                   (3, 90, 700, 2, 64)])
def test_linear_kernel_same_bits_every_run(cuda, dtype, shape):
    """The partials are summed in rank order, no atomics: three calls give
    the same bits."""
    b, l, s, h, d = shape
    q, k, v, qm, km = _attention_args(cuda, dtype, b, l, s, h, d, s, "both")
    outs = [ops.linear_attention_cuda(q, k, v, qm, km) for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


# Query and key counts around the 16-row mma tiles and the 64-row tiles.
TILE_EDGES = (1, 15, 16, 17, 63, 65, 400)


@pytest.mark.parametrize("kernel", ["full", "flash"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", TILE_EDGES)
@pytest.mark.parametrize("l", TILE_EDGES)
def test_softmax_kernel_tile_edges_bf16(cuda, kernel, d, s, l):
    """bf16 K5 and K6 (tensor-core tiles) at query and key counts on and
    around the 16-row mma tiles and the 64-row query and key tiles; masks on
    every other case, batch row 1 then with no visible key."""
    wrapper, plain = ATTENTION[kernel]
    masks = "both" if (l + s) % 2 else "none"
    q, k, v, qm, km = _attention_args(cuda, torch.bfloat16, 2, l, s, 2, d,
                                      l * 7 + s, masks)
    out = wrapper(q, k, v, qm, km)
    ref = plain(q, k, v, qm, km)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, torch.bfloat16))
    if masks == "both":
        assert (out[~qm] == 0).all() and (out[1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [200, 700, 1500, 2500, 4096])
def test_full_attention_kernel_staged_in_chunks(cuda, dtype, s):
    """K5 walks the keys twice. In f32 it stages every key row at once
    where they fit its 96 KB budget (320 rows at D = 32) and chunk by chunk
    in both passes where they do not: S = 200 is staged whole, 700 to 4096
    in 3 to 13 chunks. In bf16 it streams 64-key tiles through a ring in
    both passes: 4 to 64 tiles a pass."""
    q, k, v, qm, km = _attention_args(cuda, dtype, 2, 70, s, 2, 32, s, "both")
    out = ops.full_attention_cuda(q, k, v, qm, km)
    ref = ops.full_attention_reference(q, k, v, qm, km)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_tol(ref, dtype))


def test_attention_kernels_refuse(cuda):
    q, k, v, qm, km = _attention_args(cuda, torch.float32, 2, 16, 24, 2, 32,
                                      0, "both")
    for kernel, (wrapper, _) in sorted(ATTENTION.items()):
        with pytest.raises(ValueError, match="dtype"):
            wrapper(q.half(), k.half(), v.half(), qm, km)
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
        with pytest.raises(ValueError, match="one CUDA device"):
            wrapper(q, k.cpu(), v)
        with pytest.raises(ValueError, match="kv_mask"):
            wrapper(q, k, v, qm, km[:, :5])
        with pytest.raises(ValueError, match="v:"):
            wrapper(q, k, v[:, :5].contiguous(), qm, km)
    wide = torch.zeros(1, 8, 1, 128, device=cuda)
    for wrapper, _ in ATTENTION.values():
        with pytest.raises(ValueError, match="head width"):
            wrapper(wide, wide, wide)
    d24 = torch.zeros(1, 8, 1, 24, device=cuda)
    for wrapper in (ops.full_attention_cuda, ops.flash_attention_cuda):
        with pytest.raises(ValueError, match="head width"):
            wrapper(d24, d24, d24)


@pytest.mark.parametrize("kind", ["linear:cuda", "full:cuda", "full:flash"])
def test_attend_launches_kernels(cuda, kind):
    """_attend on the card launches the kind's kernel from 8 tokens on and
    takes the plain op below (the decoder's single query)."""
    from oetr_tpu_torch.models.transformer import KERNEL_KINDS, _attend
    wrapper, plain = KERNEL_KINDS[kind]
    q, k, v, qm, km = _attention_args(cuda, torch.float32, 2, 40, 24, 2, 32,
                                      7, "both")
    before = wrapper.launches
    out = _attend(kind, q, k, v, qm, km)
    assert wrapper.launches == before + 1
    single = _attend(kind, q[:, :1].contiguous(), k, v, None, km)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(single, plain(q[:, :1], k, v, None, km))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["full:cuda", "full:flash"])
def test_small_full_attention_forward_on_card_matches_cpu(cuda, kind):
    """The small config with full attention, f32: the card (K3 and K5 or
    K6) against the CPU (plain versions), same weights and images."""
    cfg = port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=True),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, attention=kind))
    on_card = port.build_oetr(cfg, device=cuda)
    on_cpu = port.build_oetr(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            on_card.state_dict().items()})
    g = torch.Generator().manual_seed(0)
    im1, im2 = torch.rand(2, 2, 256, 256, 3, generator=g)
    mask = torch.rand(2, 8, 8, generator=g) > 0.2
    wrapper = (ops.full_attention_cuda if kind == "full:cuda"
               else ops.flash_attention_cuda)
    before = wrapper.launches
    with torch.inference_mode():
        a = on_card(im1.to(cuda), im2.to(cuda), mask.to(cuda), mask.to(cuda))
        b = on_cpu(im1, im2, mask, mask)
    assert wrapper.launches == before + 4
    for key in b:
        torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                   atol=1e-3, msg=key)


# --------------------------------------------------------- gradients --
#
# On the card the kernels' gradients are torch autograd of the plain
# functions JAX differentiates, recomputed from the saved inputs: the same
# function of the same inputs as plain autograd, so the same bits.

GRAD_PLAIN = {"linear": ops.linear_attention, "full": ops.full_attention,
              "flash": ops.full_attention}


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


def _all_true(mask, b, n, dev):
    return (torch.ones(b, n, dtype=torch.bool, device=dev) if mask is None
            else mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", sorted(ATTENTION))
@pytest.mark.parametrize("masks", ["none", "both", "q_only"])
def test_attention_kernel_grads_equal_plain_autograd(cuda, dtype, kernel,
                                                     masks):
    wrapper, _ = ATTENTION[kernel]
    b, l, s, h, d = 3, 75, 130, 2, 32
    q, k, v, qm, km = _attention_args(cuda, dtype, b, l, s, h, d, 5, masks)
    g = torch.randn(b, l, h, d, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    g = g.to(dtype)
    before = wrapper.launches
    kq, kk, kv_ = _leaves(q, k, v)
    wrapper(kq, kk, kv_, qm, km).backward(g)
    assert wrapper.launches == before + 1
    pq, pk, pv = _leaves(q, k, v)
    GRAD_PLAIN[kernel](pq, pk, pv, _all_true(qm, b, l, cuda),
                       _all_true(km, b, s, cuda)).backward(g)
    for a, r in ((kq, pq), (kk, pk), (kv_, pv)):
        assert a.grad.dtype == dtype and torch.isfinite(a.grad).all()
        assert torch.equal(a.grad, r.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos_batch", [False, True])
def test_linear_encoder_kernel_grads_equal_plain_autograd(cuda, dtype,
                                                          pos_batch):
    """K2's gradients reach x, source, both positional encodings (summed
    back to a batch of 1), the LayerNorm parameters and the f32 weights,
    not the bf16 copies the kernel reads."""
    args = _encoder_args(cuda, dtype, 2, 40, 56, 128, pos_batch, True, 9)
    up = torch.randn(2, 40, 128, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1))
    grads = {}
    for name, fn in (("kernel", ops.linear_encoder_attention),
                     ("plain", ops.linear_encoder_attention_op)):
        leaves = _leaves(*args[:9])
        fn(*leaves, *args[9:], nhead=8).backward(up.to(dtype))
        grads[name] = [t.grad for t in leaves]
    for i, (a, r) in enumerate(zip(grads["kernel"], grads["plain"])):
        assert a.shape == args[i].shape and a.dtype == args[i].dtype, i
        assert torch.isfinite(a).all() and torch.equal(a, r), i
    assert grads["kernel"][6].dtype == torch.float32     # wq
    assert grads["kernel"][2].shape[0] == (2 if pos_batch else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_pool_kernel_grads_equal_plain_autograd(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(2, 34, 18, 64, generator=g, device=cuda) * 2
         + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(64, generator=g, device=cuda)
    beta = 0.1 * torch.randn(64, generator=g, device=cuda)
    up = torch.randn(2, 17, 9, 64, generator=g, device=cuda).to(dtype)
    grads = {}
    for name, fn in (("kernel", ops.groupnorm_relu_maxpool),
                     ("plain", ops.groupnorm_relu_maxpool_reference)):
        leaves = _leaves(x, gamma, beta)
        fn(*leaves).backward(up)
        grads[name] = [t.grad for t in leaves]
    for a, r in zip(grads["kernel"], grads["plain"]):
        assert torch.isfinite(a).all() and torch.equal(a, r)


def test_sinkhorn_kernel_refuses_grad(cuda):
    """K4 has no backward (JAX's has none): under grad it raises; under
    no_grad it runs."""
    cost, mu, nu = _k4_inputs(cuda, 2, 16, 24, seed=0)
    leaf = cost.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.log_sinkhorn_cuda(leaf, mu, nu, 5)
    with torch.no_grad():
        _k4_close(ops.log_sinkhorn_cuda(leaf, mu, nu, 5),
                  ops.log_sinkhorn(cost, mu, nu, 5))


def test_inference_keeps_the_launch_path(cuda, monkeypatch):
    """Under no_grad or inference_mode the wrappers launch as before,
    without the autograd Function."""
    from oetr_tpu_torch.ops import autograd

    def refuse(*args):
        raise AssertionError("KernelFunction built under no_grad")

    monkeypatch.setattr(autograd.KernelFunction, "apply", refuse)
    q, k, v, qm, km = _attention_args(cuda, torch.bfloat16, 2, 40, 24, 2, 32,
                                      1, "both")
    q.requires_grad_()
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            for wrapper, _ in ATTENTION.values():
                before = wrapper.launches
                wrapper(q, k, v, qm, km)
                assert wrapper.launches == before + 1


def _oetr_loss(out, seed):
    """A scalar that reaches every output: each key's mean against fixed
    random weights."""
    g = torch.Generator().manual_seed(seed)
    return sum((out[key] * torch.randn(out[key].shape, generator=g).to(
        out[key].device)).mean() for key in sorted(out))


def test_small_oetr_backward_on_card(cuda):
    """The small config in f32, switches on (K2, K3) against off, same
    weights and images: every parameter gets a gradient, and each within
    1e-4 of max(1, the largest |gradient| of that parameter)."""
    cfgs = [port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=fused),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, attention=attention))
        for fused, attention in ((True, "linear:cuda"), (False, "linear"))]
    on = port.build_oetr(cfgs[0], device=cuda)
    off = port.build_oetr(cfgs[1], device=cuda)
    off.load_state_dict(on.state_dict())
    g = torch.Generator().manual_seed(0)
    im1, im2 = (t.to(cuda) for t in torch.rand(2, 2, 160, 160, 3, generator=g))
    mask = (torch.rand(2, 5, 5, generator=g) > 0.2).to(cuda)
    before = (ops.linear_encoder_attention.launches,
              ops.groupnorm_relu_maxpool.launches)
    for model in (on, off):
        _oetr_loss(model(im1, im2, mask, mask), seed=1).backward()
    assert (ops.linear_encoder_attention.launches,
            ops.groupnorm_relu_maxpool.launches) == (before[0] + 4,
                                                     before[1] + 1)
    ref = dict(off.named_parameters())
    for name, p in on.named_parameters():
        assert p.grad is not None, name
        r = ref[name].grad
        tol = 1e-4 * max(1.0, r.abs().max().item())
        assert (p.grad - r).abs().max().item() <= tol, name


# ---------------------------------------------------------------- train --

def _small_train(cuda, kernels, dtype="float32", lr=1e-4, seed=0):
    """The small config (5 x 5 tokens at 160², so K2 runs) as a train
    state on the card, switches on or off, weights from ``seed``."""
    from oetr_tpu_torch.training import create_train_state
    cfg = port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=kernels),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1,
                             attention="linear:cuda" if kernels
                             else "linear"), dtype=dtype)
    return create_train_state(cfg, port.TrainConfig(lr=lr),
                              torch.Generator().manual_seed(seed),
                              device=cuda)


def _train_batch(cuda, b=2, seed=0):
    gen = port.make_device_generator(160, b, scale_range=(1.8, 3.2),
                                     p_translate=0.0, device=cuda)
    return gen(torch.Generator(device=cuda).manual_seed(seed))


def _train_step(**kw):
    from oetr_tpu_torch.training import make_train_step
    return make_train_step(cycle=True, **kw)


def test_train_step_kernels_on_vs_off(cuda):
    """One f32 step with every loss switch on, from the same weights,
    batch and dropout generator, K2 and K3 on against off: the same
    losses (1e-4 relative), gradient norm (1e-3 relative) and gradients
    (1e-3 of max(1, |ref|)); the kernels launched in the step."""
    from oetr_tpu_torch.training import global_grad_norm
    step = _train_step(full_cycle=True, aux_match_weight=1.0,
                       heatmap_weight=1.0, size_weight=1.0,
                       reweight_power=1.0)
    batch = _train_batch(cuda)
    runs = {}
    weights = None
    for kernels in (True, False):
        model, state = _small_train(cuda, kernels)
        if weights is None:
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        before = (ops.linear_encoder_attention.launches,
                  ops.groupnorm_relu_maxpool.launches)
        state, metrics = step(state, batch,
                              torch.Generator(device=cuda).manual_seed(3))
        launched = (ops.linear_encoder_attention.launches - before[0],
                    ops.groupnorm_relu_maxpool.launches - before[1])
        runs[kernels] = (model, metrics, global_grad_norm(model).item(),
                         launched)
    (on, m_on, n_on, l_on), (off, m_off, n_off, l_off) = runs[True], runs[
        False]
    assert l_on == (4, 1) and l_off == (0, 0)
    for k in m_off:
        assert torch.isfinite(m_on[k]), k
        assert abs(m_on[k].item() - m_off[k].item()) <= 1e-4 * max(
            abs(m_off[k].item()), 1e-6), k
    assert abs(n_on - n_off) <= 1e-3 * n_off
    ref = dict(off.named_parameters())
    for name, p in on.named_parameters():
        r = ref[name].grad
        assert (p.grad - r).abs().max().item() <= 1e-3 * max(
            1.0, r.abs().max().item()), name


def test_train_step_renews_k2_bf16_weights(cuda):
    """A bf16 step updates the weights in place (foreach AdamW), which
    moves their version counters: K2's cached bf16 copies are made anew,
    and the trained model's forward equals a fresh model's holding the
    updated weights. lr 1e-2 moves the weights by more than a bf16 step."""
    from oetr_tpu_torch.ops.linear_encoder import _weight_as
    model, state = _small_train(cuda, True, "bfloat16", lr=1e-2)
    batch = _train_batch(cuda)
    images = (batch["image1"], batch["image2"])
    model.eval()
    with torch.no_grad():
        first = model(*images)                # fills K2's cache
    state, _ = _train_step()(state, batch,
                             torch.Generator(device=cuda).manual_seed(1))
    model.eval()
    layer = model.transformer.enc_self_0
    for w in (layer.q_proj.weight, layer.k_proj.weight, layer.v_proj.weight):
        assert torch.equal(_weight_as(w, torch.bfloat16),
                           w.detach().to(torch.bfloat16))
    fresh, _ = _small_train(cuda, True, "bfloat16", seed=1)
    fresh.load_state_dict(model.state_dict())
    fresh.eval()
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False):
        with torch.no_grad():
            got, want = model(*images), fresh(*images)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not torch.equal(got["mem1"], first["mem1"])


def test_train_step_reads_nothing_back(cuda):
    """No device -> host copy in a traced step (after a warm-up)."""
    model, state = _small_train(cuda, True)
    batch = _train_batch(cuda)
    step = _train_step(full_cycle=True, aux_match_weight=1.0,
                       heatmap_weight=1.0, size_weight=1.0,
                       reweight_power=1.0)
    gen = torch.Generator(device=cuda).manual_seed(2)
    step(state, batch, gen)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    dtoh = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "DtoH" in e.name]
    assert not dtoh, dtoh


def test_train_checkpoint_resume_on_card(cuda, tmp_path):
    """Save after step 2, load into a fresh state, step 3: the same bits as
    the uninterrupted step 3 (cuDNN's deterministic algorithms)."""
    from oetr_tpu_torch.training import load_checkpoint, save_checkpoint
    batches = [_train_batch(cuda, seed=i) for i in range(3)]
    step = _train_step(heatmap_weight=1.0)
    gen = torch.Generator(device=cuda)

    def run(state, i):
        gen.manual_seed(10 + i)
        return step(state, batches[i], gen)[0]

    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False):
        _, a = _small_train(cuda, True)
        for i in range(3):
            a = run(a, i)
        _, b = _small_train(cuda, True)
        for i in range(2):
            b = run(b, i)
        save_checkpoint(str(tmp_path), b)
        _, c = _small_train(cuda, True, seed=5)
        c = run(load_checkpoint(str(tmp_path), 2, c), 2)
    assert c.step == a.step == 3
    sa, sc = a.model.state_dict(), c.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    # The state went through JAX's orbax TrainState layout.
    import chip_smoke
    layout = chip_smoke.jax_layout(str(tmp_path / "step_2"))
    assert all(layout["metadata"].values())


def test_probe_box_half_kernel_calls_match_plain(cuda, tmp_path):
    """``probe_heatmap_boxes``'s box half on the card on a state saved in
    JAX's layout: the model read back, K2 4 and K3 1 calls in its forward
    on 2 generator pairs, each against its plain version on the same
    inputs (chip_smoke.py's recorder, at the kernel checks' bounds), and
    finite mIoU rows."""
    import chip_smoke
    from oetr_tpu_torch.scripts import probe_heatmap_boxes as probe
    from oetr_tpu_torch.scripts.overlap_ab_demo import model_config
    from oetr_tpu_torch.training import create_train_state, save_checkpoint

    args = probe.parse_args(["--ckpt_dir", str(tmp_path), "--step", "0",
                             "--data_dir", str(tmp_path), "--hw", "160",
                             "--d_model", "64", "--layers", "1",
                             "--device", "cuda"])
    _, state = create_train_state(
        model_config(args, fused_stem=True, attention="linear:cuda"),
        port.TrainConfig(), torch.Generator().manual_seed(3), device=cuda)
    save_checkpoint(str(tmp_path), state)
    model = probe.load_model(args, cuda)
    for k, v in state.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    raw = _train_batch(cuda, b=2, seed=4)
    before = {k: getattr(ops, k).launches for k in
              ("linear_encoder_attention", "groupnorm_relu_maxpool")}
    with chip_smoke.recorded_kernel_calls() as calls:
        out = probe.forward(model, raw["image1"].cpu().numpy(),
                            raw["image2"].cpu().numpy())
    got = {k: getattr(ops, k).launches - n for k, n in before.items()}
    assert got == {"linear_encoder_attention": 4,
                   "groupnorm_relu_maxpool": 1}
    errs = chip_smoke.recorded_kernel_errors(torch, ops, calls, "probe")
    assert {k: v["calls"] for k, v in errs.items()} == got
    gt = [raw[k].cpu().numpy().astype("float64")
          for k in ("overlap_box1", "overlap_box2")]
    rows, best_q, _ = probe.box_rows(out, *gt, 160)
    assert best_q in probe.QS
    assert all(0.0 <= v <= 1.0 for r in rows.values() for v in r.values())


# ------------------------------------------- LoFTR, dense pipeline, scenes --

LOFTR_SMALL = dict(d_coarse=64, d_fine=32, coarse_layers=1, nhead=4,
                   match_threshold=0.0)


def _assert_same_matches(a, b, tol):
    """Each pair's valid matches as a set: the image-0 positions pair up
    within ``tol`` px, and so do their image-1 positions. (Random weights
    at threshold 0 give diffuse confidences; two rows of the top K whose
    confidences lie within a rounding of each other may swap.)"""
    assert torch.equal(a["valid"].sum(-1).cpu(), b["valid"].sum(-1).cpu())
    for i in range(a["valid"].shape[0]):
        va, vb = a["valid"][i].cpu(), b["valid"][i].cpu()
        pa, pb = a["mkpts0"][i].cpu()[va], b["mkpts0"][i].cpu()[vb]
        dist = (pa[:, None] - pb[None]).abs().amax(-1)
        assert (dist.amin(1) <= tol).all(), i
        perm = dist.argmin(1)
        assert len(set(perm.tolist())) == len(perm), i
        torch.testing.assert_close(a["mkpts1"][i].cpu()[va],
                                   b["mkpts1"][i].cpu()[vb][perm], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_small_loftr_on_card_matches_cpu(cuda, masked):
    """A small LoFTR in f32 (TF32 off), same weights and images, on the
    card and on the CPU: coarse_conf within 1e-5, the same valid matches,
    image-1 positions within 1e-3 px. It launches no kernel of the
    port."""
    on_card = port.build_loftr(device=cuda, **LOFTR_SMALL)
    on_cpu = port.build_loftr(device="cpu", **LOFTR_SMALL)
    g = torch.Generator().manual_seed(0)
    im0, im1 = torch.rand(2, 3, 96, 96, 1, generator=g)
    masks = list(torch.rand(2, 3, 12, 12, generator=g) > 0.15) \
        if masked else []
    before = {name: getattr(ops, name).launches for name in ops.__all__
              if hasattr(getattr(ops, name), "launches")}
    with torch.inference_mode():
        a = on_card(im0.to(cuda), im1.to(cuda), *[m.to(cuda) for m in masks])
        b = on_cpu(im0, im1, *masks)
    assert before == {name: getattr(ops, name).launches for name in before}
    torch.testing.assert_close(a["coarse_conf"].cpu(), b["coarse_conf"],
                               rtol=0, atol=1e-5)
    _assert_same_matches(a, b, 1e-3)
    assert 0 < int(b["valid"].sum()) < b["valid"].numel()


def test_scene_generator_on_card(cuda):
    """The generator on the card: shapes, [0, 1] on the 1/255 grid, scales
    in range, and its GT boxes the geometry path's on the CPU on the same
    tensors; the homography generator's warp is warp_gray's."""
    from oetr_tpu_torch.data.device_synth import warp_gray
    from oetr_tpu_torch.geometry import overlap_bbox_pair

    hw, b = 128, 5
    gen = port.make_device_generator(hw, b, scale_range=(1.0, 1.6),
                                     p_translate=0.5, device=cuda)
    out = gen(torch.Generator(device=cuda).manual_seed(0))
    assert out["image1"].shape == out["image2"].shape == (b, hw, hw, 3)
    assert all(v.device.type == "cuda" for v in out.values())
    for key in ("image1", "image2"):
        assert 0.0 <= out[key].min().item() and out[key].max().item() <= 1.0
    levels = out["image1"] * 255
    assert (levels - levels.round()).abs().max().item() <= 1e-3
    s = out["scale"]
    assert ((s == 1.0) | ((s >= 1.0) & (s <= 1.6))).all()
    names = ("K1", "depth1", "pose1", "crop1", "ratio1", "K2", "depth2",
             "pose2", "crop2", "ratio2")
    box1, _, box2, _, valid = overlap_bbox_pair(*(out[n].cpu()
                                                  for n in names))
    assert torch.equal(box1, out["overlap_box1"].cpu())
    assert torch.equal(box2, out["overlap_box2"].cpu())
    assert valid.all()

    im0, im1, H = port.make_homography_pair_generator(64, 3, device=cuda)(
        torch.Generator(device=cuda).manual_seed(1))
    assert im0.shape == im1.shape == (3, 64, 64, 1) and H.is_cuda
    torch.testing.assert_close(warp_gray(im0, H, 64)[0], im1, rtol=0,
                               atol=0)


def test_small_dense_pipeline_switches_on_vs_off(cuda):
    """The dense pipeline with a small OETR whose switches are on (K2, K3)
    against off, one small LoFTR, f32: boxes within 0.02 px, the same
    matches within 1e-2 px, K2 launched 4 times a call (self and cross,
    each image) and K3 once."""
    cfgs = [port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=fused),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, attention=attention))
        for fused, attention in ((True, "linear:cuda"), (False, "linear"))]
    on = port.build_oetr(cfgs[0], device=cuda)
    off = port.build_oetr(cfgs[1], device=cuda)
    off.load_state_dict(on.state_dict())
    loftr = port.build_loftr(device=cuda, **LOFTR_SMALL)
    cfg = port.PipelineConfig(canvas_hw=(128, 128), oetr_hw=(160, 160),
                              fallback_min_matches=0)
    g = torch.Generator(device=cuda).manual_seed(2)
    b = 3
    im0, im1 = torch.rand(2, b, 192, 160, 3, generator=g, device=cuda)
    o0, o1 = torch.rand(2, b, 160, 160, 3, generator=g, device=cuda)
    hw = torch.tensor([[192, 160]] * b, dtype=torch.int32, device=cuda)
    sc = torch.tensor([[1.0, 1.2]] * b, device=cuda)
    args = (im0, im1, hw, hw, o0, o1, sc, sc)
    before = (ops.linear_encoder_attention.launches,
              ops.groupnorm_relu_maxpool.launches)
    a = port.DensePipeline(loftr, oetr=on, cfg=cfg)(*args)
    assert (ops.linear_encoder_attention.launches,
            ops.groupnorm_relu_maxpool.launches) == (before[0] + 4,
                                                     before[1] + 1)
    r = port.DensePipeline(loftr, oetr=off, cfg=cfg)(*args)
    for key in ("bbox0", "bbox1"):
        torch.testing.assert_close(a[key], r[key], rtol=0, atol=0.02)
    assert torch.equal(a["used_overlap"], r["used_overlap"])
    _assert_same_matches(a, r, 1e-2)
    assert a["num_matches"].min().item() > 0


# ------------------------------------------------------------- pose ----

EIGH_TOL = 1e-5      # relative to each matrix's largest |eigenvalue|


def _normal_matrices(g, b, n_rows, dev):
    """AᵀA of 8-point constraint rows, as the pose path builds them."""
    x = torch.rand(b, n_rows, 4, generator=g, device=dev) * 1.2 - 0.6
    A = torch.stack([x[..., 2] * x[..., 0], x[..., 2] * x[..., 1],
                     x[..., 2], x[..., 3] * x[..., 0], x[..., 3] * x[..., 1],
                     x[..., 3], x[..., 0], x[..., 1],
                     torch.ones_like(x[..., 0])], -1)
    return A.transpose(-1, -2) @ A


def _check_eigh(A, w, V):
    w_ref, _ = ops.eigh_reference(A.cpu())
    w, V, A = w.cpu().double(), V.cpu().double(), A.cpu().double()
    scale = w_ref.double().abs().amax(-1, keepdim=True).clamp(min=1e-30)
    assert ((w - w_ref).abs() / scale).max() < EIGH_TOL
    res = (A @ V - V * w[..., None, :]).abs().amax(-1) / scale
    assert res.max() < EIGH_TOL
    eye = torch.eye(A.shape[-1], dtype=torch.float64)
    assert (V.transpose(-1, -2) @ V - eye).abs().max() < EIGH_TOL
    assert (w[..., 1:] >= w[..., :-1]).all()


@pytest.mark.parametrize("case", ["normal_9", "gram_3", "random_16",
                                  "batch_dims", "one"])
def test_eigh_kernel_matches_lapack(cuda, case):
    """The Jacobi kernel against LAPACK's syevd (its plain version):
    eigenvalues, residual and orthogonality within 1e-5 of each matrix's
    largest |eigenvalue|, ascending, and the null vector of the 8-point
    normal matrices with a gap where LAPACK's is."""
    g = torch.Generator(device=cuda).manual_seed(40)
    if case == "normal_9":
        A = _normal_matrices(g, 4096, 8, cuda)
    elif case == "gram_3":
        M = torch.randn(3000, 3, 3, generator=g, device=cuda)
        A = M.transpose(-1, -2) @ M
    elif case == "random_16":
        M = torch.randn(64, 16, 40, generator=g, device=cuda)
        A = M @ M.transpose(-1, -2)
    elif case == "batch_dims":
        A = _normal_matrices(g, 24, 60, cuda).reshape(2, 3, 4, 9, 9)
    else:
        A = torch.rand(5, 1, 1, generator=g, device=cuda)
    before = ops.eigh.launches
    w, V = ops.eigh(A)
    assert ops.eigh.launches == before + 1
    assert w.shape == A.shape[:-1] and V.shape == A.shape
    _check_eigh(A, w, V)
    if case == "normal_9":
        w_ref, V_ref = ops.eigh_reference(A.cpu())
        gap = (w_ref[:, 1] - w_ref[:, 0]) / w_ref[:, -1]
        dot = (V[:, :, 0].cpu() * V_ref[:, :, 0]).sum(-1).abs()
        assert dot[gap > 1e-3].min() > 1 - 1e-4


def test_eigh_kernel_edges(cuda):
    """Zero matrices, repeated eigenvalues, the lower triangle read (as
    LAPACK reads it), NaN in NaN out, and what it refuses."""
    w, V = ops.eigh(torch.zeros(3, 9, 9, device=cuda))
    assert w.abs().max() == 0
    assert torch.equal(V.cpu(), torch.eye(9).expand(3, 9, 9))
    D = torch.diag(torch.tensor([2.0, 2.0, 1e-3], device=cuda)).expand(2, 3,
                                                                       3)
    w, V = ops.eigh(D)
    _check_eigh(D, w, V)
    S = torch.randn(10, 5, 5, device=cuda)
    L = torch.tril(S) + torch.tril(S, -1).transpose(-1, -2)
    assert torch.equal(ops.eigh(S)[0], ops.eigh(L)[0])
    w, _ = ops.eigh(torch.full((2, 3, 3), float("nan"), device=cuda))
    assert torch.isnan(w).all()
    for bad in (torch.zeros(2, 9, 9, device=cuda, dtype=torch.float64),
                torch.zeros(2, 17, 17, device=cuda),
                torch.zeros(2, 3, 4, device=cuda)):
        with pytest.raises(ValueError):
            ops.eigh(bad)


def _same_vectors(w_ref, V, V_twin):
    """Each column of V against the twin's where its eigenvalue is apart
    from its neighbours by over 1e-3 of the largest |eigenvalue|: |dot| >
    1 - 1e-4 (a column of a repeated eigenvalue is one of many)."""
    w_ref = w_ref.double()
    scale = w_ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    gaps = (w_ref[..., 1:] - w_ref[..., :-1]) / scale
    inf = torch.full_like(w_ref[..., :1], float("inf"))
    apart = torch.minimum(torch.cat([inf, gaps], -1),
                          torch.cat([gaps, inf], -1)) > 1e-3
    dot = (V.cpu().double() * V_twin.double()).sum(-2).abs()
    assert (dot[apart] > 1 - 1e-4).all()


@pytest.mark.parametrize("batch", [1, 7, 65, 4096])
@pytest.mark.parametrize("n", range(1, 17))
def test_eigh_kernel_every_n(cuda, n, batch):
    """Each n from 1 to 16 (one thread a matrix to n = 3, a group of
    n + n % 2 lanes from n = 4) at batches that leave a ragged last group,
    warp and block: one launch; against LAPACK (EIGH_TOL) and against its
    plain twin (eigenvalues within EIGH_TOL, eigenvectors where apart)."""
    from oetr_tpu_torch.ops.small_eigh import eigh_jacobi_reference
    g = torch.Generator(device=cuda).manual_seed(100 + n)
    M = torch.randn(batch, n, n + 3, generator=g, device=cuda)
    A = M @ M.transpose(-1, -2)
    before = ops.eigh.launches
    w, V = ops.eigh(A)
    assert ops.eigh.launches == before + 1
    _check_eigh(A, w, V)
    w_twin, V_twin = eigh_jacobi_reference(A.cpu())
    scale = w_twin.abs().amax(-1, keepdim=True)
    assert ((w.cpu() - w_twin).abs() / scale).max() < EIGH_TOL
    _same_vectors(ops.eigh_reference(A.cpu())[0], V, V_twin)


# estimate_pose's 18 eigh calls at chip_smoke.py's pose size (8 pairs, 512
# hypotheses): the 9x9 normal matrices of round 1, the homography round, the
# LO refits and the final refits; the 3x3 Gram matrices of the SVDs.
POSE_EIGH_SHAPES = [(8, 512, 9, 9), (8, 256, 9, 9), (8, 8, 9, 9), (8, 9, 9),
                    (8, 512, 3, 3), (8, 256, 3, 3), (8, 16, 3, 3),
                    (8, 8, 3, 3), (8, 3, 3)]


@pytest.mark.parametrize("shape", POSE_EIGH_SHAPES)
def test_eigh_kernel_pose_shapes_match_twin(cuda, shape):
    """The pose path's shapes (8-point normal matrices, minimal where the
    path samples 8 rows, 60 rows for its refits; 3x3 Gram matrices): the
    kernel against LAPACK and against its twin on the card's inputs, the
    null vectors as ``test_eigh_kernel_matches_lapack`` holds them."""
    from oetr_tpu_torch.ops.small_eigh import eigh_jacobi_reference
    g = torch.Generator(device=cuda).manual_seed(len(shape) * 1000
                                                 + shape[-3])
    b = int(np.prod(shape[:-2]))
    if shape[-1] == 9:
        A = _normal_matrices(g, b, 8 if b >= 2048 else 60, cuda)
    else:
        M = torch.randn(b, 3, 3, generator=g, device=cuda)
        A = M.transpose(-1, -2) @ M
    A = A.reshape(shape)
    w, V = ops.eigh(A)
    _check_eigh(A, w, V)
    w_twin, V_twin = eigh_jacobi_reference(A.cpu())
    scale = w_twin.abs().amax(-1, keepdim=True)
    assert ((w.cpu() - w_twin).abs() / scale).max() < EIGH_TOL
    w_ref, V_ref = ops.eigh_reference(A.cpu())
    _same_vectors(w_ref, V, V_twin)
    if shape[-1] == 9:
        gap = (w_ref[..., 1] - w_ref[..., 0]) / w_ref[..., -1]
        for ref in (V_ref, V_twin):
            dot = (V[..., :, 0].cpu() * ref[..., :, 0]).sum(-1).abs()
            assert dot[gap > 1e-3].min() > 1 - 1e-4


def test_svd3_on_card_is_an_svd(cuda):
    """svd3 on the card (eigh of AᵀA through the kernel): A = U S Vh, U and
    V rotations, S² LAPACK's, and the essential projection LAPACK's. The
    eigh of AᵀA squares A's condition in float32: its eigenvalues s_i² are
    good to ~eps s_1², so s_i to ~eps s_1² / s_i, and u_i = A v_i / s_i
    carries as much; so S² is held to 1e-5 s_1² and A rebuilt to 1e-4
    s_1."""
    g = torch.Generator(device=cuda).manual_seed(42)
    A = torch.randn(500, 3, 3, generator=g, device=cuda)
    U, S, Vh = ops.svd3(A)
    err = (U @ torch.diag_embed(S) @ Vh - A).abs().amax((-1, -2))
    assert (err <= 1e-4 * S[:, 0]).all()
    eye = torch.eye(3, device=cuda).expand(500, 3, 3)
    torch.testing.assert_close(U.transpose(-1, -2) @ U, eye, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(Vh @ Vh.transpose(-1, -2), eye, rtol=0,
                               atol=1e-5)
    assert (torch.linalg.det(U) > 0).all()
    Uc, Sc, Vhc = ops.svd3(A.cpu())
    assert ((S.cpu() ** 2 - Sc ** 2).abs() <= 1e-5 * Sc[:, :1] ** 2).all()
    s110 = torch.tensor([1.0, 1.0, 0.0])
    proj = (U.cpu() * s110) @ Vh.cpu()
    torch.testing.assert_close(proj, (Uc * s110) @ Vhc, rtol=0, atol=1e-4)


def _pose_problem(b=3, n_true=200, n_slots=256, seed=43):
    from oetr_tpu_torch import profile_forward as pf
    return pf.general_pose_pairs(b, torch.Generator().manual_seed(seed),
                                 n_true=n_true, n_slots=n_slots)


def _replayed(fn, device):
    """fn() on the card with its draws recorded, then the draws."""
    from oetr_tpu_torch.geometry import draws
    real, log = draws.gumbel, {}

    def recording(stage, shape, generator):
        log[stage] = real(stage, shape, generator)
        return log[stage]
    draws.gumbel = recording
    try:
        return fn(), log
    finally:
        draws.gumbel = real


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("use_5pt", [False, True])
def test_estimate_pose_card_vs_cpu(cuda, use_5pt, planar):
    """estimate_pose on the card against the port on the CPU given the
    card's eigh and svd3 results, same inputs and draws, at the pose
    phase's sizes (3 of its pairs: 2048 slots, 1400 true correspondences,
    or the scene generator's planar pairs at 832²): each pair's errors
    within 0.25° of the CPU's, inlier counts within 1%, ``ok`` equal, no
    padded slot an inlier. Against the plain CPU (LAPACK's eigensolvers)
    ``ok`` equal, and on the general scenes card and CPU within the truth's
    bounds: without the float32 refinement the estimator's result follows
    its eigensolver's last bits, and LAPACK's own float64 routines, rounded
    to float32, move it beyond 0.25° or 1% in most cases at this size
    (``python -m oetr_tpu_torch.pose_parting --spread``). The eigh kernel
    launched."""
    from oetr_tpu_torch import profile_forward as pf
    from oetr_tpu_torch.pose_parting import run
    if planar:
        raw = pf.scene_pairs(832, 3, 44, device="cpu")
        d = pf.planar_pose_pairs(raw, torch.Generator().manual_seed(45))
    else:
        d = _pose_problem(n_true=1400, n_slots=2048)
    before = ops.eigh.launches
    card, card_log, drawn = run(d, cuda, use_5pt, 46)
    assert ops.eigh.launches > before
    given, _, _ = run(d, "cpu", use_5pt, 46, drawn, card_log)
    cpu, _, _ = run(d, "cpu", use_5pt, 46, drawn)
    et_g, eR_g = port.pose_error(d["T_0to1"], card["R"].cpu(),
                                 card["t"].cpu())
    n_g = card["num_inliers"].cpu()
    et_c, eR_c = port.pose_error(d["T_0to1"], given["R"], given["t"])
    assert (eR_g - eR_c).abs().max() < 0.25
    assert (et_g - et_c).abs().max() < 0.25
    n_c = given["num_inliers"]
    assert ((n_g - n_c).abs() <= 0.01 * n_c).all(), (n_g, n_c)
    if not planar:
        et_p, eR_p = port.pose_error(d["T_0to1"], cpu["R"], cpu["t"])
        for eR, et in ((eR_g, et_g), (eR_c, et_c), (eR_p, et_p)):
            assert eR.max() < 2.0 and et.max() < 5.0
    for ref in (given, cpu):
        assert torch.equal(card["ok"].cpu(), ref["ok"])
    assert not (card["inliers"].cpu() & ~d["valid"]).any()


@pytest.mark.parametrize("seed", [44, 46])
@pytest.mark.parametrize("use_5pt", [False, True])
def test_estimate_pose_card_vs_cpu_small(cuda, use_5pt, seed):
    """estimate_pose on the card against the port on the CPU at 200 true
    points of 256 slots, 3 pairs, on the card's draws. At this size the
    two part at the hypothesis stage: the null vectors of nearly singular
    f32 8-point normal matrices follow the eigensolver (the Jacobi kernel,
    LAPACK), so round 1's or round 2's best hypothesis or the LO
    candidates differ. ``python -m oetr_tpu_torch.pose_parting --problems
    8`` (48 pairs, H100) found that on every pair; 10 pairs then ended
    with other inlier counts, by at most 2 (1.57%), and the poses up to
    0.30° apart. With the CPU given the card's eigh and svd3 results, all
    48 inlier counts were equal and the poses within 0.028°. So the CPU
    run here takes the card's eigh and svd3 results, and the rest of the
    path is held to the pose bounds: errors within 0.25°, inlier counts
    within 1%, ``ok`` equal, no padded slot an inlier. With the CPU's own
    eigensolvers, card and CPU are each held to the ground truth (err_R <
    2°, err_t < 5°, the JAX tests' bound at 200 points)."""
    from oetr_tpu_torch.pose_parting import run
    d = _pose_problem(seed=seed)
    card, card_log, drawn = run(d, cuda, use_5pt, 46)
    cpu, _, _ = run(d, "cpu", use_5pt, 46, drawn, card_log)
    plain, _, _ = run(d, "cpu", use_5pt, 46, drawn)
    et_g, eR_g = port.pose_error(d["T_0to1"], card["R"].cpu(),
                                 card["t"].cpu())
    et_c, eR_c = port.pose_error(d["T_0to1"], cpu["R"], cpu["t"])
    assert (eR_g - eR_c).abs().max() < 0.25
    assert (et_g - et_c).abs().max() < 0.25
    et_p, eR_p = port.pose_error(d["T_0to1"], plain["R"], plain["t"])
    for eR, et in ((eR_g, et_g), (eR_p, et_p)):
        assert eR.max() < 2.0 and et.max() < 5.0
    n_g, n_c = card["num_inliers"].cpu(), cpu["num_inliers"]
    assert ((n_g - n_c).abs() <= 0.01 * n_c).all(), (n_g, n_c)
    assert torch.equal(card["ok"].cpu(), cpu["ok"])
    assert not (card["inliers"].cpu() & ~d["valid"]).any()


@pytest.mark.parametrize("use_5pt", [False, True])
def test_estimate_pose_host_syncs(cuda, use_5pt):
    """In a profiler trace of a call: no device -> host copy with the
    5-point stage off (the card's default); with it on, one (the samples,
    for all pairs)."""
    d = {k: v.to(cuda) for k, v in _pose_problem().items()}
    call = lambda: port.estimate_pose(
        d["kpts0"], d["kpts1"], d["valid"], d["K"], d["K"],
        torch.Generator(device=cuda).manual_seed(47), num_hypotheses=64,
        use_5pt=use_5pt)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    dtoh = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "DtoH" in e.name]
    assert len(dtoh) == (1 if use_5pt else 0), [e.name for e in dtoh]


def test_estimate_pose_raises_on_card_rather_than_moving(cuda):
    """On the card in float64 the eigh kernel refuses: no CPU fallback."""
    d = {k: v.to(cuda) for k, v in _pose_problem(b=1).items()}
    with pytest.raises(ValueError):
        port.estimate_pose(d["kpts0"].double(), d["kpts1"].double(),
                           d["valid"], d["K"].double(), d["K"].double(),
                           torch.Generator(device=cuda), num_hypotheses=64)


def test_validation_error_card_vs_cpu(cuda, monkeypatch):
    """validation_error with the estimator on the card against the CPU on
    the card's draws: precision, matching score and the epipolar errors
    equal; against the CPU given the card's eigh and svd3 results, pose
    errors within 0.25° too; card and plain CPU within the truth's bounds
    (the plain CPU's pose follows LAPACK's last bits, as in
    ``test_estimate_pose_card_vs_cpu``)."""
    from oetr_tpu_torch.evalx import validation_error
    from oetr_tpu_torch.geometry import draws
    from oetr_tpu_torch.pose_parting import recorded
    d = {k: v[0].numpy()
         for k, v in _pose_problem(b=1, n_slots=200).items()}
    m = np.stack([np.arange(200), np.arange(200)])
    args = (d["kpts0"], d["kpts1"], m, d["K"].astype(np.float64),
            d["K"].astype(np.float64), d["T_0to1"].astype(np.float64))
    with recorded() as card_linalg:
        card, log = _replayed(lambda: validation_error(
            *args, rng_seed=3, device="cuda"), cuda)
    monkeypatch.setattr(draws, "gumbel",
                        lambda stage, shape, g: log[stage].cpu())
    with recorded(card_linalg):
        given = validation_error(*args, rng_seed=3, device="cpu")
    cpu = validation_error(*args, rng_seed=3, device="cpu")
    for ref in (given, cpu):
        for k in ("precision", "matching_score", "num_correct"):
            assert card[k] == ref[k]
        assert np.array_equal(card["epipolar_errors"],
                              ref["epipolar_errors"])
    for k in ("error_t", "error_R"):
        assert abs(card[k] - given[k]) < 0.25, (k, card[k], given[k])
    for res in (card, cpu):
        assert res["error_R"] < 2.0 and res["error_t"] < 5.0


@pytest.mark.parametrize("where", ["card", "cpu"])
def test_refine_under_inference_mode_matches_grad_mode(cuda, where):
    """Under inference_mode forward-mode AD is off (torch 2.11 returns
    zero tangents); the refinement takes its Jacobian outside it, so a
    caller's inference_mode changes nothing, on the card or its CPU. In
    float64, where the refinement moves (float32 returns its input)."""
    from oetr_tpu_torch.geometry import ransac
    dev = cuda if where == "card" else torch.device("cpu")
    args, R0 = _refine_args(dev, torch.float64)
    R, t = ransac.refine_pose_sampson(*args)
    with torch.inference_mode():
        Ri, ti = ransac.refine_pose_sampson(*args)
    assert torch.equal(R, Ri) and torch.equal(t, ti)
    assert (R - R0).abs().max() > 1e-4


def _refine_args(dev, dtype):
    """refine_pose_sampson's arguments on a 2-pair problem, from a start
    0.2° off the truth; and that start."""
    from oetr_tpu_torch.geometry import normalize_keypoints, ransac
    d = {k: (v.to(dtype) if v.is_floating_point() else v).to(dev)
         for k, v in _pose_problem(b=2).items()}
    k0 = normalize_keypoints(d["kpts0"], d["K"])
    k1 = normalize_keypoints(d["kpts1"], d["K"])
    R0 = torch.linalg.matrix_exp(ransac.skew(torch.full(
        (2, 3), 0.002, dtype=dtype, device=dev))) @ d["T_0to1"][:, :3, :3]
    return (R0, d["T_0to1"][:, :3, 3], k0, k1,
            torch.full((2,), (1 / 780) ** 2, dtype=dtype, device=dev),
            d["valid"]), R0


def test_refine_f32_returns_its_input_on_card(cuda):
    """In float32 the refinement returns (R, t) as they are, as JAX's
    float32 refinement does (its Jacobian is NaN); float64 moves them."""
    from oetr_tpu_torch.geometry import ransac
    args, R0 = _refine_args(cuda, torch.float32)
    R, t = ransac.refine_pose_sampson(*args)
    assert torch.equal(R, R0) and torch.equal(t, args[1])
    args64, R0_64 = _refine_args(cuda, torch.float64)
    assert (ransac.refine_pose_sampson(*args64)[0] - R0_64).abs().max() > 1e-4


# ------------------------------------------- extractors, matchers, COTR --

def _gray_pair(hw, seed):
    """A grayscale pair [1, hw, hw, 1] with structure at 4 px, and its
    shift by 8 px."""
    g = torch.Generator().manual_seed(seed)
    small = torch.rand(1, 1, hw // 4, hw // 4, generator=g)
    img = torch.nn.functional.interpolate(small, size=(hw, hw),
                                          mode="nearest")
    img = (img + 0.05 * torch.randn(img.shape, generator=g)).clamp(0, 1)
    img = img.permute(0, 2, 3, 1).contiguous()
    return img, torch.roll(img, (8, -8), dims=(1, 2))


@pytest.mark.parametrize("name,hw", [("d2net-ss", 128), ("r2d2-desc", 96),
                                     ("disk-desc", 128),
                                     ("aslfeat-desc", 128)])
def test_extractor_on_card_matches_cpu(cuda, name, hw):
    """Each new extractor, seeded weights, f32: dense scores within 1e-4
    of the largest entry, >= 99% of the keypoint slots equal, descriptors
    within 1e-4 on the equal valid slots."""
    from oetr_tpu_torch.models import registry
    gen = lambda: torch.Generator().manual_seed(len(name))
    card = registry.build(name, device=cuda, generator=gen())
    cpu = registry.build(name, device="cpu", generator=gen())
    img, _ = _gray_pair(hw, 3)
    with torch.inference_mode():
        d = {k: v.cpu() for k, v in card(img.to(cuda)).items()}
        c = cpu(img)
    ref = c["dense_scores"]
    assert ((d["dense_scores"] - ref).abs().max()
            <= 1e-4 * max(1.0, ref.abs().max().item()))
    same = (d["keypoints"] == c["keypoints"]).all(-1) & (d["valid"]
                                                       == c["valid"])
    assert same.float().mean() >= 0.99
    both = same & c["valid"]
    assert both.sum() > 0
    assert (d["descriptors"] - c["descriptors"]).abs()[both].max() <= 1e-4


def test_cotr_and_contextdesc_on_card_match_cpu(cuda):
    from oetr_tpu_torch.models import cotr, sift_based
    kw = dict(d_model=64, nhead=4, enc_layers=1, dec_layers=1,
              backbone_depth=18)
    card = cotr.build_cotr(device=cuda, **kw)
    cpu = cotr.build_cotr(device="cpu", **kw)
    g = torch.Generator().manual_seed(5)
    im0 = torch.rand(1, 64, 64, 3, generator=g)
    im1 = torch.roll(im0, 4, dims=2)
    q = torch.rand(1, 64, 2, generator=g) * 0.9 + 0.05
    got = cotr.cotr_match(card, im0.to(cuda), im1.to(cuda), q.to(cuda))
    want = cotr.cotr_match(cpu, im0, im1, q)
    for key in ("mkpts1", "cycle_error"):
        assert (got[key].cpu() - want[key]).abs().max() <= 1e-4, key

    net = sift_based.build_contextdesc(device=cuda)
    ref = sift_based.build_contextdesc(device="cpu")
    k = 50
    desc = torch.rand(1, k, 128, generator=g)
    desc = desc / desc.norm(dim=-1, keepdim=True)
    args = (torch.rand(1, 96, 96, 1, generator=g), desc,
            torch.rand(1, k, 2, generator=g) * 95,
            torch.rand(1, k, generator=g) * 0.1,
            torch.rand(1, k, generator=g) > 0.2)
    with torch.inference_mode():
        dd, dm = net(*[a.to(cuda) for a in args])
        cd, cm = ref(*args)
    assert (dd.cpu() - cd).abs().max() <= 1e-4
    assert (dm.cpu() - cm).abs().max() <= 1e-4


def test_matchers_break_ties_toward_the_lower_index_on_card(cuda):
    """topk_stable(x, 2) on CUDA: the lower index first among equal values (masked rows
    all at -1e9 included), as jax.lax.top_k; the NN and DISK matchers on
    forced ties (repeated descriptors, identity rows, masked columns) give
    the CPU's matches."""
    from oetr_tpu_torch.models import matchers
    from oetr_tpu_torch.ops.nms import topk_stable
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0],
                      [-1e9, -1e9, -1e9, -1e9, -1e9],
                      [0.0, 0.0, 5.0, 0.0, 5.0]])
    x = torch.cat([x, torch.full((1, 5), -1e9)]).repeat(64, 1)
    _, idx = topk_stable(x.to(cuda), 2)
    assert idx[:4].tolist() == [[1, 2], [0, 1], [2, 4], [0, 1]]
    assert torch.equal(idx.cpu(), topk_stable(x, 2)[1])

    g = torch.Generator().manual_seed(9)
    d0 = torch.randn(2, 300, 64, generator=g)
    d1 = torch.randn(2, 400, 64, generator=g)
    d1[:, :40] = d0[:, :40]
    d1[:, 100:110] = d1[:, 99:100]            # ten copies of one vector
    d0[:, 50:60] = d1[:, 99:100] + 0.2 * torch.randn(2, 10, 64, generator=g)
    d0 = d0 / d0.norm(dim=-1, keepdim=True)
    d1 = d1 / d1.norm(dim=-1, keepdim=True)
    v0 = torch.rand(2, 300, generator=g) > 0.1
    v1 = torch.rand(2, 400, generator=g) > 0.1
    v1[1] = False                             # every column masked
    for fn in (matchers.nearest_neighbor_match, matchers.disk_brute_match):
        for masks in ((None, None), (v0, v1)):
            want = fn(d0, d1, *masks)["matches0"]
            got = fn(d0.to(cuda), d1.to(cuda),
                     *[m if m is None else m.to(cuda) for m in masks])
            assert torch.equal(got["matches0"].cpu(), want), fn.__name__


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k,dilation", [(2, 1), (3, 1), (3, 2), (3, 4)])
@pytest.mark.parametrize("size", [15, 16])
def test_same_conv_on_card_matches_cpu(cuda, stride, k, dilation, size):
    from oetr_tpu_torch.models import layers
    with torch.device("meta"):
        conv = layers.Conv(4, 6, k, stride, "SAME", dilation=dilation)
    card = layers.materialize(conv, cuda, None)
    with torch.device("meta"):
        conv = layers.Conv(4, 6, k, stride, "SAME", dilation=dilation)
    cpu = layers.materialize(conv, "cpu", None)
    x = torch.rand(2, 4, size, size + 3, generator=torch.Generator()
                   .manual_seed(k))
    with torch.inference_mode():
        got, want = card(x.to(cuda)).cpu(), cpu(x)
    assert got.shape == want.shape == (2, 6, -(-size // stride),
                                       -(-(size + 3) // stride))
    assert (got - want).abs().max() <= 1e-5


def test_public_api_on_card_matches_cpu(cuda):
    """build_model + get_matches's helper (below the decode) with DISK and
    its matcher, and get_pose, on the card against the CPU."""
    from oetr_tpu_torch.pipelines import api
    cfg = port.PipelineConfig(canvas_hw=(128, 128), oetr_hw=(128, 128))
    img0, img1 = (t[0].repeat(1, 1, 3).numpy() for t in _gray_pair(160, 4))
    res = {}
    for dev in (cuda, "cpu"):
        model = api.build_model("disk-desc", "disk", cfg=cfg, device=dev)
        res[str(dev)] = api._match_images(model, img0, img1)
    got, want = res[str(cuda)], res["cpu"]

    def rows(r):
        """The matches as (x0, y0, x1, y1), to 0.01 px."""
        m = r["matches"]
        return {tuple(np.round(np.concatenate([r["kpts0"][a], r["kpts1"][b]]),
                               2)) for a, b in m.T}

    sg, sw = rows(got), rows(want)
    assert len(sw) > 10
    assert len(sg & sw) >= 0.99 * max(len(sg), len(sw))
    pose = api.get_pose(got, device=cuda)
    assert np.isfinite(pose["H"]).all() and pose["ok"]


def test_shipped_superglue_on_card_matches_cpu(cuda):
    """The trained SuperGlue of ``build_shipped_model`` (read by the port's
    own reader) on the card against its copy on the CPU at 256² and 512
    slots, at chip_smoke.py's shipped-phase bounds: matches0 at 0.2 equal
    by slot on >= 99% of the valid keypoints, the log assignment within
    1e-4 of max(1, its largest unmasked entry); and JAX's matcher gate on
    the card (SuperGlue's assignment precision >= NN's)."""
    import chip_smoke

    cfg = port.PipelineConfig(canvas_hw=(256, 256), oetr_hw=(256, 256))
    pipe, _ = port.build_shipped_model("superglue", cfg=cfg, device=cuda)
    gate, first = chip_smoke.shipped_gate(
        torch, port, pipe.extractor.state_dict(), pipe.match_fn)
    fields, failed = chip_smoke.shipped_card_vs_cpu(
        torch, port, pipe.match_fn, *first, 256)
    print(json.dumps({"gate": gate, "card_vs_cpu": fields}))
    assert not failed, failed
    assert gate["superglue_precision"] >= gate["nn_precision"], gate
    assert fields["matches_thr_0.2"] > 0


# --------------------------------------------------------------- sfm ----

def _sfm_problem(n_cams=5, n_pts=80, noise=0.5, zero_rot=False, seed=50):
    """Points seen by every camera of a short rig (tests/test_sfm.py's
    problem), cameras and points perturbed, camera 0 exact; float32."""
    from oetr_tpu_torch.evalx.trajectory import so3_exp_np

    rng = np.random.default_rng(seed)
    K = np.tile(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]]),
                (n_cams, 1, 1))
    cams = np.concatenate([rng.uniform(-0.08, 0.08, (n_cams, 3)),
                           np.stack([0.5 * np.arange(n_cams),
                                     rng.normal(0, 0.05, n_cams),
                                     rng.normal(0, 0.05, n_cams)], 1)], 1)
    if zero_rot:
        cams[0, :3] = 0.0
    pts = rng.uniform(-2, 2, (n_pts, 3)) + [0, 0, 8.0]
    oc = np.repeat(np.arange(n_cams), n_pts)
    op = np.tile(np.arange(n_pts), n_cams)
    R = np.stack([so3_exp_np(c[:3]) for c in cams])
    x = np.einsum("oij,oj->oi", R[oc], pts[op]) + cams[oc, 3:]
    uv = np.einsum("oij,oj->oi", K[oc], x / x[:, 2:])[:, :2]
    uv += rng.normal(0, noise, uv.shape)
    init = cams + np.concatenate([rng.normal(0, 0.01, (n_cams, 3)),
                                  rng.normal(0, 0.05, (n_cams, 3))], 1)
    init[0] = cams[0]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    return [f32(init), f32(pts + rng.normal(0, 0.05, pts.shape)), f32(K),
            torch.as_tensor(oc), torch.as_tensor(op), f32(uv),
            torch.ones(len(oc), dtype=torch.bool)], cams


def _pinned_scale(n_cams):
    """Camera 0 fixed and camera 1's x translation: no free direction."""
    m = torch.ones(n_cams, 6)
    m[0] = 0.0
    m[1, 3] = 0.0
    return m


def test_triangulate_points_on_card_against_lapack(cuda, monkeypatch):
    """One launch of the eigh kernel (n = 4) for all tracks, its input
    against LAPACK at EIGH_TOL; the card's points against the CPU's by
    their reprojection errors (AᵀA is badly scaled, so raw coordinates of
    narrow-baseline tracks follow the eigensolver's last bits)."""
    from oetr_tpu_torch.sfm import ba

    args, cams = _sfm_problem(n_cams=6, n_pts=300, noise=0.3)
    _, _, K, oc, op, uv, _ = args
    cams = torch.as_tensor(cams, dtype=torch.float32)
    n_views = torch.as_tensor(np.random.default_rng(51).integers(2, 7, 300))
    valid = torch.arange(6)[None] < n_views[:, None]
    tc, tK = cams[None].expand(300, 6, 6), K[None].expand(300, 6, 3, 3)
    tuv = uv.reshape(6, 300, 2).transpose(0, 1)
    calls, real = [], ba.eigh

    def recorder(A):
        out = real(A)
        calls.append((A, *out))
        return out

    monkeypatch.setattr(ba, "eigh", recorder)
    before = ops.eigh.launches
    card = ba.triangulate_points(*(t.to(cuda) for t in (tc, tK, tuv, valid)))
    assert ops.eigh.launches - before == 1
    assert len(calls) == 1 and tuple(calls[0][0].shape) == (300, 4, 4)
    _check_eigh(*calls[0])
    cpu = ba.triangulate_points(tc, tK, tuv, valid)

    def reproj(X):
        views = valid.reshape(-1)
        r = ba.residuals(tc.reshape(-1, 6), X.cpu(), tK.reshape(-1, 3, 3),
                         torch.arange(1800), torch.arange(300)
                         .repeat_interleave(6), tuv.reshape(-1, 2),
                         views.float())
        return r.norm(dim=-1).reshape(300, 6).amax(-1)

    e_card, e_cpu = reproj(card), reproj(cpu)
    assert (e_card - e_cpu).abs().max() < 1e-2
    assert e_cpu.median() < 1.0


def test_bundle_adjust_card_vs_cpu(cuda):
    """f32, the scale pinned: the cost history within 1e-4 of cost0, the
    cameras within 1e-4 and the points within 1e-3 of the CPU's (the card
    sums with atomics, in another order on every run); with and without
    Huber."""
    from oetr_tpu_torch.sfm import bundle_adjust

    args, _ = _sfm_problem()
    mask = _pinned_scale(5)
    for huber in (0.0, 4.0):
        kw = dict(iters=8, cg_iters=25, huber_delta=huber)
        cpu = bundle_adjust(*args, update_mask=mask, **kw)
        card = bundle_adjust(*(t.to(cuda) for t in args),
                             update_mask=mask.to(cuda), **kw)
        h, hc = cpu["cost_history"], card["cost_history"].cpu()
        assert h[-1] < 0.2 * h[0]
        assert (hc - h).abs().max() / h[0] < 1e-4
        assert (card["cams"].cpu() - cpu["cams"]).abs().max() < 1e-4
        assert (card["pts"].cpu() - cpu["pts"]).abs().max() < 1e-3


def test_bundle_adjust_reads_nothing_back(cuda):
    """In a profiler trace of a call: no device -> host copy and no wait
    issued by an operator (the LM and CG loops stay on the card); the
    test's own synchronize, after the call, is issued by none. (torch's
    ``linalg_lu_solve``, under ``inv_ex``, reads 0-dim host tensors with
    ``item``: no copy and no wait, so they are not counted.)"""
    from oetr_tpu_torch.sfm import bundle_adjust

    args = [t.to(cuda) for t in _sfm_problem()[0]]
    call = lambda: bundle_adjust(*args, iters=3, cg_iters=10, huber_delta=4.0)
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    dtoh = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "DtoH" in e.name]
    # A wait that an operator issued; the test's own synchronize (and the
    # profiler's) is issued by no operator.
    waits = [f"{e.name} in {e.cpu_parent.name}" for e in prof.events()
             if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpy", "cudaEventSynchronize")
             and e.cpu_parent is not None]
    launches = [e for e in prof.events() if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")]
    assert len(launches) > 1000
    assert not dtoh and not waits, (dtoh, waits)


@pytest.mark.parametrize("mode", ["grad", "inference"])
def test_bundle_adjust_zero_rotation_quirk_on_card(cuda, mode):
    """Camera 0 at exactly zero rotation in f32: NaN Jacobians, every step
    rejected, the cost at cost0 throughout (JAX's quirk); from a camera 0
    at 1e-3 rad the cost falls. Under inference mode too: the Jacobians
    are taken outside it (torch 2.11's forward AD gives zero tangents
    there)."""
    from oetr_tpu_torch.sfm import bundle_adjust

    ctx = torch.inference_mode() if mode == "inference" else \
        torch.enable_grad()
    for zero in (True, False):
        args, _ = _sfm_problem(zero_rot=zero)
        if not zero:
            args[0][0, :3] = 1e-3
        with ctx:
            out = bundle_adjust(*(t.to(cuda) for t in args), iters=5,
                                cg_iters=20)
        h = out["cost_history"].cpu()
        if zero:
            assert (h == h[0]).all()
            assert torch.equal(out["cams"].cpu(), args[0])
        else:
            assert h[-1] < 0.2 * h[0]


def test_reconstruct_on_card_matches_cpu(cuda):
    """``reconstruct`` (2 rounds, Huber) on a 5-camera scene with identity
    matches: the same tracks and point_valid, the final cost within 1e-3
    of the CPU's, the ATE of each within 1e-3 of the other's and below
    half the start's."""
    from oetr_tpu_torch.evalx.trajectory import absolute_trajectory_error
    from oetr_tpu_torch.sfm import reconstruct

    args, cams_gt = _sfm_problem(n_cams=5, n_pts=60)
    _, _, K, oc, op, uv, _ = args
    kps = [uv[oc == i].numpy() for i in range(5)]
    idx = np.arange(60)
    matches = {(i, j): np.stack([idx, idx]) for i in range(5)
               for j in range(i + 1, 5)}
    init = args[0].numpy().astype(np.float64)
    kw = dict(ba_iters=8, rounds=2)
    card = reconstruct(kps, matches, K.numpy(), init, device=cuda, **kw)
    cpu = reconstruct(kps, matches, K.numpy(), init, device="cpu", **kw)
    np.testing.assert_array_equal(card["tracks"].obs_kp, cpu["tracks"].obs_kp)
    np.testing.assert_array_equal(card["point_valid"], cpu["point_valid"])
    hc, h = card["cost_history"], cpu["cost_history"]
    assert abs(hc[-1] - h[-1]) < 1e-3 * h[0]
    ate = [absolute_trajectory_error(r["cams"], cams_gt)["ate_rmse"]
           for r in (card, cpu)]
    ate0 = absolute_trajectory_error(init, cams_gt)["ate_rmse"]
    assert abs(ate[0] - ate[1]) < 1e-3 and max(ate) < 0.5 * ate0


# ------------------------------------------------------ matching trainers --

MATCH_TRAINERS = ("superpoint", "superglue", "loftr", "contextdesc", "fcos")


def _match_case(name):
    """(build(device) -> model with seeded weights, make_step(model,
    optimizer), the step's arguments on the CPU, lr) of a matching trainer
    at small widths."""
    from oetr_tpu_torch import training as tr
    from oetr_tpu_torch.data.device_synth import warp_gray
    from oetr_tpu_torch.geometry.boxes import compute_locations
    from oetr_tpu_torch.models import fcos
    from oetr_tpu_torch.models.sift_based import build_contextdesc
    from oetr_tpu_torch.training.optim import apply_update

    rng = np.random.default_rng(7)
    seeded = lambda: torch.Generator().manual_seed(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    if name == "superpoint":
        hw = 64
        H = torch.from_numpy(np.stack([tr.random_homography(rng, (hw, hw))
                                       for _ in range(2)]).astype(np.float32))
        im0 = torch.rand(2, hw, hw, 1, generator=seeded())
        im1, _ = warp_gray(im0, H, hw)
        ha = tr.make_corner_labeler(hw, max_cells=16, device="cpu")(im0)
        args = (torch.rand(2, hw, hw, 1, generator=seeded()),
                t(rng.integers(0, 65, (2, 8, 8)).astype(np.int32)), im0,
                im1, H, ha, torch.tensor(1.0))
        return (lambda dev: port.build_superpoint_net(
                    device=dev, generator=seeded(), descriptor_dim=32),
                lambda m, o: tr.make_superpoint_joint_ha_train_step(
                    m, o, clip_norm=1.0), args, 5e-4)
    if name == "superglue":
        b, k, d = 2, 24, 32
        desc = rng.normal(size=(2, b, k, d)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        v0, v1 = rng.random((b, k)) > 0.1, rng.random((b, k)) > 0.1
        gt = np.stack([rng.permutation(k) for _ in range(b)])
        gt = np.where((rng.random((b, k)) < 0.6) & v0
                      & np.take_along_axis(v1, gt, 1), gt, -1)
        batch = {"keypoints0": t(rng.uniform(0, 100, (b, k, 2))).float(),
                 "keypoints1": t(rng.uniform(0, 100, (b, k, 2))).float(),
                 "descriptors0": t(desc[0]), "descriptors1": t(desc[1]),
                 "scores0": t(rng.uniform(0, 1, (b, k))).float(),
                 "scores1": t(rng.uniform(0, 1, (b, k))).float(),
                 "valid0": t(v0), "valid1": t(v1),
                 "gt_matches0": t(gt.astype(np.int32)),
                 "image_hw0": (128, 128), "image_hw1": (128, 128)}
        return (lambda dev: port.build_superglue(
                    device=dev, generator=seeded(), descriptor_dim=d,
                    keypoint_encoder_layers=(16, 32), gnn_layers=2),
                lambda m, o: tr.make_superglue_train_step(m, o,
                                                          clip_norm=1.0),
                (batch,), 1e-4)
    if name == "loftr":
        hw = 64
        im0 = torch.rand(2, hw, hw, 1, generator=seeded())
        im1 = torch.zeros_like(im0)
        im1[:, :, 8:] = im0[:, :, :-8]
        gt = tr.shift_pair_gt((hw, hw), (8, 0)).expand(2, -1).contiguous()
        u = torch.arange(8, dtype=torch.float32) * 8 + 4.0
        gy, gx = torch.meshgrid(u, u, indexing="ij")
        xy = torch.stack([gx.reshape(-1) + 8, gy.reshape(-1)], -1)
        return (lambda dev: port.build_loftr(
                    device=dev, generator=seeded(), d_coarse=32, d_fine=16,
                    coarse_layers=1, nhead=4, match_threshold=0.0,
                    max_matches=32),
                lambda m, o: tr.make_loftr_train_step(m, o, 1.0,
                                                      clip_norm=1.0),
                (im0, im1, gt, xy.expand(2, -1, -1).contiguous(),
                 (xy[:, 0] < hw).expand(2, -1).contiguous()), 2e-4)
    if name == "contextdesc":
        b, k, hw = 2, 32, 64
        d = rng.random((2, b, k, 128)) ** 4
        d = np.sqrt(d / d.sum(-1, keepdims=True)).astype(np.float32)
        v0, v1 = rng.random((b, k)) > 0.1, rng.random((b, k)) > 0.1
        gt = np.stack([rng.permutation(k) for _ in range(b)])
        gt = np.where((rng.random((b, k)) < 0.5) & v0
                      & np.take_along_axis(v1, gt, 1), gt, -1)
        batch = {"image0": torch.rand(b, hw, hw, 1, generator=seeded()),
                 "image1": torch.rand(b, hw, hw, 1, generator=seeded()),
                 "desc0": t(d[0]), "desc1": t(d[1]),
                 "xy0": t(rng.uniform(0, hw - 1, (b, k, 2))).float(),
                 "xy1": t(rng.uniform(0, hw - 1, (b, k, 2))).float(),
                 "scores0": t(rng.uniform(0, 0.1, (b, k))).float(),
                 "scores1": t(rng.uniform(0, 0.1, (b, k))).float(),
                 "valid0": t(v0), "valid1": t(v1),
                 "gt_matches0": t(gt.astype(np.int32))}
        return (lambda dev: build_contextdesc(
                    device=dev, generator=seeded(), regional_dim=16,
                    hidden=32),
                lambda m, o: tr.make_contextdesc_train_step(m, o),
                (batch,), 1e-3)

    def make_fcos(m, o):
        def step(x, boxes):
            o.zero_grad(set_to_none=True)
            out = fcos.fcos_losses(compute_locations(8, 8, 16,
                                                     device=x.device),
                                   *m(x), boxes)
            loss = (out["cls_loss"] + out["reg_loss"]
                    + out["centerness_loss"])
            loss.backward()
            apply_update(m.parameters(), o)
            return {"loss": loss.detach()}
        return step

    boxes = torch.tensor([[8.0, 8.0, 100.0, 90.0], [30.0, 0.0, 128.0, 70.0]])
    return (lambda dev: fcos.build_fcos_head(device=dev, generator=seeded(),
                                             in_channels=64),
            make_fcos, (torch.randn(2, 8, 8, 64, generator=seeded()), boxes),
            1e-4)


def _to(value, dev):
    if isinstance(value, dict):
        return {k: _to(v, dev) for k, v in value.items()}
    return value.to(dev) if isinstance(value, torch.Tensor) else value


def _match_step(name, dev):
    """One step of trainer ``name`` on ``dev``: (metrics, the global
    gradient norm before the clip, parameters after, the model)."""
    from oetr_tpu_torch.training import optim

    build, make_step, args, lr = _match_case(name)
    model = build(dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    norms, clip = [], optim.clip_by_global_norm_

    def record(grads, max_norm):
        norms.append(clip(grads, max_norm))
        return norms[-1]

    optim.clip_by_global_norm_ = record
    try:
        metrics = make_step(model, opt)(*[_to(a, dev) for a in args])
    finally:
        optim.clip_by_global_norm_ = clip
    norm = norms[0] if norms else torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.parameters()]))
    return ({k: v.item() for k, v in metrics.items()}, norm.item(),
            {k: p.detach().cpu() for k, p in model.named_parameters()},
            model, lr)


@pytest.mark.parametrize("name", MATCH_TRAINERS)
def test_match_train_step_card_vs_cpu(cuda, name):
    """One step on the card against the CPU from the same seeded weights
    and inputs (f32, TF32 off): the loss within 1e-4 relative, the global
    gradient norm before the clip within 1e-3, every parameter within
    2·lr (+1e-6 of |p|) of the CPU's after the update, and within 0.1·lr
    where the CPU's gradient is above 0.1 of the parameter's largest, above
    1e-6 and above 10 times the card's difference from it (there both
    gradients share their sign, so both steps do)."""
    mc, nc, pc, card, lr = _match_step(name, cuda)
    mh, nh, ph, model, _ = _match_step(name, "cpu")
    card_g = {k: p.grad.cpu() for k, p in card.named_parameters()}
    assert abs(mc["loss"] - mh["loss"]) <= 1e-4 * abs(mh["loss"]), (mc, mh)
    assert abs(nc - nh) <= 1e-3 * nh, (nc, nh)
    for k, p in model.named_parameters():
        diff = (pc[k] - ph[k]).abs()
        assert (diff <= 2 * lr + 1e-6 * ph[k].abs()).all(), k
        g = p.grad.abs()
        firm = ((g > max(0.1 * g.max().item(), 1e-6))
                & (g > 10 * (card_g[k] - p.grad).abs()))
        assert (diff[firm] <= 0.1 * lr).all(), k


@pytest.mark.parametrize("name", MATCH_TRAINERS)
def test_match_train_step_reads_nothing_back(cuda, name):
    """No device -> host copy in a traced step (after a warm-up)."""
    build, make_step, args, lr = _match_case(name)
    model = build(cuda)
    step = make_step(model, torch.optim.Adam(model.parameters(), lr=lr))
    args = [_to(a, cuda) for a in args]
    step(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(*args)
        torch.cuda.synchronize()
    dtoh = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "DtoH" in e.name]
    assert not dtoh, dtoh


def test_ha_labeler_card_vs_cpu(cuda):
    """The homographic-adaptation labels on the card equal the CPU's on the
    same draws and weights on >= 99% of the cells; the labeler's draws come
    from a generator on the images' device."""
    from oetr_tpu_torch import training as tr

    hw, b = 64, 4
    net = port.build_superpoint_net(device=cuda, descriptor_dim=32)
    cpu = port.build_superpoint_net(device="cpu", descriptor_dim=32)
    im0, _, _ = port.make_homography_pair_generator(hw, b, device=cuda)(
        torch.Generator(device=cuda).manual_seed(1))
    Hs = tr.draw_ha_homographies(torch.Generator(device=cuda).manual_seed(2),
                                 3, b, hw)
    assert Hs.device.type == "cuda"
    card = tr.ha_labels(net, im0, Hs, max_cells=24).cpu()
    ref = tr.ha_labels(cpu, im0.cpu(), Hs.cpu(), max_cells=24)
    assert (card == ref).float().mean().item() >= 0.99
    labels = tr.make_ha_labeler(net, hw, n_homo=3, max_cells=24)(
        im0, torch.Generator(device=cuda).manual_seed(2))
    assert torch.equal(labels.cpu(), card)


# ---------------------------------------------------------- variants ----

def _variant_cfg(variant, dtype="float32", **kw):
    bb = {"bn": dict(norm="bn"), "ln": dict(norm="ln"),
          "s2d": dict(norm="gn", stem_s2d=True)}[variant]
    return port.OETRConfig(
        backbone=port.BackboneConfig(depth=18, last_layer=256,
                                     fused_stem=True, **bb, **kw),
        neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                             num_decoder_layers=1, attention="linear:cuda"),
        dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["bn", "ln", "s2d"])
def test_variant_kernel_calls_match_plain(cuda, variant, dtype):
    """Each variant's forward on the card: K2 4 calls (self and cross, each
    image), K3 1 call with the s2d + GroupNorm stem (on the 4x4 conv's
    output) and none with 'bn' or 'ln' (JAX's rule); every call's output
    against its plain version on the same inputs (chip_smoke.py's
    recorder, at the kernel checks' bounds)."""
    import chip_smoke

    model = port.build_oetr(_variant_cfg(variant, dtype), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    im1, im2 = torch.rand(2, 2, 160, 160, 3, generator=g, device=cuda)
    want = {"linear_encoder_attention": 4}
    if variant == "s2d":
        want["groupnorm_relu_maxpool"] = 1
    before = {k: getattr(ops, k).launches for k in
              ("linear_encoder_attention", "groupnorm_relu_maxpool")}
    with torch.inference_mode(), chip_smoke.recorded_kernel_calls() as calls:
        model(im1, im2)
    got = {k: getattr(ops, k).launches - n for k, n in before.items()}
    assert got == {"linear_encoder_attention": 4,
                   "groupnorm_relu_maxpool": int(variant == "s2d")}
    errs = chip_smoke.recorded_kernel_errors(torch, ops, calls, variant)
    assert {k: v["calls"] for k, v in errs.items()} == want
    if variant == "s2d":
        # the 4x4 conv's output: [2 x 2 images, 160 / 2, 160 / 2, 64]
        assert errs["groupnorm_relu_maxpool"]["input"] == [4, 80, 80, 64]


def test_bn_forward_on_card_matches_cpu(cuda):
    """The frozen BatchNorm OETR, f32 (TF32 off), statistics drawn as a
    trained network's: the card (K2) against the CPU (plain versions)
    with the same state, at the small forward's bounds."""
    from oetr_tpu_torch.models.resnet import FrozenBatchNorm

    cfg = _variant_cfg("bn")
    on_cpu = port.build_oetr(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in on_cpu.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape[0]
                m.mean.copy_(0.1 * torch.randn(c, generator=g))
                m.var.copy_(0.5 + torch.rand(c, generator=g))
    on_card = port.build_oetr(cfg, device=cuda)
    on_card.load_state_dict(on_cpu.state_dict())
    im1, im2 = torch.rand(2, 2, 160, 160, 3, generator=g)
    with torch.inference_mode():
        a = on_card(im1.to(cuda), im2.to(cuda))
        b = on_cpu(im1, im2)
    for key in b:
        torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                   atol=1e-3, msg=key)


def test_profiling_utilities_on_card(cuda):
    """device_memory_stats reads the allocator and the card; benchmark
    waits for the card; trace records its kernels."""
    from oetr_tpu_torch.utils import profiling

    keys = {"bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
            "bytes_limit", "bytes_free", "utilization"}
    before = profiling.device_memory_stats("cuda")
    assert set(before) == keys
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    after = profiling.device_memory_stats(cuda)
    assert after["bytes_in_use"] - before["bytes_in_use"] >= 64 << 20
    assert 0 < after["bytes_in_use"] <= after["bytes_limit"]
    assert 0 < after["utilization"] <= 1
    assert set(profiling.device_memory_stats()) == keys   # the card's
    del x
    a = torch.rand(2048, 2048, device=cuda)
    res = profiling.benchmark(lambda: [a @ a], iters=3, warmup=1)
    assert res["mean_s"] > 0
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            a @ a
        work, _ = profiling.device_events(prof)
        assert any("gemm" in e.name.lower() or "cutlass" in e.name.lower()
                   or "xmma" in e.name.lower() for e in work)


def _offset_storage(state):
    """Every parameter moved to a buffer of its own at a one-element
    offset (storage laid out as FSDP's gathers lay it out), the optimizer
    with them."""
    old = list(state.model.parameters())
    for mod in state.model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            view = torch.empty(p.numel() + 1, dtype=p.dtype,
                               device=p.device)[1:].view_as(p)
            view.copy_(p.detach())
            mod._parameters[name] = torch.nn.Parameter(view)
    new = dict(zip(map(id, old), state.model.parameters()))
    for g in state.optimizer.param_groups:
        g["params"] = [new[id(p)] for p in g["params"]]


def _nccl_layouts(cuda, tmp_path, hw, deterministic, rtol, offset=False):
    """A small OETR's steps at ``hw``² under DDP (f32, K2 and K3 on) and
    FSDP2 (bf16, K2 on) at one NCCL rank against one process, cuDNN's
    deterministic algorithms or its defaults, within ``rtol[dtype]``; with
    ``offset`` the one process again (the card's own spread) and FSDP2
    also against one process whose parameters lie at an offset
    (``_offset_storage``), each within 1e-4, and one JSON line a dtype on
    stdout with each run's losses and their largest relative differences
    from the first run (``pytest -s`` shows it); ring attention against
    full attention."""
    import torch.distributed as dist

    from oetr_tpu_torch.ops.attention import full_attention
    from oetr_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         ring_attention)
    from oetr_tpu_torch.training import create_train_state, make_train_step
    from oetr_tpu_torch.training.train import shard_train_state

    initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        g = torch.Generator(device=cuda)
        synth = port.make_device_generator(hw, 2, device=cuda)
        batches = [synth(g.manual_seed(i)) for i in range(2)]
        for dtype_name, lr, axes, fsdp in (
                ("float32", 1e-4, {"data": 1}, None),
                ("bfloat16", 1e-2, {"data": 1, "fsdp": 1}, "fsdp")):
            cfg = port.OETRConfig(
                backbone=port.BackboneConfig(depth=18, last_layer=256,
                                             fused_stem=True),
                neck=port.NeckConfig(d_model=64, nhead=4, num_layers=1,
                                     num_decoder_layers=1, max_shape=(10, 10),
                                     attention="linear:cuda"),
                dtype=dtype_name)
            tcfg = port.TrainConfig(lr=lr)
            losses = []
            runs = [(None, False), (axes, False)]
            if offset:
                runs.append((None, False))
                if fsdp:
                    runs.append((None, True))
            for layout, moved in runs:
                _, st = create_train_state(
                    cfg, tcfg, torch.Generator().manual_seed(0), device=cuda)
                if moved:
                    _offset_storage(st)
                group = None
                if layout is not None:
                    mesh = make_mesh(layout, "cuda")
                    st, _ = shard_train_state(st, mesh, rules=[],
                                              fsdp_axis=fsdp)
                    group = mesh["data"].get_group()
                step = make_train_step(cycle=True, group=group)
                with torch.backends.cudnn.flags(
                        enabled=True, benchmark=False,
                        deterministic=deterministic):
                    losses.append([step(st, b, g.manual_seed(10 + i))[1][
                        "loss"].item() for i, b in enumerate(batches)])
            np.testing.assert_allclose(losses[1], losses[0],
                                       rtol=rtol[dtype_name],
                                       err_msg=dtype_name)
            if offset:
                rel = lambda a: max(abs(x - y) / abs(y)
                                    for x, y in zip(a, losses[0]))
                print(json.dumps({
                    "hw": hw, "dtype": dtype_name, "lr": lr,
                    "cudnn": "deterministic" if deterministic
                    else "defaults", "losses": losses,
                    "layout_vs_local": rel(losses[1]),
                    "local_again_vs_local": rel(losses[2]),
                    **({"offset_vs_local": rel(losses[3])}
                       if fsdp else {})}))
                np.testing.assert_allclose(losses[2], losses[0], rtol=1e-4,
                                           err_msg="one process again")
                if fsdp:
                    np.testing.assert_allclose(losses[1], losses[3],
                                               rtol=1e-4,
                                               err_msg="offset storage")
        gen = torch.Generator(device=cuda).manual_seed(3)
        q, k, v = (torch.randn(2, 16, 4, 8, generator=gen, device=cuda)
                   for _ in range(3))
        km = torch.rand(2, 16, generator=gen, device=cuda) > 0.3
        torch.testing.assert_close(ring_attention(q, k, v, None, km),
                                   full_attention(q, k, v, None, km),
                                   rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_nccl_one_rank_layouts_match_local(cuda, tmp_path):
    """NCCL at world size 1 (the card's machine has one H100): a small
    OETR's steps under DDP (f32, K2 and K3 on) and under FSDP2 (bf16, K2
    on, lr 1e-2 so that the bf16 weights move each step; K2's cached
    weights must follow FSDP's gathers) against the one-process steps, and
    ring attention over the one rank against full attention; 160² under
    cuDNN's deterministic algorithms."""
    _nccl_layouts(cuda, tmp_path, 160, True,
                  {"float32": 1e-4, "bfloat16": 1e-4})


def test_nccl_one_rank_layouts_match_local_64(cuda, tmp_path):
    """The same at 64² under cuDNN's defaults, what chip_smoke.py's
    ``multi`` phase runs with (NCCL_64_RTOL), and FSDP2 against one
    process with its parameters at FSDP's offsets."""
    _nccl_layouts(cuda, tmp_path, 64, False, NCCL_64_RTOL, offset=True)


# ------------------------------------------------------------------ demos --

def _demo_case(name, dev):
    """(model, optimizer, scheduler, step() -> metrics, lr) of one demo
    program's train phase at a small width on ``dev``, its data made on the
    CPU (from seeds) and moved to ``dev``."""
    from oetr_tpu_torch.scripts import train_demo as td
    from oetr_tpu_torch.scripts import train_loftr_demo as ld
    from oetr_tpu_torch.scripts import train_matching_demo as md
    from oetr_tpu_torch.scripts.common import adam
    from oetr_tpu_torch.training import create_train_state

    cpu = lambda seed: torch.Generator().manual_seed(seed)
    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    if name == "train_demo":
        args = td.parse_args(["--batch", "2", "--hw", "160", "--device",
                              str(dev)])
        cfg = td.model_config(fused_stem=True, attention="linear:cuda")
        model, state = create_train_state(cfg, td.train_config(args), cpu(0),
                                          device=dev)
        for m in model.modules():
            if hasattr(m, "rate"):
                m.rate = 0.0
        batch = to(port.make_device_generator(
            160, 2, scale_range=(1.0, 1.0), p_translate=1.0,
            device="cpu")(cpu(1)))
        step = lambda: {"loss": td.train_oetr(state, iter([batch]), 1,
                                              None)[0]}
        return model, state.optimizer, step, args.lr
    margs = md.parse_args(["--device_data", "--sp_batch", "2", "--sp_hw",
                           "64", "--desc_dim", "32", "--sg_batch", "2",
                           "--topk", "64", "--hw", "64", "--device",
                           str(dev)])
    if name == "superpoint":
        net = port.build_superpoint_net(device=dev, generator=cpu(2),
                                        descriptor_dim=32)
        opt, sched = adam(net, md.SP_LR, margs.sp_steps)
        pairs = [x.to(dev) for x in port.make_homography_pair_generator(
            64, 2, scale_range=(0.55, 1.8), device="cpu")(cpu(3))]
        step = lambda: md.train_superpoint(
            net, opt, sched, margs, np.random.default_rng(0),
            lambda rng, b, it: pairs, stop=1)
        return net, opt, step, md.SP_LR
    if name == "superglue":
        net = port.build_superpoint_net(device="cpu", generator=cpu(2),
                                        descriptor_dim=32)
        raw = port.make_device_generator(64, 2, scale_range=(1.0, 2.0),
                                         p_translate=0.5, device="cpu")(cpu(4))
        batch = md.sg_device_prep(md.extractor(net, margs), raw, 64)
        batch = {k: v.to(dev) if hasattr(v, "to") else v
                 for k, v in batch.items()}
        sg = md.build_sg(margs, dev, cpu(5)).train()
        opt, sched = adam(sg, margs.sg_lr, margs.sg_steps)
        step = lambda: md.train_superglue(sg, opt, sched, iter([batch]), 1)
        return sg, opt, step, margs.sg_lr
    largs = ld.parse_args(["--batch", "2", "--hw", "64", "--d_coarse", "32",
                           "--layers", "1", "--device", str(dev)])
    model = ld.build_model(largs, dev, cpu(6))
    opt, sched = adam(model, largs.lr, largs.steps)
    raw = to(port.make_device_generator(64, 2, scale_range=(1.0, 2.0),
                                        p_translate=0.5, device="cpu")(cpu(7)))
    step = lambda: ld.train_loftr(model, opt, sched, largs, lambda it: raw,
                                  stop=1)
    return model, opt, step, largs.lr


def _demo_step(name, dev):
    """One step of a demo's train phase on ``dev``: (metrics, the global
    gradient norm before any clip, parameters after, the model, lr)."""
    from oetr_tpu_torch.training import optim

    model, opt, step, lr = _demo_case(name, dev)
    norms, clip = [], optim.clip_by_global_norm_

    def record(grads, max_norm):
        norms.append(clip(grads, max_norm))
        return norms[-1]

    optim.clip_by_global_norm_ = record
    try:
        metrics = step()
    finally:
        optim.clip_by_global_norm_ = clip
    norm = norms[0] if norms else torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.parameters()]))
    return ({k: v.item() for k, v in metrics.items()}, norm.item(),
            {k: p.detach().cpu() for k, p in model.named_parameters()},
            model, lr)


@pytest.mark.parametrize("name", ["train_demo", "superpoint", "superglue",
                                  "loftr"])
def test_demo_train_step_card_vs_cpu(cuda, name):
    """One step of each demo program's train phase (train_demo's OETR with
    K2 and K3 on; train_matching_demo's SuperPoint with the corner teacher
    and its SuperGlue; train_loftr_demo's LoFTR with the fine loss) on the
    card against the CPU from the same seeded weights and data, at the
    matching trainers' card-vs-CPU bounds (PERF.md §2): the loss 1e-4
    relative, the gradient norm before the clip 1e-3, every parameter
    within 2·lr (+1e-6 of |p|), and within 0.1·lr where the CPU's gradient
    is firm (above 0.1 of the parameter's largest, 1e-6 and 10 times the
    card's difference from it)."""
    mc, nc, pc, card, lr = _demo_step(name, cuda)
    mh, nh, ph, model, _ = _demo_step(name, "cpu")
    card_g = {k: p.grad.cpu() for k, p in card.named_parameters()}
    assert abs(mc["loss"] - mh["loss"]) <= 1e-4 * abs(mh["loss"]), (mc, mh)
    assert abs(nc - nh) <= 1e-3 * nh, (nc, nh)
    for k, p in model.named_parameters():
        diff = (pc[k] - ph[k]).abs()
        assert (diff <= 2 * lr + 1e-6 * ph[k].abs()).all(), k
        g = p.grad.abs()
        firm = ((g > max(0.1 * g.max().item(), 1e-6))
                & (g > 10 * (card_g[k] - p.grad).abs()))
        assert (diff[firm] <= 0.1 * lr).all(), k


# ------------------------------------------------- the all-trained path ----

def _trained_trees():
    from oetr_tpu_torch.pipelines.api import shipped_tree

    return {n: shipped_tree(n) for n in ("oetr", "superpoint", "superglue")}


def _trained_stage5(cuda, monkeypatch, trees):
    """chip_smoke.py's stage 5 at 256² (canvas and OETR copies) on 2 scene
    pairs from the card's generator, every switch on: (models, first pass,
    its SuperGlue matches, the arguments)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CANVAS_HW", 256)
    monkeypatch.setattr(chip_smoke, "IMAGE_HW", 256)
    models = chip_smoke.stage5_models(torch, port, trees, "bfloat16",
                                      device=cuda)
    cap = chip_smoke.Capture(models[2])
    pipe = chip_smoke.pipeline(port, models, cap, 30)
    args, _ = chip_smoke.scene_inputs(2, seed=7)
    with torch.inference_mode():
        first = pipe._run(*args, use_overlap=True)
    return models, first, cap.last["matches0"], args


def test_trained_oetr_kernel_calls_match_plain(cuda, monkeypatch):
    """The trained flagship OETR in bf16 on the card at 256², inside stage
    5's first pass: K2 16 calls and K3 1, every call's output against its
    plain version on the same inputs at the kernel checks' bounds."""
    import chip_smoke

    trees = _trained_trees()
    models, _, _, args = _trained_stage5(cuda, monkeypatch, trees)
    with torch.inference_mode(), chip_smoke.recorded_kernel_calls() as calls:
        models[0](args[4], args[5])
    errs = chip_smoke.recorded_kernel_errors(torch, ops, calls, "trained")
    print(json.dumps(errs))
    assert {k: v["calls"] for k, v in errs.items()} == {
        "linear_encoder_attention": 16, "groupnorm_relu_maxpool": 1}


def test_trained_oetr_f32_card_matches_cpu(cuda, monkeypatch):
    """The trained OETR in f32 (TF32 off) on the card against the port on
    the CPU on 2 scene pairs of 256², at chip_smoke.py's trained-phase
    bounds, beside the CPU's own spread under a one-ulp nudge."""
    import chip_smoke
    from oetr_tpu_torch.interop import convert_flax_params

    trees = _trained_trees()
    _, _, _, args = _trained_stage5(cuda, monkeypatch, trees)
    cfg = port.oetr_r50_kernels_config("float32")
    card = port.build_oetr(cfg, device=cuda)
    card.load_state_dict(convert_flax_params(trees["oetr"], cfg))
    fields, failed = chip_smoke.trained_card_vs_cpu(torch, port, card,
                                                    args[4], args[5])
    print(json.dumps(fields))
    assert not failed, failed


def test_trained_stage5_switches_on_vs_off(cuda, monkeypatch):
    """Stage 5 with the trained weights on 2 pairs of 256², every switch on
    against off: OETR's boxes within the bf16 16 px, used_overlap equal,
    and matches0 at 0.2 equal on >= 99% of the valid keypoints where both
    first passes cropped the same boxes."""
    import chip_smoke

    trees = _trained_trees()
    models, first, m0, args = _trained_stage5(cuda, monkeypatch, trees)
    fields, failed = chip_smoke.trained_on_vs_off(torch, port, trees,
                                                  models, first, m0, args)
    print(json.dumps(fields))
    assert not failed, failed
    assert fields["pairs_same_crops"] >= 1
