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
path, and a small OETR backward with the switches on against off.
"""
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu_torch import ops
from oetr_tpu_torch.ops.sinkhorn import (augment_scores, device_limits,
                                         sinkhorn_plan)

pytestmark = pytest.mark.gpu


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
