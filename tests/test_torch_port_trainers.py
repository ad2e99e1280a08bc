"""The port's matching trainers and FCOS head against the JAX package's, on
the CPU, in float32.

The same seeded numpy inputs go through the JAX function and the port's:
SuperPoint's ``with_logits``, the host batch builders (both sides run cv2),
every loss, the GT builders, both labelers on JAX's own draws, the FCOS
head from converted params, and one step of each train step (SuperPoint
detector, joint and joint with homographic adaptation; SuperGlue; LoFTR
with and without the fine loss; ContextDesc) from converted params on one
batch with ``optax.adam``, and one with the demos' clipped, scheduled
chain. JAX runs jitted with x64 off, as in production.

Bounds:
  batch builders, cell labels, GT    equal (numpy on both sides; the GT
                                     builders' integer outputs and masks)
  with_logits, FCOS head             1e-5 of max(1, |ref|)
  losses, continuous GT              1e-5 relative (of max(1, |ref|) for
                                     arrays)
  labelers on JAX's draws            labels equal outside near-ties: a
                                     cell whose two best scores, or whose
                                     maximum and its image's threshold,
                                     lie within 1e-5 of the map's largest
                                     value is read apart (JAX's XLA and
                                     torch sum the convolutions in other
                                     orders)
  train step: each metric            1e-5 relative (an accuracy's one
                                     hit moves it by far more)
              the gradient norm      1e-4 relative
              each gradient          1e-4 of max(1, its largest |ref|)
              parameters after       2·lr (1e-6 of max(1, |p|) where |g|
                                     is clear of rounding), as OETR's step
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oetr_tpu.data.device_synth import random_homography_device
from oetr_tpu.geometry.boxes import compute_locations as j_locations
from oetr_tpu.models import fcos as jfcos
from oetr_tpu.models import loftr as jloftr
from oetr_tpu.models import sift_based as jsift
from oetr_tpu.models.superglue import SuperGlue as JSuperGlue
from oetr_tpu.models.superpoint import SuperPointNet as JSuperPointNet
from oetr_tpu.training import contextdesc as jcd
from oetr_tpu.training import loftr as jlt
from oetr_tpu.training import superglue as jsg
from oetr_tpu.training import superpoint as jsp
from oetr_tpu_torch import interop
from oetr_tpu_torch.geometry.boxes import compute_locations
from oetr_tpu_torch.models import fcos as pfcos
from oetr_tpu_torch.models.loftr import build_loftr
from oetr_tpu_torch.models.sift_based import build_contextdesc
from oetr_tpu_torch.models.superglue import build_superglue
from oetr_tpu_torch.models.superpoint import build_superpoint_net
from oetr_tpu_torch.ops.sinkhorn import NO_BACKWARD
from oetr_tpu_torch.training import contextdesc as pcd
from oetr_tpu_torch.training import global_grad_norm
from oetr_tpu_torch.training import loftr as plt
from oetr_tpu_torch.training import optim as popt
from oetr_tpu_torch.training import superglue as psg
from oetr_tpu_torch.training import superpoint as psp
from oetr_tpu_torch.training.train import StepScheduler
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

TOL = 1e-5
LR = 1e-3
ADAM_BOUND = 2 * LR          # see tests/test_torch_port_training.py
STEP_G_FLOOR = 1e-2
TIE = 1e-5
HW = 64
SG_KW = dict(descriptor_dim=32, keypoint_encoder_layers=(16, 32),
             gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.2)
LOFTR_KW = dict(d_coarse=32, d_fine=16, coarse_layers=1, fine_layers=1,
                nhead=4, match_threshold=0.0, max_matches=32)
CD_KW = dict(regional_dim=16, hidden=32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, ref, tol=TOL, what=""):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        assert np.array_equal(got, ref), what
        return
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale,
                               err_msg=what)


def _jit(fn, *args):
    with jax.enable_x64(False):
        out = jax.jit(fn)(*jax.tree.map(jnp.asarray, args))
        return jax.tree.map(np.asarray, out)


# ------------------------------------------------------------ superpoint --

def _superpoint(seed, dim=32):
    jnet = JSuperPointNet(descriptor_dim=dim)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0),
                            jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = seeded_params(shapes, seed)
    pnet = build_superpoint_net(device="cpu", descriptor_dim=dim)
    pnet.load_state_dict(interop.convert_superpoint_net_params(
        params, descriptor_dim=dim))
    return jnet, params, pnet


def test_with_logits_matches_flax(rng):
    """scores, descriptors and the 65-way logits at 1e-5; the default
    output is the first two of with_logits', bit for bit."""
    jnet, params, pnet = _superpoint(1)
    img = rng.uniform(0, 1, (2, HW, HW, 1)).astype(np.float32)
    want = _jit(lambda p, x: jnet.apply(p, x, with_logits=True), params, img)
    with torch.no_grad():
        got = pnet(_t(img), with_logits=True)
        plain = pnet(_t(img))
    assert len(got) == 3 and len(plain) == 2
    for g, w, name in zip(got, want, ("scores", "desc", "logits")):
        _close(g, w, TOL, name)
    assert got[2].dtype == torch.float32
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


def test_cell_labels_and_shapes_batch_equal_jax():
    corners = np.array([[[13.0, 5.0], [70.0, 90.0], [-1.0, -1.0]],
                        [[0.4, 0.6], [95.6, 95.4], [50.0, 50.0]]])
    counts = np.array([2, 3])
    assert np.array_equal(psp.corners_to_cell_labels(corners, (96, 96),
                                                     counts),
                          jsp.corners_to_cell_labels(corners, (96, 96),
                                                     counts))
    assert np.array_equal(psp.corners_to_cell_labels(corners, (96, 96)),
                          jsp.corners_to_cell_labels(corners, (96, 96)))
    for seed in (0, 1):
        got = psp.synthetic_shapes_batch(np.random.default_rng(seed), 3, 64)
        want = jsp.synthetic_shapes_batch(np.random.default_rng(seed), 3, 64)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_homography_builders_equal_jax():
    for seed in (0, 1):
        kw = dict(max_rot_deg=10.0, scale_range=(0.8, 1.2))
        assert np.array_equal(
            psp.random_homography(np.random.default_rng(seed), (64, 96),
                                  **kw),
            jsp.random_homography(np.random.default_rng(seed), (64, 96),
                                  **kw))
        got = psp.homography_pairs_batch(np.random.default_rng(seed), 2, 64)
        want = jsp.homography_pairs_batch(np.random.default_rng(seed), 2, 64)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_contextdesc_pairs_batch_equals_jax():
    got = pcd.contextdesc_pairs_batch(np.random.default_rng(3), 2, 64, 32)
    want = jcd.contextdesc_pairs_batch(np.random.default_rng(3), 2, 64, 32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    assert (got["gt_matches0"] >= 0).sum() > 0


def test_superpoint_losses_match_jax(rng):
    """magicpoint_loss and descriptor_hinge_loss (positives present) at
    1e-5 relative; cell_centers exact."""
    logits = rng.normal(size=(2, 4, 5, 65)).astype(np.float32)
    labels = rng.integers(0, 65, (2, 4, 5)).astype(np.int32)
    want = _jit(jsp.magicpoint_loss, logits, labels)
    got = psp.magicpoint_loss(_t(logits), _t(labels))
    np.testing.assert_allclose(_np(got), want, rtol=TOL)

    assert np.array_equal(_np(psp.cell_centers(4, 5)),
                          _jit(lambda: jsp.cell_centers(4, 5)))
    d0 = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    d1 = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    H = np.stack([jsp.random_homography(rng, (HW, HW)) for _ in range(2)])
    H = H.astype(np.float32)
    want = _jit(lambda a, b, h: jsp.descriptor_hinge_loss(a, b, h, (HW, HW)),
                d0, d1, H)
    got = psp.descriptor_hinge_loss(_t(d0), _t(d1), _t(H), (HW, HW))
    np.testing.assert_allclose(_np(got), want, rtol=TOL)


def _jax_ha_homographies(key, n_homo, b, hw):
    """JAX's labeler's homographies [n_homo, B, 3, 3] for ``key``, drawn as
    its scan draws them."""
    with jax.enable_x64(False):
        out = []
        for k in jax.random.split(key, n_homo):
            ks = jax.random.split(k, b)
            out.append(jax.vmap(lambda kk: random_homography_device(
                kk, hw, 20.0, (0.7, 1.4), 0.1))(ks))
        return np.asarray(jnp.stack(out))


def _label_mismatches(got, want, nmsed, max_cells, floor):
    """The cells where the labels differ, split into near-ties (the cell's
    best two scores, or its maximum and the image's threshold, within TIE
    of the map's largest value) and the rest."""
    got, want, nmsed = _np(got), np.asarray(want), _np(nmsed)
    b, hw = nmsed.shape[:2]
    hc = hw // 8
    cells = nmsed.reshape(b, hc, 8, hc, 8).transpose(0, 1, 3, 2, 4)
    cells = np.sort(cells.reshape(b, hc, hc, 64), axis=-1)
    cmax = cells[..., -1]
    kth = np.sort(cmax.reshape(b, -1), axis=-1)[:, -max_cells]
    thr = np.maximum(kth, floor)[:, None, None]
    scale = TIE * max(float(np.abs(nmsed).max()), 1e-30)
    tie = ((cells[..., -1] - cells[..., -2] <= scale)
           | (np.abs(cmax - thr) <= scale))
    diff = got != want
    return int((diff & tie).sum()), int((diff & ~tie).sum()), int(tie.sum())


def test_ha_labeler_on_jax_draws(rng):
    """The port's labels on JAX's own homographies equal JAX's labeler's
    outside near-ties; the draws' split (draw_ha_homographies) gives the
    same shapes and ranges."""
    n_homo, max_cells = 3, 24
    jnet, params, pnet = _superpoint(2)
    gen_key = jax.random.key(5)
    from oetr_tpu.data.device_synth import make_homography_pair_generator
    with jax.enable_x64(False):
        im0 = np.asarray(make_homography_pair_generator(HW, 2)(gen_key)[0])
        labeler = jsp.make_ha_labeler(jnet, HW, n_homo=n_homo,
                                      max_cells=max_cells)
        key = jax.random.key(9)
        want = np.asarray(labeler(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(im0), key))
    Hs = _t(_jax_ha_homographies(key, n_homo, 2, HW))
    got = psp.ha_labels(pnet, _t(im0), Hs, max_cells=max_cells)
    nmsed = psp.ha_scores(pnet, _t(im0), Hs)
    ties, others, _ = _label_mismatches(got, want, nmsed, max_cells, 1e-3)
    assert others == 0, (ties, others)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert ((got != 64).sum() > 5) and ((got != 64).reshape(2, -1).sum(1)
                                        <= max_cells).all()

    drawn = psp.draw_ha_homographies(torch.Generator().manual_seed(0), 4,
                                     3, HW)
    assert drawn.shape == (4, 3, 3, 3)
    labels = psp.make_ha_labeler(pnet, HW, n_homo=2, max_cells=max_cells)(
        _t(im0), torch.Generator().manual_seed(1))
    again = psp.make_ha_labeler(pnet, HW, n_homo=2, max_cells=max_cells)(
        _t(im0), torch.Generator().manual_seed(1))
    assert torch.equal(labels, again)


def test_corner_labeler_matches_jax():
    """Shi-Tomasi labels on the homography generator's images equal JAX's
    outside near-ties."""
    from oetr_tpu.data.device_synth import make_homography_pair_generator
    hw = 128
    with jax.enable_x64(False):
        im0 = np.asarray(make_homography_pair_generator(
            hw, 3, scale_range=(0.7, 1.4))(jax.random.key(3))[0])
        want = np.asarray(jsp.make_corner_labeler(hw, max_cells=64)(
            jnp.asarray(im0)))
    lab = psp.make_corner_labeler(hw, max_cells=64, device="cpu")
    got = lab(_t(im0))
    nmsed = psp.shi_tomasi_scores(_t(im0))
    floor = 0.01 * _np(nmsed).reshape(3, -1).max(-1)
    ties, others, _ = _label_mismatches(got, want, nmsed, 64, floor)
    assert others == 0, (ties, others)
    assert ((got != 64).reshape(3, -1).sum(1) > 16).all()
    with pytest.raises(ValueError):
        lab(_t(im0[:, :64, :64]))


def _mu_grads(opt_state):
    """The gradients of a first Adam step: its first moment over 1 - b1."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                                leaf.mu)
    raise AssertionError("no Adam state")


def _jax_step(make_step, jmodel, params, args, tx=None):
    """One jitted JAX step from ``params``: (metrics, params after, the
    step's gradients)."""
    tx = tx or optax.adam(LR)
    with jax.enable_x64(False):
        jp = jax.tree.map(jnp.asarray, params)
        step = make_step(jmodel, tx)
        new, opt_state, metrics = step(jp, tx.init(jp), *args)
        return (jax.tree.map(np.asarray, metrics),
                jax.tree.map(np.asarray, new), _mu_grads(opt_state))


def _check_step(model, metrics, want, jnew, jgrads, convert):
    """The port's step against JAX's: metrics, gradients, their norm and
    the parameters after the update, at the module docstring's bounds."""
    assert sorted(metrics) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(metrics[k]), want[k], rtol=TOL,
                                   atol=0, err_msg=k)
    ref_g = convert(jgrads)
    ref_p = convert(jnew)
    g_norm = float(global_grad_norm(model))
    j_norm = torch.sqrt(sum((v.double() ** 2).sum()
                            for v in ref_g.values())).item()
    assert abs(g_norm - j_norm) <= 1e-4 * j_norm, (g_norm, j_norm)
    for name, p in model.named_parameters():
        g, rg = p.grad, ref_g[name]
        _close(g, rg, 1e-4, name)
        diff = (p.detach() - ref_p[name]).abs()
        assert (diff <= ADAM_BOUND + 1e-6 * ref_p[name].abs()).all(), name
        firm = rg.abs() > max(STEP_G_FLOOR * rg.abs().max().item(), 1e-6)
        assert (diff[firm] <= 1e-6 * torch.clamp(
            ref_p[name].abs()[firm], min=1.0)).all(), name


def _adam(model):
    return torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8)


def _sp_batches(seed, b=2):
    rng = np.random.default_rng(seed)
    imgs, corners, counts = jsp.synthetic_shapes_batch(rng, b, HW)
    labels = jsp.corners_to_cell_labels(corners, (HW, HW), counts)
    im0, im1, H = jsp.homography_pairs_batch(rng, b, HW)
    return imgs, labels, im0, im1, H.astype(np.float32)


@pytest.mark.parametrize("kind", ["detector", "joint", "joint_ha",
                                  "joint_ha_clipped"])
def test_superpoint_steps_match_jax(kind):
    """One step of each SuperPoint train step from converted params; the
    last with optax.chain(clip_by_global_norm, adam(piecewise schedule)),
    the demos' transform, against the port's clip and StepScheduler."""
    jnet, params, pnet = _superpoint(3)
    imgs, labels, im0, im1, H = _sp_batches(4)
    ha = jsp.make_corner_labeler(HW, max_cells=16)
    with jax.enable_x64(False):
        ha_lab = np.asarray(ha(jnp.asarray(im0)))
    tx, sched, clip = None, None, None
    if kind == "detector":
        args = (imgs, labels)
        jmake, pmake = jsp.make_superpoint_train_step, \
            psp.make_superpoint_train_step
    elif kind == "joint":
        args = (imgs, labels, im0, im1, H)
        jmake, pmake = jsp.make_superpoint_joint_train_step, \
            psp.make_superpoint_joint_train_step
    else:
        args = (imgs, labels, im0, im1, H, ha_lab, np.float32(0.5))
        jmake, pmake = jsp.make_superpoint_joint_ha_train_step, \
            psp.make_superpoint_joint_ha_train_step
    if kind == "joint_ha_clipped":
        steps = 1
        bounds = {int(0.7 * steps): 0.1}
        clip = 0.05
        tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(
            optax.piecewise_constant_schedule(LR / 0.1, bounds)))
        sched = popt.piecewise_constant_schedule(LR / 0.1, bounds)
    jargs = [jnp.asarray(a) for a in args]
    want, jnew, jgrads = _jax_step(jmake, jnet, params, jargs, tx)
    opt = _adam(pnet)
    scheduler = StepScheduler(opt, sched) if sched else None
    step = pmake(pnet, opt, scheduler=scheduler, clip_norm=clip)
    metrics = step(*[_t(a) if isinstance(a, np.ndarray) else a
                     for a in args])
    if clip is not None:
        assert float(global_grad_norm(pnet)) <= clip * (1 + 1e-5)
        assert scheduler.count == 1
    _check_step(pnet, metrics, want, jnew, jgrads,
                lambda tree: interop.convert_superpoint_net_params(
                    tree, descriptor_dim=32))


def test_clip_and_schedule_follow_optax(rng):
    """clip_by_global_norm_ scales as optax (g / norm · max only at norm
    >= max) and the schedule gives optax's float32 rates."""
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        want = _jit(lambda g: optax.clip_by_global_norm(max_norm).update(
            g, None)[0], grads)
        got = [_t(g.copy()) for g in grads]
        norm = popt.clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), w, rtol=1e-6, atol=0)
        np.testing.assert_allclose(_np(norm), np.sqrt(sum(
            (g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
    bounds = {7: 0.1, 3: 0.5}
    jsched = optax.piecewise_constant_schedule(3e-4, bounds)
    psched = popt.piecewise_constant_schedule(3e-4, bounds)
    with jax.enable_x64(False):
        for count in range(10):
            assert np.float32(psched(count)) == np.float32(jsched(count))


# ------------------------------------------------------------- superglue --

def _sg_problem(rng, b=2, k=24, d=32):
    desc0 = rng.normal(size=(b, k, d)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = np.stack([rng.permutation(k) for _ in range(b)])
    desc1 = np.take_along_axis(desc0, perm[..., None], axis=1)
    desc1 = desc1 + 0.15 * rng.normal(size=desc1.shape).astype(np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    gt = np.empty((b, k), np.int32)
    for i in range(b):
        gt[i, perm[i]] = np.arange(k)
        gt[i, perm[i][16:]] = -1
    v0, v1 = rng.random((b, k)) > 0.1, rng.random((b, k)) > 0.1
    # GT only between valid keypoints, as gt_matches_batch gives it.
    gt = np.where(v0 & np.take_along_axis(v1, np.maximum(gt, 0), 1), gt, -1)
    return {"keypoints0": rng.uniform(0, 100, (b, k, 2)).astype(np.float32),
            "keypoints1": rng.uniform(0, 100, (b, k, 2)).astype(np.float32),
            "descriptors0": desc0, "descriptors1": desc1.astype(np.float32),
            "scores0": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "scores1": rng.uniform(0, 1, (b, k)).astype(np.float32),
            "valid0": v0, "valid1": v1, "gt_matches0": gt.astype(np.int32)}


def _sg_models(seed, batch, **kw):
    jsg_model = JSuperGlue(**SG_KW)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "gt_matches0"}
    hw = dict(image_hw0=(128, 128), image_hw1=(128, 128))
    shapes = jax.eval_shape(lambda key, d: jsg_model.init(key, {**d, **hw}),
                            jax.random.key(0), jb)
    params = seeded_params(shapes, seed, shrink=("mlp2",))
    pm = build_superglue(device="cpu", **SG_KW, **kw)
    pm.load_state_dict(interop.convert_superglue_params(params, **SG_KW))
    return jsg_model, params, pm


def test_superglue_nll_loss_matches_jax(rng):
    la = rng.normal(size=(2, 7, 9)).astype(np.float32)
    gt = np.array([[0, -1, 3, 3, 7, -1], [1, 2, -1, 4, 5, 6]], np.int32)
    v0 = rng.random((2, 6)) > 0.2
    v1 = rng.random((2, 8)) > 0.2
    want = _jit(jsg.superglue_nll_loss, la, gt, v0, v1)
    got = psg.superglue_nll_loss(_t(la), _t(gt), _t(v0), _t(v1))
    np.testing.assert_allclose(_np(got), want, rtol=TOL)


def _scene_geometry(rng, b, k, hw):
    """Keypoints on two views of a tilted plane with their depths."""
    K = np.array([[80.0, 0, hw / 2], [0, 80.0, hw / 2], [0, 0, 1]],
                 np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    depth0 = (5.0 + 0.01 * xx + 0.02 * yy)[None].repeat(b, 0)
    depth0[:, :4, :4] = 0.0                       # a hole without depth
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, 0, 3] = rng.uniform(-0.3, 0.3, b)
    T[:, 2, 3] = rng.uniform(-0.2, 0.2, b)
    xy0 = rng.uniform(0, hw - 1, (b, k, 2)).astype(np.float32)
    return K[None].repeat(b, 0), depth0, T, xy0


def test_gt_builders_match_jax(rng):
    """gt_matches_batch (with and without depth1) and
    warp_cell_centers_batch: matches and masks equal, positions 1e-5."""
    b, k, hw = 2, 40, 48
    K, depth0, T, xy0 = _scene_geometry(rng, b, k, hw)
    warped = _jit(lambda *a: jlt.warp_cell_centers_batch(*a), xy0, depth0,
                  K, T, K)
    xy1 = warped[0] + rng.normal(0, 1.0, warped[0].shape).astype(np.float32)
    xy1 = xy1[:, rng.permutation(k)]
    v0 = rng.random((b, k)) > 0.1
    v1 = rng.random((b, k)) > 0.1
    depth1 = depth0 - 0.1
    for d1 in (None, depth1):
        want = _jit(lambda *a: jsg.gt_matches_batch(*a[:8], depth1=a[8]),
                    xy0, v0, xy1, v1, depth0, K, T, K, d1)
        got = psg.gt_matches_batch(_t(xy0), _t(v0), _t(xy1), _t(v1),
                                   _t(depth0), _t(K), _t(T), _t(K),
                                   None if d1 is None else _t(d1))
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), want)
        assert (want >= 0).sum() > 5
        wxy, wv = _jit(lambda *a: jlt.warp_cell_centers_batch(
            *a[:5], depth1=a[5]), xy0, depth0, K, T, K, d1)
        gxy, gv = plt.warp_cell_centers_batch(
            _t(xy0), _t(depth0), _t(K), _t(T), _t(K),
            None if d1 is None else _t(d1))
        assert np.array_equal(_np(gv), wv)
        _close(gxy[gv], wxy[wv], TOL, "warp")


def _sg_args(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb.update(image_hw0=(128, 128), image_hw1=(128, 128))
    pb = {k: _t(v) for k, v in batch.items()}
    pb.update(image_hw0=(128, 128), image_hw1=(128, 128))
    return jb, pb


def test_superglue_step_matches_jax(rng):
    batch = _sg_problem(rng)
    jm, params, pm = _sg_models(11, batch)
    jb, pb = _sg_args(batch)
    want, jnew, jgrads = _jax_step(jsg.make_superglue_train_step, jm, params,
                                   (jb,))
    metrics = psg.make_superglue_train_step(pm, _adam(pm))(pb)
    _check_step(pm, metrics, want, jnew, jgrads,
                lambda tree: interop.convert_superglue_params(tree, **SG_KW))


def test_superglue_step_refuses_the_sinkhorn_kernel(rng):
    """With the K4 switch on the step raises K4's error before the forward
    and leaves the weights as they were; the plain model trains."""
    batch = _sg_problem(rng)
    _, _, pm = _sg_models(12, batch, cuda_sinkhorn=True)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    step = psg.make_superglue_train_step(pm, _adam(pm))
    _, pb = _sg_args(batch)
    with pytest.raises(RuntimeError, match="no backward") as err:
        step(pb)
    assert str(err.value) == NO_BACKWARD
    assert all(torch.equal(v, before[k]) for k, v in pm.state_dict().items())
    pm.cuda_sinkhorn = False
    assert torch.isfinite(step(pb)["loss"])


# ----------------------------------------------------------------- loftr --

def _loftr_models(seed):
    jm = jloftr.LoFTR(**LOFTR_KW)
    z = jnp.zeros((1, HW, HW, 1), jnp.float32)
    params = seeded_params(jax.eval_shape(jm.init, jax.random.key(0), z, z),
                           seed)
    pm = build_loftr(device="cpu", **LOFTR_KW)
    pm.load_state_dict(interop.convert_loftr_params(params, **LOFTR_KW))
    return jm, params, pm


def _shift_pair(rng, b=2):
    """image 1 = image 0 shifted 8 px right; GT from shift_pair_gt and the
    shifted cell centres (LoFTR's idx·8 + 4)."""
    small = rng.uniform(0, 1, (b, HW // 4, HW // 4, 1))
    im0 = np.repeat(np.repeat(small, 4, axis=1), 4, axis=2)
    im0 = np.clip(im0 + 0.05 * rng.normal(size=im0.shape), 0, 1)
    im1 = np.zeros_like(im0)
    im1[:, :, 8:] = im0[:, :, :-8]
    gt = np.repeat(np.asarray(jlt.shift_pair_gt((HW, HW), (8, 0))), b, 0)
    hc = HW // 8
    yy, xx = np.mgrid[0:hc, 0:hc]
    xy = np.stack([xx.ravel() * 8 + 4.0 + 8.0, yy.ravel() * 8 + 4.0], -1)
    gt_xy1 = np.repeat(xy[None], b, 0).astype(np.float32)
    gt_valid1 = np.repeat((xy[:, 0] < HW)[None], b, 0)
    return (im0.astype(np.float32), im1.astype(np.float32),
            gt.astype(np.int32), gt_xy1, gt_valid1)


def test_loftr_losses_and_shift_gt_match_jax(rng):
    """shift_pair_gt exact; loftr_coarse_loss 1e-5; loftr_fine_loss and its
    supervised share 1e-5 on the model's output, with a mask that
    supervises some proposals and not others."""
    for shift in ((8, 0), (-16, 8), (0, -24)):
        assert np.array_equal(_np(plt.shift_pair_gt((48, 64), shift)),
                              np.asarray(jlt.shift_pair_gt((48, 64), shift)))
    conf = rng.uniform(0, 1, (2, 12, 12)).astype(np.float32)
    gt = rng.integers(-1, 12, (2, 12)).astype(np.int32)
    want = _jit(jlt.loftr_coarse_loss, conf, gt)
    np.testing.assert_allclose(_np(plt.loftr_coarse_loss(_t(conf), _t(gt))),
                               want, rtol=TOL)

    jm, params, pm = _loftr_models(21)
    im0, im1, gt, gt_xy1, gt_valid1 = _shift_pair(rng)
    gt_xy1 = gt_xy1 + rng.normal(0, 2.0, gt_xy1.shape).astype(np.float32)
    with torch.no_grad():
        out = pm(_t(im0), _t(im1))
    jout = {k: np.asarray(_np(v)) for k, v in out.items()}
    want = _jit(jlt.loftr_fine_loss, jout, gt, gt_xy1, gt_valid1)
    got = plt.loftr_fine_loss(out, _t(gt), _t(gt_xy1), _t(gt_valid1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=TOL)
    assert 0 < float(got[1]) < float(_np(out["valid"]).mean())


@pytest.mark.parametrize("fine_weight", [0.0, 1.0])
def test_loftr_step_matches_jax(rng, fine_weight):
    jm, params, pm = _loftr_models(22)
    im0, im1, gt, gt_xy1, gt_valid1 = _shift_pair(rng)
    args = (im0, im1, gt) + ((gt_xy1, gt_valid1) if fine_weight else ())
    want, jnew, jgrads = _jax_step(
        lambda m, tx: jlt.make_loftr_train_step(m, tx, fine_weight), jm,
        params, [jnp.asarray(a) for a in args])
    step = plt.make_loftr_train_step(pm, _adam(pm), fine_weight)
    metrics = step(*[_t(a) for a in args])
    if fine_weight:
        assert float(metrics["fine_frac"]) > 0
    _check_step(pm, metrics, want, jnew, jgrads,
                lambda tree: interop.convert_loftr_params(tree, **LOFTR_KW))


def test_loftr_fine_step_without_gt_fails_inside(rng):
    """JAX's quirk, copied: a fine step called without gt_xy1 is not
    refused up front; it fails inside the fine loss."""
    _, _, pm = _loftr_models(23)
    im0, im1, gt, _, _ = _shift_pair(rng)
    step = plt.make_loftr_train_step(pm, _adam(pm), 1.0)
    with pytest.raises((TypeError, AttributeError)):
        step(_t(im0), _t(im1), _t(gt))


# ----------------------------------------------------------- contextdesc --

def test_contextdesc_losses_match_jax(rng):
    d0 = rng.normal(size=(2, 10, 8)).astype(np.float32)
    d1 = rng.normal(size=(2, 10, 8)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    gt = rng.integers(-1, 10, (2, 10)).astype(np.int32)
    v0 = rng.random((2, 10)) > 0.2
    v1 = rng.random((2, 10)) > 0.2
    m = rng.uniform(0, 1, (2, 10)).astype(np.float32)
    m[0, 0], m[0, 1] = 0.0, 1.0                    # the clip's ends
    np.testing.assert_allclose(
        _np(pcd.contextdesc_info_nce(_t(d0), _t(d1), _t(gt), _t(v1))),
        _jit(jcd.contextdesc_info_nce, d0, d1, gt, v1), rtol=TOL)
    np.testing.assert_allclose(
        _np(pcd.matchability_bce(_t(m), _t(gt), _t(v0))),
        _jit(jcd.matchability_bce, m, gt, v0), rtol=TOL)


def test_contextdesc_step_matches_jax():
    batch = jcd.contextdesc_pairs_batch(np.random.default_rng(5), 2, HW, 32)
    jnet = jsift.ContextDesc(**CD_KW)
    args = [jnp.asarray(batch[k]) for k in ("image0", "desc0", "xy0",
                                            "scores0", "valid0")]
    params = seeded_params(jax.eval_shape(jnet.init, jax.random.key(0),
                                          *args), 41)
    pnet = build_contextdesc(device="cpu", **CD_KW)
    pnet.load_state_dict(interop.convert_contextdesc_params(params, **CD_KW))
    want, jnew, jgrads = _jax_step(
        jcd.make_contextdesc_train_step, jnet, params,
        ({k: jnp.asarray(v) for k, v in batch.items()},))
    step = pcd.make_contextdesc_train_step(pnet, _adam(pnet))
    metrics = step({k: _t(v) for k, v in batch.items()})
    _check_step(pnet, metrics, want, jnew, jgrads,
                lambda tree: interop.convert_contextdesc_params(tree, **CD_KW))


# ------------------------------------------------------------------ fcos --

def test_fcos_head_matches_jax(rng):
    """The head from converted params at 1e-5 (towers, prior bias, exp box
    distances), Scale, and build_fcos_head's initial values."""
    jh = jfcos.FCOSHead(in_channels=64)
    x = rng.normal(size=(2, 6, 7, 64)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jh.init, jax.random.key(0),
                                          jnp.asarray(x)), 51)
    ph = pfcos.build_fcos_head(device="cpu", in_channels=64)
    ph.load_state_dict(interop.convert_fcos_params(params, in_channels=64))
    want = _jit(jh.apply, params, x)
    with torch.no_grad():
        got = ph(_t(x))
    for g, w, name in zip(got, want, ("logits", "bbox", "centerness")):
        _close(g, w, TOL, name)

    fresh = pfcos.build_fcos_head(device="cpu", in_channels=64)
    jinit = jh.init(jax.random.key(0), jnp.asarray(x))["params"]
    np.testing.assert_allclose(_np(fresh.cls_logits.bias),
                               np.asarray(jinit["cls_logits"]["bias"]),
                               rtol=1e-6)
    assert fresh.scales.weight.item() == 1.0
    assert all(p.requires_grad for p in fresh.parameters())

    dyn = jfcos.DynamicConv(hidden_dim=8)
    f = rng.normal(size=(2, 5, 6)).astype(np.float32)
    pf = rng.normal(size=(2, 6, 7)).astype(np.float32)
    dparams = seeded_params(jax.eval_shape(dyn.init, jax.random.key(0),
                                           jnp.asarray(f), jnp.asarray(pf)),
                            52)
    pd = pfcos.DynamicConv(8, 5, 7)
    from oetr_tpu_torch.interop.from_flax import _state_dict
    from oetr_tpu_torch.models.layers import materialize
    pd = materialize(pd, "cpu", None)
    pd.load_state_dict(_state_dict(dparams["params"], pd))
    with torch.no_grad():
        _close(pd(_t(f), _t(pf)), _jit(dyn.apply, dparams, f, pf), TOL,
               "DynamicConv")


def test_fcos_losses_match_jax(rng):
    """The focal losses, centerness targets, fcos_targets (labels equal,
    targets 1e-5) and fcos_losses at 1e-5 relative, with a box whose
    centre region is cut by the image and one that covers it."""
    logits = rng.normal(size=(50,)).astype(np.float32) * 3
    tgt = (rng.random(50) > 0.7).astype(np.float32)
    _close(pfcos.sigmoid_focal_loss(_t(logits), _t(tgt)),
           _jit(jfcos.sigmoid_focal_loss, logits, tgt), TOL, "sigmoid")
    _close(pfcos.sigmoid_focal_loss(_t(logits), _t(tgt), alpha=-1.0),
           _jit(lambda a, b: jfcos.sigmoid_focal_loss(a, b, alpha=-1.0),
                logits, tgt), TOL, "sigmoid, no alpha")
    lg = rng.normal(size=(20, 5)).astype(np.float32)
    lab = rng.integers(0, 5, 20).astype(np.int32)
    _close(pfcos.softmax_focal_loss(_t(lg), _t(lab)),
           _jit(jfcos.softmax_focal_loss, lg, lab), TOL, "softmax")
    reg = np.abs(rng.normal(size=(30, 4))).astype(np.float32) * 10
    _close(pfcos.compute_centerness_targets(_t(reg)),
           _jit(jfcos.compute_centerness_targets, reg), TOL, "centerness")

    h = w = 8
    locs = _np(compute_locations(h, w, 16))
    assert np.array_equal(locs, np.asarray(j_locations(h, w, 16)))
    boxes = np.array([[8.0, 8.0, 56.0, 56.0], [0.0, 0.0, 128.0, 128.0],
                      [70.0, 20.0, 125.0, 60.0]], np.float32)
    for kw in ({}, {"center_sampling_radius": 0.0},
               {"norm_reg_targets": True}):
        wl, wr = _jit(lambda a, b: jfcos.fcos_targets(a, b, **kw), locs,
                      boxes)
        gl, gr = pfcos.fcos_targets(_t(locs), _t(boxes), **kw)
        assert np.array_equal(_np(gl), wl)
        _close(gr, wr, TOL, "reg targets")
    b = boxes.shape[0]
    cls = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    breg = np.abs(rng.normal(size=(b, h, w, 4))).astype(np.float32) * 20 + 1
    cent = rng.normal(size=(b, h, w, 1)).astype(np.float32)
    want = _jit(jfcos.fcos_losses, locs, cls, breg, cent, boxes)
    got = pfcos.fcos_losses(_t(locs), _t(cls), _t(breg), _t(cent),
                            _t(boxes))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=TOL, err_msg=k)
    assert want["num_pos"] > 0
