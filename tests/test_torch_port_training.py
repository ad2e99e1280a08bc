"""The port's OETR trainer against the JAX package's, on the CPU, in float32.

The same seeded numpy inputs go through the JAX function and the port's:
every box function, every loss (value and gradient), the learning-rate
schedule, one train step from JAX's params (converted with
``interop.convert_flax_params``), ``with_cycle``, ``evaluate``, the
MegaDepth dataset on a scene tree written by the JAX package, and the
port's command line. JAX runs jitted with x64 off, as in production.

Dropout cannot share flax's masks, so the step is held to JAX with
dropout off on both sides (flax's ``Dropout.__call__`` patched to the
identity here, the port's rate set to 0); the port's dropout is tested on
its own terms.

Bounds:
  box functions, loss values            1e-5 of max(1, |ref|); integer
                                        outputs and masks equal
  loss gradients                        1e-5 of max(1, the largest |ref|)
  schedule                              the float32 rates equal
  train step: each loss entry           1e-5 relative
              the gradient norm         1e-4 relative
              each parameter gradient   1e-4 of max(1, its largest |ref|)
              parameters after          ADAM_BOUND (below)
  with_cycle centres                    5e-3 px (as the forward's boxes)
  evaluate                              mean IoU 1e-5; recalls equal
  dataset samples and batches           equal
  checkpoint resume                     bit-equal
"""
import os
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oetr_tpu_torch as port
from oetr_tpu.config import BackboneConfig, NeckConfig, OETRConfig
from oetr_tpu.config import TrainConfig as JTrainConfig
from oetr_tpu.data import megadepth as jmd
from oetr_tpu.data.synthetic import generate_scene
from oetr_tpu.geometry import boxes as jb
from oetr_tpu.models import build_oetr
from oetr_tpu.training import losses as jl
from oetr_tpu.training import train as jt
from oetr_tpu.training import validation as jv
from oetr_tpu_torch.data import megadepth as pmd
from oetr_tpu_torch.geometry import boxes as pb
from oetr_tpu_torch.interop import convert_flax_params, read_checkpoint
from oetr_tpu_torch.models.transformer import Dropout
from oetr_tpu_torch.training import losses as pl
from oetr_tpu_torch.training import train as ptr
from oetr_tpu_torch.training import validation as pv
from test_torch_port_oetr import seeded_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
HW = 64
LR = 1e-4
# Parameters after one AdamW step. Adam's first update is g / (|g| + eps)
# per entry, about sign(g): where two runs' gradients differ by rounding
# only, it moves an entry by lr either way, and where |g| is within
# rounding of 0 the two runs can move it in opposite directions, 2·lr
# apart. So every entry within 2·lr (plus 1e-6 of |p| for the products'
# rounding), and where |g| is above STEP_G_FLOOR of the parameter's
# largest |g| (far above the gradients' 1e-4 agreement) within 1e-6 of
# max(1, |p|): there both runs take the same sign and the same size
# (and above 1e-6 absolute, far above Adam's eps of 1e-8).
ADAM_BOUND = 2 * LR
STEP_G_FLOOR = 1e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, ref, tol=TOL, what=""):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
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


# ------------------------------------------------------------- boxes --

def _boxes(rng, n=6, lo=-10.0, hi=70.0):
    a = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(0.0, 40.0, (n, 2))
    return np.concatenate([a, a + wh], -1).astype(np.float32)


BOX_CASES = {
    "cxywh_to_xyxy": lambda m, a, b: m.box_cxywh_to_xyxy(a, 50.0, 60.0),
    "xyxy_to_cxywh": lambda m, a, b: m.box_xyxy_to_cxywh(a, 50.0, 60.0),
    "xywh_to_xyxy": lambda m, a, b: m.box_xywh_to_xyxy(a),
    "overlaps_iou": lambda m, a, b: m.bbox_overlaps_aligned(a, b),
    "overlaps_iof": lambda m, a, b: m.bbox_overlaps_aligned(a, b, "iof"),
    "pairwise_iou": lambda m, a, b: m.bbox_overlaps_pairwise(a, b[:4]),
    "pairwise_iof": lambda m, a, b: m.bbox_overlaps_pairwise(a, b[:4], "iof"),
    "oiou": lambda m, a, b: m.bbox_oiou(a, b),
    "iou_loss": lambda m, a, b: m.iou_loss(a, b),
    "oiou_loss": lambda m, a, b: m.oiou_loss(a, b),
    "giou_loss": lambda m, a, b: m.giou_loss(a, b),
    "pair_overlap_loss": lambda m, a, b: m.pair_overlap_loss(a, b, b, a),
    "pair_overlap_loss_oiou": lambda m, a, b: m.pair_overlap_loss(
        a, b, b, a, oiou=True),
    "delta2bbox": lambda m, a, b: m.delta2bbox(a, (b - 30.0) / 20.0,
                                               (0.1, 0.0, 0.0, 0.1),
                                               (1.0, 1.0, 0.5, 0.5)),
    "delta2bbox_max_shape": lambda m, a, b: m.delta2bbox(
        a, (b - 30.0) / 20.0, max_shape=(50, 60)),
}


@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_box_functions_match_jax(name):
    rng = np.random.default_rng(sorted(BOX_CASES).index(name))
    a, b = _boxes(rng), _boxes(rng)
    a[0] = b[0]                     # identical boxes
    a[1, 2:] = a[1, :2]             # a degenerate box
    fn = BOX_CASES[name]
    want = _jit(lambda x, y: fn(jb, x, y), a, b)
    _close(fn(pb, _t(a), _t(b)), want, what=name)


def test_compute_locations_and_mask2bbox_match_jax():
    _close(pb.compute_locations(3, 5, 16), jb.compute_locations(3, 5, 16))
    _close(pb.compute_locations(4, 2, 8), jb.compute_locations(4, 2, 8))
    mask = np.random.default_rng(3).random((4, 9, 11)) > 0.93
    mask[2] = False                 # no pixel: a zero box
    mask[3] = False
    mask[3, 4, 7] = True            # a single pixel
    _close(pb.mask2bbox(_t(mask)), _jit(jb.mask2bbox, mask))


# ------------------------------------------------------------ losses --

def _geometry(seed, b=3, hw=HW):
    """Scene geometry from the port's generator (numpy), with depth noise
    and holes so that the depth validity tests matter."""
    gen = port.make_device_generator(hw, b, scale_range=(1.2, 2.5),
                                     p_translate=0.4, device="cpu")
    d = {k: _np(v) for k, v in gen(torch.Generator().manual_seed(seed))
         .items()}
    rng = np.random.default_rng(seed)
    for side in ("1", "2"):
        depth = d["depth" + side] * (1 + 0.01 * rng.normal(size=(b, hw, hw)))
        depth[:, 5:20, 30:45] = 0.0
        d["depth" + side] = depth.astype(np.float32)
    d["overlap_valid"] = np.array([True, True, False])[:b]
    return d


def _outputs(seed, b=3, n=16, c=8, hw=HW):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("1", "2"):
        out["pred_bbox" + side] = _boxes(rng, b, 0.0, hw - 20.0)
        out["center" + side] = rng.uniform(10, hw - 10, (b, 2))
        out["tlbr" + side] = rng.uniform(0.05, 0.6, (b, 4))
        logits = rng.normal(size=(b, n))
        out["prob_map" + side] = np.exp(logits) / np.exp(logits).sum(
            -1, keepdims=True)
        out["mem" + side] = rng.normal(size=(b, n, c))
        out["cycle_center" + side] = rng.uniform(10, hw - 10, (b, 2))
    return {k: v.astype(np.float32) for k, v in out.items()}


GEOM = ("K1", "depth1", "pose1", "crop1", "ratio1", "K2", "depth2", "pose2",
        "crop2", "ratio2")


def _oetr_loss_case(oiou, weighted, cycle):
    def run(m, outputs, batch):
        if not cycle:
            outputs = {k: v for k, v in outputs.items() if "cycle" not in k}
        wts = (m.difficulty_weights(batch["overlap_box1"],
                                    batch["overlap_box2"], (HW, HW), (HW, HW),
                                    power=1.5) if weighted else None)
        return m.oetr_losses(outputs, batch["overlap_box1"],
                             batch["overlap_box2"], batch["overlap_valid"],
                             (HW, HW), (HW, HW), oiou=oiou, weights=wts)
    return run, ("pred_bbox1", "pred_bbox2", "cycle_center1",
                 "cycle_center2")


def _cycle_overlap(m, outputs, batch):
    return m.cycle_overlap_loss(outputs["pred_bbox1"], outputs["pred_bbox2"],
                                *(batch[k] for k in GEOM),
                                batch["overlap_valid"])


def _heatmap(m, outputs, batch):
    return m.heatmap_ce_loss(outputs["prob_map1"], batch["overlap_box1"],
                             batch["overlap_valid"], (HW, HW),
                             weights=batch["wts"])


def _size(m, outputs, batch):
    return m.size_loss(outputs, batch["overlap_box1"], batch["overlap_box2"],
                       batch["overlap_valid"], (HW, HW), (HW, HW),
                       weights=batch["wts"])


def _aux(m, outputs, batch):
    return m.aux_match_loss(outputs, batch, 16)


def _infonce(m, outputs, batch):
    gt = batch["gt"]
    return m.token_infonce_loss(outputs["mem1"], outputs["mem2"], gt,
                                gt >= 1)


# name -> (function of (module, outputs, batch), the output keys whose
# gradients are compared)
LOSS_CASES = {
    "oetr_losses": _oetr_loss_case(False, False, False),
    "oetr_losses_oiou_weighted_cycle": _oetr_loss_case(True, True, True),
    "cycle_overlap_loss": (_cycle_overlap, ("pred_bbox1", "pred_bbox2")),
    "heatmap_ce_loss": (_heatmap, ("prob_map1",)),
    "size_loss": (_size, ("tlbr1", "tlbr2", "center1", "center2")),
    "aux_match_loss": (_aux, ("mem1", "mem2")),
    "token_infonce_loss": (_infonce, ("mem1", "mem2")),
}


def _loss_batch(seed):
    batch = _geometry(seed)
    image = np.zeros((3, HW, HW, 3), np.float32)
    batch["image1"] = batch["image2"] = image
    batch["wts"] = np.array([0.5, 1.5, 1.0], np.float32)
    batch["gt"] = np.random.default_rng(seed).integers(
        -1, 16, (3, 16)).astype(np.int32)
    # A tiny ground-truth box holds no token centre: the one-hot target.
    batch["overlap_box1"][1] = [30.0, 30.0, 31.0, 31.0]
    return {k: v for k, v in batch.items() if k != "scale"}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    fn, wrt = LOSS_CASES[name]
    seed = 20 + sorted(LOSS_CASES).index(name)
    outputs, batch = _outputs(seed), _loss_batch(seed)
    total = lambda r: (jl.total_loss(r) if isinstance(r, dict) else r)

    def jax_fn(o, bt):
        return jax.value_and_grad(
            lambda x: total(fn(jl, {**o, **x}, bt)))(
                {k: o[k] for k in wrt}), fn(jl, o, bt)

    with jax.enable_x64(False):
        (jval, jgrad), jparts = jax.jit(jax_fn)(
            jax.tree.map(jnp.asarray, outputs),
            jax.tree.map(jnp.asarray, batch))
    leaves = {k: _t(v).requires_grad_(k in wrt) for k, v in outputs.items()}
    parts = fn(pl, leaves, {k: _t(v) for k, v in batch.items()})
    value = total(parts)
    value.backward()
    _close(value, jval, what=name)
    if isinstance(parts, dict):
        assert sorted(parts) == sorted(jparts)
        for k in parts:
            _close(parts[k], jparts[k], what=k)
    for k in wrt:   # no gradient reached: JAX's is zero
        g = leaves[k].grad
        _close(torch.zeros_like(leaves[k]) if g is None else g, jgrad[k],
               what=f"d/d{k}")


GEOMETRY_CASES = {
    "interpolate_depth": (
        lambda m, d, uv: m.interpolate_depth(d["depth2"], uv),
        lambda d, uv: jax.vmap(jl.interpolate_depth)(d["depth2"], uv)),
    "warped_box_via_depth": (
        lambda m, d, uv: m.warped_box_via_depth(
            d["box"], *(d[k] for k in GEOM)),
        lambda d, uv: jax.vmap(jl.warped_box_via_depth)(
            d["box"], *(d[k] for k in GEOM))),
    "token_matches": (
        lambda m, d, uv: m.token_matches_from_geometry(
            *(d[k] for k in GEOM if k != "depth2"), (HW, HW), 16),
        lambda d, uv: jax.vmap(lambda *a: jl.token_matches_from_geometry(
            *a, (HW, HW), 16))(*(d[k] for k in GEOM if k != "depth2"))),
    "token_matches_occlusion": (
        lambda m, d, uv: m.token_matches_from_geometry(
            *(d[k] for k in GEOM if k != "depth2"), (HW, HW), 8,
            depth2=d["depth2"]),
        lambda d, uv: jax.vmap(lambda *a: jl.token_matches_from_geometry(
            *a[:-1], (HW, HW), 8, depth2=a[-1]))(
                *(d[k] for k in GEOM if k != "depth2"), d["depth2"])),
    "difficulty_weights": (
        lambda m, d, uv: m.difficulty_weights(d["overlap_box1"], d["box"],
                                              (HW, HW), (48, 80), 2.0),
        lambda d, uv: jl.difficulty_weights(d["overlap_box1"], d["box"],
                                            (HW, HW), (48, 80), 2.0)),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY_CASES))
def test_loss_geometry_matches_jax(name):
    port_fn, jax_fn = GEOMETRY_CASES[name]
    d = _geometry(40)
    rng = np.random.default_rng(41)
    d["box"] = _boxes(rng, 3, 0.0, HW - 24.0)
    uv = rng.uniform(-3, HW + 2, (3, 50, 2)).astype(np.float32)
    uv[:, 0] = [10.0, 12.0]                 # on a pixel
    d = {k: v for k, v in d.items() if k != "scale"}
    want = _jit(jax_fn, d, uv)
    got = port_fn(pl, {k: _t(v) for k, v in d.items()}, _t(uv))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w, what=name)


# ---------------------------------------------------------- schedule --

def test_schedule_matches_optax():
    for milestones, spe in (((2, 4), 10), ((15, 30), 1), ((1,), 3)):
        jcfg = JTrainConfig(lr=1e-4, lr_milestones=milestones, lr_gamma=0.1)
        pcfg = port.TrainConfig(lr=1e-4, lr_milestones=milestones,
                                lr_gamma=0.1)
        with jax.enable_x64(False):
            jsched = jt.multistep_schedule(jcfg, spe)
            want = [np.float32(jsched(c)) for c in range(60)]
        psched = ptr.multistep_schedule(pcfg, spe)
        assert [np.float32(psched(c)) for c in range(60)] == want
        # The optimizer's rate at each of its steps.
        p = torch.nn.Parameter(torch.ones(3))
        opt, sched = ptr.make_optimizer(pcfg, [p], spe)
        seen = []
        for _ in range(60):
            seen.append(np.float32(opt.param_groups[0]["lr"]))
            p.grad = torch.ones(3)
            opt.step()
            sched.step()
        assert seen == want
    # boundary 3 at steps_per_epoch 1: the 4th update (count 3) on.
    s = ptr.multistep_schedule(port.TrainConfig(lr_milestones=(3,)), 1)
    assert [s(c) for c in range(5)] == [s(0)] * 3 + [s(3)] * 2
    assert s(3) == float(np.float32(0.1) * np.float32(1e-4))


# ------------------------------------------------------------ models --

BB = dict(depth=18, stop_layer="layer3", last_layer=256)
NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1,
            max_shape=(4, 4))


@pytest.fixture(scope="module")
def small():
    """The small OETR: JAX's (plain), its seeded params, and the port's
    config with its kernel switches on (their plain versions here)."""
    jcfg = OETRConfig(backbone=BackboneConfig(**BB), neck=NeckConfig(**NECK))
    pcfg = port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=True, **BB),
        neck=port.NeckConfig(attention="linear:cuda", **NECK))
    jmodel = build_oetr(jcfg)
    zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
    params = seeded_params(
        jax.eval_shape(jmodel.init, jax.random.key(0), zeros, zeros), seed=3)
    return jmodel, params, pcfg


def _port_model(params, pcfg):
    model = port.build_oetr(pcfg, device="cpu")
    model.load_state_dict(convert_flax_params(params, pcfg))
    return model


def _train_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"image1": rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32),
            "image2": rng.uniform(0, 1, (b, HW, HW, 3)).astype(np.float32),
            "overlap_box1": np.array([[4.0, 6, 60, 50], [10, 2, 40, 62]],
                                     np.float32)[:b],
            "overlap_box2": np.array([[8.0, 8, 56, 56], [0, 20, 30, 64]],
                                     np.float32)[:b],
            "overlap_valid": np.array([True, True])[:b]}


def test_train_step_matches_jax(small, monkeypatch):
    """One step with cycle=True from the same params and batch, dropout off
    on both sides: the losses, the gradients (JAX's from its Adam state:
    the first moment after one step is (1 - b1)·g) and their global norm,
    and the parameters after the update."""
    jmodel, params, pcfg = small
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)
    batch = _train_batch(5)
    with jax.enable_x64(False):
        tx = jt.make_optimizer(JTrainConfig(), steps_per_epoch=1)
        jparams = jax.tree.map(jnp.asarray, params)
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                              opt_state=tx.init(jparams))
        step = jt.make_train_step(jmodel, tx, cycle=True)
        state, jmetrics = step(state, jax.tree.map(jnp.asarray, batch),
                               jax.random.key(0))
        jmetrics = jax.tree.map(np.asarray, jmetrics)
        jnew = jax.tree.map(np.asarray, state.params)
        jgrads = jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1),
                              state.opt_state[0].mu)

    model = _port_model(params, pcfg)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pstate = ptr.TrainState(0, model, *ptr.make_optimizer(
        port.TrainConfig(), model.parameters(), 1))
    pstep = ptr.make_train_step(cycle=True)
    pstate, metrics = pstep(pstate, ptr.batch_to(batch, "cpu"), None)

    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(_np(metrics[k]), jmetrics[k], rtol=1e-5,
                                   atol=0, err_msg=k)
    ref_g = convert_flax_params(jgrads, pcfg)
    g_norm = float(ptr.global_grad_norm(model))
    j_norm = float(np.sqrt(sum((v.double() ** 2).sum() for v in
                               ref_g.values())))
    assert abs(g_norm - j_norm) <= 1e-4 * j_norm, (g_norm, j_norm)
    ref_p = convert_flax_params(jnew, pcfg)
    assert pstate.step == 1
    for name, p in model.named_parameters():
        g, rg = p.grad, ref_g[name]
        _close(g, rg, 1e-4, name)
        diff = (p.detach() - ref_p[name]).abs()
        slack = 1e-6 * ref_p[name].abs()
        assert (diff <= ADAM_BOUND + slack).all(), name
        firm = rg.abs() > max(STEP_G_FLOOR * rg.abs().max().item(), 1e-6)
        assert (diff[firm] <= 1e-6 * torch.clamp(
            ref_p[name].abs()[firm], min=1.0)).all(), name
        assert not torch.equal(p.detach(), before[name]), name


def test_with_cycle_matches_jax(small):
    jmodel, params, pcfg = small
    batch = _train_batch(6)
    with jax.enable_x64(False):
        want = jax.jit(lambda p, a, b: jmodel.apply(p, a, b,
                                                    with_cycle=True))(
            jax.tree.map(jnp.asarray, params), batch["image1"],
            batch["image2"])
    model = _port_model(params, pcfg)
    with torch.no_grad():
        out = model(_t(batch["image1"]), _t(batch["image2"]),
                    with_cycle=True)
        boxes = model.predict_boxes(_t(batch["image1"]), _t(batch["image2"]))
    for k in ("cycle_center1", "cycle_center2", "pred_bbox1", "pred_bbox2"):
        _close(out[k], np.asarray(want[k]), 5e-3, k)
    assert torch.equal(boxes[0], out["pred_bbox1"])
    assert torch.equal(boxes[1], out["pred_bbox2"])
    assert not model.training
    model.train()
    model.predict_boxes(_t(batch["image1"]), _t(batch["image2"]))
    assert model.training                    # the mode is restored


def test_evaluate_matches_jax(small):
    jmodel, params, pcfg = small
    batches = [_train_batch(7), _train_batch(8)]
    batches[1]["overlap_valid"] = np.array([False, True])
    with jax.enable_x64(False):
        want = jv.evaluate(jmodel, jax.tree.map(jnp.asarray, params), batches,
                           oiou=True)
    model = _port_model(params, pcfg)
    model.train()
    got = pv.evaluate(model, batches, oiou=True)
    assert model.training
    assert got["num_samples"] == want["num_samples"] == 6
    for k in ("mean_iou", "mean_oiou"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    for k in ("recalls", "oiou_recalls"):
        assert np.array_equal(got[k], want[k]), k


# ----------------------------------------------------------- dropout --

def test_dropout_on_its_own_terms():
    """Rate, 1/(1 - p) scaling, the same mask from the same generator, the
    identity in eval mode, and a refusal without a generator."""
    drop = Dropout(0.1).train()
    x = torch.rand(200_000) + 0.5
    y = drop(x, torch.Generator().manual_seed(1))
    zero = y == 0
    # 200k Bernoulli(0.1): the share of zeros within 5 sigma of 0.1.
    assert abs(zero.float().mean().item() - 0.1) < 5 * (0.09 / 2e5) ** 0.5
    assert torch.equal(y[~zero], x[~zero] / 0.9)
    assert torch.equal(drop(x, torch.Generator().manual_seed(1)), y)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(2)), y)
    with pytest.raises(ValueError):
        drop(x)
    drop.eval()
    assert drop(x) is x
    assert Dropout(0.0).train()(x) is x


def test_decoder_dropout_in_training_mode(small):
    """The model's decoder draws its masks from the step's generator: the
    same generator gives the same forward, another generator another one,
    and eval mode none; the encoder tokens carry no dropout."""
    _, params, pcfg = small
    model = _port_model(params, pcfg)
    batch = _train_batch(9)
    args = (_t(batch["image1"]), _t(batch["image2"]))
    with torch.no_grad():
        ref = model(*args)
        model.train()
        a = model(*args, generator=torch.Generator().manual_seed(4))
        b = model(*args, generator=torch.Generator().manual_seed(4))
        c = model(*args, generator=torch.Generator().manual_seed(5))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["tlbr1"], c["tlbr1"])
    assert not torch.equal(a["tlbr1"], ref["tlbr1"])
    assert torch.equal(a["mem1"], ref["mem1"])
    n_drop = sum(isinstance(m, Dropout) for m in model.modules())
    assert n_drop == NECK["num_decoder_layers"]


# -------------------------------------------------------- checkpoints --

def test_checkpoint_resume_is_bit_equal(small, tmp_path):
    """Three steps in a row against two, a checkpoint, a fresh state
    loaded from it and the third step: the same bits (dropout on, its
    generator seeded per step, as the command line does)."""
    _, params, pcfg = small
    tcfg = port.TrainConfig(lr_milestones=(1, 2))    # the rate drops too
    batches = [ptr.batch_to(_train_batch(10 + i), "cpu") for i in range(3)]
    step = ptr.make_train_step(cycle=True, heatmap_weight=1.0)

    def fresh():
        model = _port_model(params, pcfg)
        return ptr.TrainState(0, model, *ptr.make_optimizer(
            tcfg, model.parameters(), 1))

    def run(state, i):
        return step(state, batches[i], torch.Generator().manual_seed(50 + i))

    a = fresh()
    for i in range(3):
        a, ma = run(a, i)
    b = fresh()
    for i in range(2):
        b, _ = run(b, i)
    ptr.save_checkpoint(str(tmp_path), b)
    assert ptr.latest_checkpoint_step(str(tmp_path)) == 2
    c = ptr.load_checkpoint(str(tmp_path), 2, fresh())
    assert c.step == 2 and c.scheduler.count == 2
    c, mc = run(c, 2)
    assert c.step == a.step == 3
    for k in ma:
        assert torch.equal(ma[k], mc[k]), k
    sa, sc = a.model.state_dict(), c.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sc[k]), k
    oa, oc = a.optimizer.state_dict()["state"], c.optimizer.state_dict()[
        "state"]
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], oc[i][k]), (i, k)
    assert (c.optimizer.param_groups[0]["lr"]
            == a.optimizer.param_groups[0]["lr"])


def test_latest_checkpoint_step(tmp_path):
    assert ptr.latest_checkpoint_step(str(tmp_path / "nope")) is None
    for name in ("step_3", "step_12", "not_a_ckpt", "step_x"):
        (tmp_path / name).mkdir()
    assert ptr.latest_checkpoint_step(str(tmp_path)) == 12
    assert (ptr.latest_checkpoint_step(str(tmp_path))
            == jt.latest_checkpoint_step(str(tmp_path)))


# -------------------------------------------------------------- data --

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A scene tree written by the JAX package: 4 pairs at 64², dolly and
    translation, and segmentation masks for all images but one (whose mask
    reads as zeros)."""
    import cv2
    base = tmp_path_factory.mktemp("scene")
    pairs = generate_scene(str(base), n_pairs=4, image_hw=HW,
                           max_shift_px=8, seed=3, scale_range=(1.0, 1.6),
                           p_translate=0.5)
    os.makedirs(base / "masks", exist_ok=True)
    for i in range(7):
        m = np.zeros((HW, HW), np.uint8)
        m[4 * (i + 1):, 2 * i:] = 255
        cv2.imwrite(str(base / "masks" / f"{'ab'[i % 2]}{i // 2}.png"), m)
    return str(base), pairs


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, (what, k)
            assert np.array_equal(a[k], b[k]), (what, k)
        else:
            assert a[k] == b[k], (what, k)


@pytest.mark.parametrize("train", [True, False])
def test_megadepth_dataset_matches_jax(scene, train):
    """The same numpy seed gives the same samples, items (segmentation
    masks too) and batches (with the geometry), epoch after epoch."""
    base, pairs = scene
    kw = dict(image_size=(HW, HW), train=train, with_mask=True,
              pairs_per_epoch=6 if train else None)
    np.random.seed(11)
    jds = jmd.MegaDepthPairsDataset(base, pairs, **kw)
    np.random.seed(11)
    pds = pmd.MegaDepthPairsDataset(base, pairs, **kw)
    for epoch in range(2):
        if epoch:
            np.random.seed(12)
            jds.build_dataset()
            np.random.seed(12)
            pds.build_dataset()
        assert len(jds) == len(pds)
        for sj, sp in zip(jds.dataset, pds.dataset):
            assert sj.record.image_path1 == sp.record.image_path1
            assert np.array_equal(sj.central_match, sp.central_match)
        for i in range(len(jds)):
            _same(pds[i], jds[i], (epoch, i))
        for geometry in (False, True):
            for bj, bp in zip(jds.batches(2, geometry=geometry),
                              pds.batches(2, geometry=geometry)):
                _same(bp, bj, (epoch, geometry))
    masks = [pds[i][f"seg_mask{side}"].max() for i in range(len(pds))
             for side in "12"]
    assert 255.0 in masks and 0.0 in masks


def test_resize_crop_and_gt_match_jax():
    rng = np.random.default_rng(13)
    img = (rng.uniform(0, 255, (50, 90, 3))).astype(np.uint8)
    for depth in (False, True):
        a, ra = pmd.resize_dataset(img, (32, 32), depth=depth)
        b, rb = jmd.resize_dataset(img, (32, 32), depth=depth)
        assert np.array_equal(a, b) and ra == rb
    im1, im2 = np.zeros((80, 80, 3)), np.zeros((70, 90, 3))
    for cm in ([70.0, 70, 10, 10], [5.0, 40, 60, 85]):
        got = pmd.central_crop(im1, im2, np.array(cm), (40, 40))
        want = jmd.central_crop(im1, im2, np.array(cm), (40, 40))
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    from oetr_tpu.data.gt import overlap_bbox_np as jgt
    from oetr_tpu_torch.data.gt import overlap_bbox_np as pgt
    d = _geometry(14, b=1)
    args = [d[k][0].astype(np.float64) for k in GEOM]
    for got, want in zip(pgt(*args), jgt(*args)):
        assert np.array_equal(np.asarray(got), np.asarray(want))


# --------------------------------------------------------------- cli --

def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "oetr_tpu_torch.training.cli", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_resumes_and_reexecs(scene, tmp_path):
    """Two epochs of two steps on the scene tree (4 pairs, batch 2) with a
    segment limit of three steps: epoch 0 trains, validates and
    checkpoints; step 3 checkpoints and re-executes the process with
    --resume, which resumes mid-epoch and finishes at step 4."""
    base, pairs = scene
    ckpt = str(tmp_path / "ckpt")
    run = _cli(["--base_path", base, "--train_pairs", pairs,
                "--val_pairs", pairs, "--device", "cpu", "--batch_size", "2",
                "--image_size", str(HW), "--pairs_per_epoch", "0",
                "--epochs", "2", "--save_path", ckpt, "--cycle",
                "--log_every", "1", "--max_steps_per_segment", "3",
                "--tensorboard", str(tmp_path / "tb")], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    log = run.stderr
    assert "val R0.5" in log
    assert "epoch 0 checkpointed at step 2" in log
    assert "segment limit 3 reached at step 3: re-exec" in log
    assert "resumed from step 3 (epoch 1, it 1)" in log
    assert "epoch 1 checkpointed at step 4" in log
    assert sorted(os.listdir(ckpt)) == ["step_2", "step_3", "step_4"]
    saved = read_checkpoint(os.path.join(ckpt, "step_4"))
    assert saved["step"] == 4 and saved["opt_state"][2]["count"] == 4
    assert os.listdir(tmp_path / "tb")


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--fsdp", "2"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--num_processes", "2"]])
def test_cli_refuses_meshes(flags, capsys, monkeypatch):
    """In one process, with no torchrun variables, a mesh wider than the
    one device and a half-given rendezvous are refused before anything
    runs (multi-process runs: tests/test_torch_port_multiproc.py)."""
    from oetr_tpu_torch.training import cli
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        cli.parse_args(["--base_path", ".", "--train_pairs", "p.txt",
                        *flags])
    assert "needs" in capsys.readouterr().err
