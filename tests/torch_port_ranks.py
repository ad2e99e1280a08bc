"""Rank programs of the port's multi-process tests (not a test module).

``parallel.spawn`` starts each program in fresh processes, which import
this module by name: it imports torch, numpy and the port, never JAX, so
the ranks run as the port runs where only torch is installed. Every rank
joins a gloo group through a file and uses one CPU thread; results go to
files under the directory the test passes.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import oetr_tpu_torch as port
from oetr_tpu_torch.models.transformer import Dropout
from oetr_tpu_torch.parallel import make_mesh, shard_batch
from oetr_tpu_torch.training import train as ptr

HW = 64
LR = 1e-4
BB = dict(depth=18, stop_layer="layer3", last_layer=256)
NECK = dict(d_model=64, nhead=4, num_layers=1, num_decoder_layers=1,
            max_shape=(4, 4))
# Every loss the plain batch feeds: the masked means, the cycle loss, the
# heat map and size losses and the difficulty weights' batch mean.
LOSSES = dict(cycle=True, heatmap_weight=1.0, size_weight=1.0,
              reweight_power=1.0)
SG_KW = dict(descriptor_dim=32, keypoint_encoder_layers=(16, 32),
             gnn_layers=2, sinkhorn_iterations=20, match_threshold=0.2)
LOFTR_KW = dict(d_coarse=32, d_fine=16, coarse_layers=1, fine_layers=1,
                nhead=4, match_threshold=0.0, max_matches=32)


def _whole(t: torch.Tensor) -> torch.Tensor:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().clone()


def _rows(x, rank: int, world: int):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


# ------------------------------------------------------------ OETR step --

def oetr_cfg(attention: str) -> port.OETRConfig:
    return port.OETRConfig(
        backbone=port.BackboneConfig(fused_stem=True, **BB),
        neck=port.NeckConfig(attention=attention, **NECK))


def oetr_batch(seed: int = 5) -> dict:
    """4 pairs; valid [T, F, T, T]: over two data ranks 1 and 2 valid."""
    rng = np.random.default_rng(seed)
    return {
        "image1": rng.uniform(0, 1, (4, HW, HW, 3)).astype(np.float32),
        "image2": rng.uniform(0, 1, (4, HW, HW, 3)).astype(np.float32),
        "overlap_box1": np.array([[4.0, 6, 60, 50], [10, 2, 40, 62],
                                  [0, 0, 32, 32], [20, 16, 64, 60]],
                                 np.float32),
        "overlap_box2": np.array([[8.0, 8, 56, 56], [0, 20, 30, 64],
                                  [16, 16, 48, 48], [2, 4, 40, 44]],
                                 np.float32),
        "overlap_valid": np.array([True, False, True, True]),
    }


def oetr_state(attention: str, dropout: bool):
    model, state = ptr.create_train_state(
        oetr_cfg(attention), port.TrainConfig(lr=LR),
        torch.Generator().manual_seed(0), device="cpu")
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    return state


def oetr_step(axes: dict | None, attention: str = "linear:cuda",
              dropout: bool = False) -> dict:
    """One train step of the small OETR on the global batch: in this
    process alone (``axes`` None) or on a mesh of ``axes`` over the group
    (DDP over 'data' alone; TP over 'model', FSDP2 over 'fsdp'). Returns
    the metrics, the gradient norm, and the whole gradients and
    parameters after the step."""
    state = oetr_state(attention, dropout)
    batch = oetr_batch()
    group = None
    if axes is None:
        local = ptr.batch_to(batch, "cpu")
    else:
        mesh = make_mesh(axes, "cpu")
        state, _ = ptr.shard_train_state(
            state, mesh, rules=None if "model" in axes else [],
            fsdp_axis="fsdp" if "fsdp" in axes else None)
        group = mesh["data"].get_group()
        local = shard_batch(batch, mesh)
    step = ptr.make_train_step(group=group, **LOSSES)
    state, metrics = step(state, local, torch.Generator().manual_seed(7))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "norm": float(ptr.global_grad_norm(state.model)),
            "grads": {n: _whole(p.grad)
                      for n, p in state.model.named_parameters()},
            "params": {n: _whole(p)
                       for n, p in state.model.named_parameters()}}


# ------------------------------------------------------ matching steps --

def _seed(n: int) -> torch.Generator:
    return torch.Generator().manual_seed(n)


def _result(model, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: _whole(p.grad) for n, p in model.named_parameters()},
            "params": {n: _whole(p) for n, p in model.named_parameters()}}


def _sl(arrs: dict, rank: int, world: int) -> dict:
    return {k: torch.as_tensor(_rows(v, rank, world)) for k, v in arrs.items()}


def matching_steps(group, rank: int = 0, world: int = 1) -> dict:
    """One step of SuperPoint's joint step, SuperGlue's and LoFTR's (with
    the fine loss) on a global batch of 4, this rank's rows of it; the
    GT counts differ between the halves."""
    from oetr_tpu_torch.models import (build_loftr, build_superglue,
                                       build_superpoint_net)
    from oetr_tpu_torch.training import (make_loftr_train_step,
                                         make_superglue_train_step,
                                         make_superpoint_joint_train_step)

    def adam(m):
        return torch.optim.Adam(m.parameters(), lr=LR, betas=(0.9, 0.999),
                                eps=1e-8)

    rng = np.random.default_rng(21)
    out = {}
    hw, b = 32, 4
    net = build_superpoint_net(device="cpu", generator=_seed(1),
                               descriptor_dim=32)
    H = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    H[:, :2, 2] = rng.uniform(-3, 3, (b, 2))
    sp = _sl({"shape": rng.uniform(0, 1, (b, hw, hw, 1)),
              "labels": rng.integers(0, 65, (b, hw // 8, hw // 8)),
              "im0": rng.uniform(0, 1, (b, hw, hw, 1)),
              "im1": rng.uniform(0, 1, (b, hw, hw, 1)), "H": H}, rank, world)
    sp = {k: v.float() if v.is_floating_point() else v for k, v in sp.items()}
    m = make_superpoint_joint_train_step(net, adam(net), group=group)(
        sp["shape"], sp["labels"], sp["im0"], sp["im1"], sp["H"])
    out["superpoint"] = _result(net, m)

    k, d = 16, 32
    sg = build_superglue(device="cpu", generator=_seed(2), **SG_KW)
    gt = np.tile(np.arange(k)[None], (b, 1)).astype(np.int32)
    gt[0, 3:] = -1                 # rank 0 of two: 3 + 16 matches
    gt[2, :10] = -1                # rank 1: 6 + 16
    valid0 = np.ones((b, k), bool)
    valid0[1, 12:] = False
    batch = _sl({
        "keypoints0": rng.uniform(0, 64, (b, k, 2)).astype(np.float32),
        "keypoints1": rng.uniform(0, 64, (b, k, 2)).astype(np.float32),
        "scores0": rng.uniform(0.1, 1, (b, k)).astype(np.float32),
        "scores1": rng.uniform(0.1, 1, (b, k)).astype(np.float32),
        "descriptors0": rng.normal(size=(b, k, d)).astype(np.float32),
        "descriptors1": rng.normal(size=(b, k, d)).astype(np.float32),
        "valid0": valid0, "valid1": np.ones((b, k), bool),
        "gt_matches0": gt}, rank, world)
    batch.update(image_hw0=(64, 64), image_hw1=(64, 64))
    m = make_superglue_train_step(sg, adam(sg), group=group)(batch)
    out["superglue"] = _result(sg, m)

    lf = build_loftr(device="cpu", generator=_seed(3), **LOFTR_KW)
    hc = 64 // 8
    n = hc * hc
    img = np.repeat(np.repeat(rng.uniform(0, 1, (b, hc, hc, 1)), 8, 1), 8,
                    2).astype(np.float32)
    gtl = np.tile(np.arange(n)[None], (b, 1)).astype(np.int32)
    gtl[0, 5:] = -1
    gtl[3, :40] = -1
    u = np.arange(hc, dtype=np.float32) * 8 + 3.5
    gy, gx = np.meshgrid(u, u, indexing="ij")
    ctr = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    lb = _sl({"img": img, "gt": gtl,
              "xy": (np.tile(ctr[None], (b, 1, 1))
                     + rng.uniform(-1, 1, (b, n, 2))).astype(np.float32),
              "ok": rng.uniform(0, 1, (b, n)) > 0.2}, rank, world)
    m = make_loftr_train_step(lf, adam(lf), fine_weight=1.0, group=group)(
        lb["img"], lb["img"], lb["gt"], lb["xy"], lb["ok"])
    out["loftr"] = _result(lf, m)
    return out


# --------------------------------------------------------- checkpoints --

def full_state(state) -> dict:
    """The model's and optimizer's whole state dicts (collective)."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict)
    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    return {"model": get_model_state_dict(state.model, options=opts),
            "optimizer": get_optimizer_state_dict(state.model,
                                                  state.optimizer,
                                                  options=opts)}


def checkpoint_crossing(tmp: str, rank: int) -> None:
    """On an FSDP mesh {"data": 1, "fsdp": 2}: load the one-process
    checkpoint ``ckpt_a/step_1``, write the whole state as loaded, take a
    step and write ``ckpt_b/step_2``."""
    state = oetr_state("linear:cuda", dropout=True)
    mesh = make_mesh({"data": 1, "fsdp": 2}, "cpu")
    state, _ = ptr.shard_train_state(state, mesh, rules=[], fsdp_axis="fsdp")
    state = ptr.load_checkpoint(os.path.join(tmp, "ckpt_a"), 1, state)
    loaded = full_state(state)
    if rank == 0:
        torch.save(loaded, os.path.join(tmp, "loaded.pt"))
    # An FSDP forward drops K2's cached bf16 weights (its gathers reuse the
    # parameter objects without a version bump).
    from oetr_tpu_torch.ops import linear_encoder
    linear_encoder._ROUNDED[-1] = (lambda: None, None, None)
    step = ptr.make_train_step(group=mesh["data"].get_group(), **LOSSES)
    state, _ = step(state, shard_batch(oetr_batch(9), mesh),
                    torch.Generator().manual_seed(8))
    if rank == 0:
        torch.save(-1 not in linear_encoder._ROUNDED,
                   os.path.join(tmp, "k2_cache_dropped.pt"))
    ptr.save_checkpoint(os.path.join(tmp, "ckpt_b"), state)


# ------------------------------------------------------------ programs --

def prog_two(rank: int, world: int, tmp: str) -> None:
    """Two ranks: DP OETR steps (dropout off, on), the matching steps,
    the checkpoint crossing."""
    res = {"dp": oetr_step({"data": 2}),
           "dp_dropout": oetr_step({"data": 2}, dropout=True),
           "matching": matching_steps(dist.group.WORLD, rank, world)}
    checkpoint_crossing(tmp, rank)
    torch.save(res, os.path.join(tmp, f"two_{rank}.pt"))


def prog_four(rank: int, world: int, tmp: str) -> None:
    """Four ranks: OETR steps on data 1 x model 2 x fsdp 2 and on
    data 2 x model 2, ``dryrun_multichip(4)``, and the refusal of K2
    under tensor parallelism."""
    from oetr_tpu_torch.entry import dryrun_multichip
    res = {"tp_fsdp": oetr_step({"data": 1, "model": 2, "fsdp": 2},
                                attention="linear"),
           "dp_tp": oetr_step({"data": 2, "model": 2}, attention="linear"),
           "dryrun": dryrun_multichip(4, "cpu")}
    try:    # K2 reads whole q/k/v weights: a 'model' axis must refuse it
        oetr_step({"data": 2, "model": 2}, attention="linear:cuda")
        res["k2_tp_error"] = ""
    except ValueError as e:
        res["k2_tp_error"] = str(e)
    torch.save(res, os.path.join(tmp, f"four_{rank}.pt"))


def prog_parallel(rank: int, world: int, tmp: str) -> None:
    """Four ranks: the parallel layer on the test's inputs (``par_in.pt``):
    the mesh, ring and Ulysses attention, 'full:ring', GPipe and the
    pipelined encoder (outputs and gradients), sharded BA and FCOS."""
    from oetr_tpu_torch.models.fcos import fcos_losses
    from oetr_tpu_torch.models.transformer import QueryTransformer, _attend
    from oetr_tpu_torch.parallel import (gpipe, pipelined_encoder,
                                         ring_attention, ring_context,
                                         ulysses_attention)
    from oetr_tpu_torch.sfm import bundle_adjust

    inp = torch.load(os.path.join(tmp, "par_in.pt"), weights_only=True)
    out = {}
    mesh = make_mesh({"data": -1, "model": 2}, "cpu")
    out["mesh"] = tuple(mesh.mesh.shape)
    try:
        make_mesh({"data": 8}, "cpu")
        out["mesh_error"] = ""
    except ValueError as e:
        out["mesh_error"] = str(e)

    def gather(x, dim):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=dim)

    q, k, v, km = inp["q"], inp["k"], inp["v"], inp["kv_mask"]
    blk = k.shape[1] // world
    sl = slice(rank * blk, (rank + 1) * blk)
    out["ring"] = ring_attention(q, k[:, sl], v[:, sl], None, km[:, sl])
    out["ring_nomask"] = ring_attention(q, k[:, sl], v[:, sl])
    qb = q.shape[1] // world
    out["ulysses"] = gather(ulysses_attention(
        q[:, rank * qb:(rank + 1) * qb], k[:, sl], v[:, sl], None,
        km[:, sl]), 1)
    with ring_context():
        out["full_ring"] = _attend("full:ring", q, k, v, None, km)

    ws = inp["ws"].clone().requires_grad_()
    y = gpipe(lambda p, x: torch.tanh(x @ p["w"]), {"w": ws}, inp["xs"])
    (y ** 2).sum().backward()
    out["gpipe"] = y.detach()
    out["gpipe_grad"] = ws.grad.clone()
    dist.all_reduce(out["gpipe_grad"])

    d, nhead = inp["f0"].shape[-1], 4
    with torch.device("meta"):
        tr = QueryTransformer(d, nhead, world, 1)
    tr.load_state_dict(inp["transformer"], assign=True)
    tr.eval()
    for attention in ("linear", "full"):
        a, b = pipelined_encoder(tr, inp["f0"], inp["f1"], inp["pos"],
                                 inp["pos"], mask0=inp["mask0"],
                                 mask1=inp["mask1"], num_layers=world,
                                 nhead=nhead, attention=attention)
        out[f"encoder_{attention}"] = (a.detach(), b.detach())
        if attention == "linear":
            tr.zero_grad()
            ((a ** 2).sum() + (b ** 2).sum()).backward()
            grads = {n: p.grad.clone() for n, p in tr.named_parameters()
                     if p.grad is not None}
            for g in grads.values():
                dist.all_reduce(g)
            out["encoder_grads"] = grads

    n_obs = inp["obs_cam"].shape[0] // world
    ob = slice(rank * n_obs, (rank + 1) * n_obs)
    ba = bundle_adjust(inp["cams"], inp["pts"], inp["K"],
                       inp["obs_cam"][ob], inp["obs_pt"][ob],
                       inp["obs_uv"][ob], torch.ones(n_obs, dtype=torch.bool),
                       iters=4, cg_iters=20, group=dist.group.WORLD)
    out["ba"] = {k2: ba[k2] for k2 in ("cams", "pts", "cost", "cost0")}

    fb = inp["cls"].shape[0] // world
    fs = slice(rank * fb, (rank + 1) * fb)
    f = fcos_losses(inp["locs"], inp["cls"][fs], inp["reg"][fs],
                    inp["cent"][fs], inp["boxes"][fs],
                    group=dist.group.WORLD)
    out["fcos"] = gather(torch.stack([f["cls_loss"], f["reg_loss"],
                                      f["centerness_loss"]])[None], 0)
    torch.save(out, os.path.join(tmp, f"par_{rank}.pt"))
