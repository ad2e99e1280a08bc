"""Entry points: the flagship forward and the multi-device dry run (port of
``__graft_entry__.py``).

``entry()`` returns the flagship OETR forward in bf16 with its CUDA
kernels (ResNet50, a 640x640 pair) and example inputs, on the card unless
the caller asks for the CPU.

``dryrun_multichip(n)`` runs on each of n ranks of a process group: one
training step of a small config and of the flagship (at 64²) on a
("data", "model", "fsdp") mesh (tensor parallelism 2 when n is even, FSDP
2 when 4 divides n, the rest data), the GPipe encoder against the
sequential one, pair-parallel ``SparsePipeline`` inference, and
data-parallel SuperPoint, SuperGlue and LoFTR steps.

    python -m oetr_tpu_torch.entry                       # entry ok: [boxes]
    python -m oetr_tpu_torch.entry dryrun 4 --device cpu  # 4 gloo ranks

On the card's machine (one H100) NCCL takes one rank: ``dryrun 1``.
"""
from __future__ import annotations

import math
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .parallel.multihost import rank_device


def entry(device="cuda"):
    """(fn, example_args): ``fn(image1, image2) -> (pred_bbox1,
    pred_bbox2)``, the flagship bf16 forward with K2 and K3 on, weights
    from seed 0; the example a pair of 640² images [1, 640, 640, 3]."""
    from .config import oetr_r50_kernels_config
    from .models import build_oetr

    model = build_oetr(oetr_r50_kernels_config("bfloat16"), device=device,
                       generator=torch.Generator().manual_seed(0))

    @torch.no_grad()
    def forward(image1, image2):
        out = model(image1, image2)
        return out["pred_bbox1"], out["pred_bbox2"]

    example = (torch.full((1, 640, 640, 3), 0.5, device=device),
               torch.full((1, 640, 640, 3), 0.4, device=device))
    return forward, example


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded train step (DP x TP x FSDP) of a small config and of the
    flagship, the pipeline check and the matching stack on ``n_devices``
    ranks. Every rank of the group (whose size must be ``n_devices``;
    one process needs none) calls it. Returns the losses and the pipeline's
    matches, the same on every rank; raises where a value is not finite."""
    from .config import BackboneConfig, NeckConfig, OETRConfig
    from .parallel import make_mesh

    device_type = torch.device(device or "cuda").type
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) runs on a group of "
                         f"{n_devices} ranks, have {world}")
    tp = 2 if n_devices % 2 == 0 else 1
    fsdp = 2 if n_devices % 4 == 0 else 1
    dp = n_devices // (tp * fsdp)
    mesh = make_mesh({"data": dp, "model": tp, "fsdp": fsdp}, device_type)

    small_cfg = OETRConfig(
        backbone=BackboneConfig(depth=18, stop_layer="layer3",
                                last_layer=256),
        neck=NeckConfig(d_model=64, nhead=4, num_layers=1,
                        num_decoder_layers=1, max_shape=(8, 8)))
    out = {"loss": _dryrun_train_step(mesh, small_cfg, n_devices)}
    # The flagship's widths (ResNet50, d 256, 8 heads, 4 layers): the
    # Megatron splits and FSDP layouts at their real divisibility, on 64².
    out["loss_flagship"] = _dryrun_train_step(
        mesh, OETRConfig(neck=NeckConfig(max_shape=(2, 2))), n_devices)
    if n_devices >= 2:
        out["pipeline_err"] = _dryrun_pipeline(4 if n_devices >= 4 else 2,
                                               device_type)
    (out["pipeline_matches"], out["sp_loss"], out["sg_loss"],
     out["loftr_loss"]) = _dryrun_matching(n_devices, device_type)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): ok, loss={out['loss']:.4f}, "
              f"flagship(d=256,h=8,L=4,r50) loss={out['loss_flagship']:.4f}, "
              f"pipeline matches={out['pipeline_matches']}, "
              f"sp_loss={out['sp_loss']:.4f}, sg_loss={out['sg_loss']:.4f}, "
              f"loftr_loss={out['loftr_loss']:.4f}", flush=True)
    return out


def _finite(name: str, v) -> float:
    v = float(v)
    if not math.isfinite(v):
        raise FloatingPointError(f"{name}: non-finite {v}")
    return v


def _dryrun_train_step(mesh, model_cfg, n_devices: int, hw: int = 64
                       ) -> float:
    """One sharded forward + backward + AdamW step of ``model_cfg`` on
    ``mesh``; the global batch is ``n_devices`` pairs."""
    from .config import TrainConfig
    from .parallel import shard_batch
    from .training import create_train_state, make_train_step
    from .training.train import shard_train_state

    dev = rank_device(mesh.device_type)
    train_cfg = TrainConfig(batch_size=n_devices, image_size=(hw, hw))
    _, state = create_train_state(model_cfg, train_cfg,
                                  torch.Generator().manual_seed(0),
                                  device=dev)
    state, _ = shard_train_state(state, mesh, fsdp_axis="fsdp")
    step = make_train_step(cycle=True, group=mesh["data"].get_group())

    rng = np.random.default_rng(0)
    b = n_devices
    batch = {
        "image1": rng.uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
        "image2": rng.uniform(0, 1, (b, hw, hw, 3)).astype(np.float32),
        "overlap_box1": np.tile(np.array([4.0, 4.0, hw - 4.0, hw - 4.0],
                                         np.float32), (b, 1)),
        "overlap_box2": np.tile(np.array([8.0, 8.0, hw - 8.0, hw - 8.0],
                                         np.float32), (b, 1)),
        "overlap_valid": np.ones((b,), bool),
    }
    state, metrics = step(state, shard_batch(batch, mesh),
                          torch.Generator(dev).manual_seed(1))
    if state.step != 1:
        raise RuntimeError(f"step count {state.step} after one step")
    return _finite("loss", metrics["loss"])


def _dryrun_pipeline(num_layers: int, device_type: str) -> float:
    """The encoder GPipe'd over the first ``num_layers`` ranks (one
    (self, cross) pair a stage) against the sequential encoder; the
    largest difference, on every rank."""
    from .models.layers import init_params
    from .models.transformer import QueryTransformer
    from .parallel import pipelined_encoder

    dev = rank_device(device_type)
    d, nhead, n, b = 32, 4, 16, 4
    with torch.device("meta"):
        tr = QueryTransformer(d, nhead, num_layers, 1)
    tr.to_empty(device=dev).eval()
    init_params(tr, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    f0 = torch.randn(b, n, d, generator=g).to(dev)
    f1 = torch.randn(b, n, d, generator=g).to(dev)
    pos = (torch.randn(1, n, d, generator=g) * 0.1).to(dev)
    q = torch.zeros(1, d, device=dev)
    with torch.no_grad():
        _, _, mem0, _ = tr(f0, f1, q, q, pos, pos)
    pipe = dist.new_group(list(range(num_layers)))
    err = torch.zeros((), device=dev)
    if dist.get_rank() < num_layers:
        with torch.no_grad():
            p0, _ = pipelined_encoder(tr, f0, f1, pos, pos, pipe,
                                      num_layers=num_layers, nhead=nhead)
        err = (p0 - mem0).abs().max()
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    if not float(err) < 1e-4:
        raise RuntimeError(f"pipelined encoder mismatch: {float(err)}")
    return float(err)


def _dryrun_matching(n_devices: int, device_type: str):
    """Pair-parallel SparsePipeline inference (each rank its pairs) and one
    data-parallel SuperPoint joint, SuperGlue and LoFTR step; returns (the
    pipeline's matches over all ranks, the three losses)."""
    from .models import (build_loftr, build_superglue, build_superpoint,
                         build_superpoint_net)
    from .models.matchers import nearest_neighbor_match
    from .parallel import make_mesh, shard_batch
    from .pipelines import PipelineConfig, SparsePipeline
    from .training import (make_loftr_train_step, make_superglue_train_step,
                           make_superpoint_joint_train_step)

    dev = rank_device(device_type)
    mesh = make_mesh({"data": n_devices}, device_type)
    group = mesh.get_group("data")
    rng = np.random.default_rng(5)
    b, hw, k, d = n_devices, 64, 64, 64

    # (a) pair-parallel inference: each rank matches its rows.
    sp = build_superpoint(device=dev, max_keypoints=k, keypoint_threshold=0.0,
                          descriptor_dim=d)

    def match_fn(data):
        return nearest_neighbor_match(
            data["descriptors0"], data["descriptors1"], data["valid0"],
            data["valid1"], do_mutual_check=True)

    pipe = SparsePipeline(sp, match_fn, cfg=PipelineConfig(
        oetr_hw=(hw, hw), canvas_hw=(hw, hw), fallback_min_matches=0))
    imgs = np.repeat(np.repeat(rng.uniform(0, 1, (b, hw // 8, hw // 8, 3)),
                               8, axis=1), 8, axis=2).astype(np.float32)
    full_hw = np.tile(np.array([[hw, hw]], np.int32), (b, 1))
    sb = shard_batch({"i": imgs, "h": full_hw}, mesh)
    with torch.no_grad():
        out = pipe(sb["i"], sb["i"], sb["h"], sb["h"], with_overlap=False)
    n_match = out["num_matches"].sum()
    dist.all_reduce(n_match, group=group)
    if int(n_match) <= 0:
        raise RuntimeError("identity pairs must match")

    def adam(model):
        return torch.optim.Adam(model.parameters(), lr=1e-4)

    # (b) data-parallel train steps.
    net = build_superpoint_net(device=dev,
                               generator=torch.Generator().manual_seed(1),
                               descriptor_dim=d)
    hc = hw // 8
    sp_b = shard_batch({
        "imgs": imgs[..., :1],
        "labels": rng.integers(0, 65, (b, hc, hc)).astype(np.int32),
        "H": np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
    }, mesh)
    spm = make_superpoint_joint_train_step(net, adam(net), group=group)(
        sp_b["imgs"], sp_b["labels"], sp_b["imgs"], sp_b["imgs"],
        sp_b["H"])
    sp_loss = _finite("sp_loss", spm["loss"])

    sg = build_superglue(device=dev,
                         generator=torch.Generator().manual_seed(2),
                         descriptor_dim=d, gnn_layers=2,
                         sinkhorn_iterations=5)
    dummy = {
        "keypoints0": rng.uniform(0, hw, (b, k, 2)).astype(np.float32),
        "keypoints1": rng.uniform(0, hw, (b, k, 2)).astype(np.float32),
        "scores0": np.ones((b, k), np.float32),
        "scores1": np.ones((b, k), np.float32),
        "descriptors0": rng.normal(size=(b, k, d)).astype(np.float32),
        "descriptors1": rng.normal(size=(b, k, d)).astype(np.float32),
        "valid0": np.ones((b, k), bool), "valid1": np.ones((b, k), bool),
        "gt_matches0": np.tile(np.arange(k, dtype=np.int32)[None], (b, 1)),
    }
    sg_b = dict(shard_batch(dummy, mesh), image_hw0=(hw, hw),
                image_hw1=(hw, hw))
    sgm = make_superglue_train_step(sg, adam(sg), group=group)(sg_b)
    sg_loss = _finite("sg_loss", sgm["loss"])

    lf = build_loftr(device=dev, generator=torch.Generator().manual_seed(3),
                     d_coarse=32, d_fine=16, coarse_layers=1, fine_layers=1,
                     nhead=4, max_matches=16, match_threshold=0.0)
    ncell = hc * hc
    u = np.arange(hc, dtype=np.float32) * 8 + 3.5
    gy, gx = np.meshgrid(u, u, indexing="ij")
    ctr = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    lf_b = shard_batch({
        "g": imgs[..., :1],
        "gt": np.tile(np.arange(ncell, dtype=np.int32)[None], (b, 1)),
        "gt_xy1": np.tile(ctr[None], (b, 1, 1)).astype(np.float32),
        "gt_ok": np.ones((b, ncell), bool),
    }, mesh)
    lfm = make_loftr_train_step(lf, adam(lf), fine_weight=1.0, group=group)(
        lf_b["g"], lf_b["g"], lf_b["gt"], lf_b["gt_xy1"], lf_b["gt_ok"])
    lf_loss = _finite("loftr_loss", lfm["loss"])
    return int(n_match), sp_loss, sg_loss, lf_loss


def _dryrun_rank(rank: int, world: int, device: str) -> None:
    dryrun_multichip(world, device)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="entry",
                    choices=("entry", "dryrun"))
    ap.add_argument("n", nargs="?", type=int, default=1,
                    help="dryrun: ranks (processes) to start")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    if args.mode == "dryrun":
        from .parallel import spawn
        with tempfile.TemporaryDirectory() as tmp:
            spawn(_dryrun_rank, args.n, args.device,
                  os.path.join(tmp, "rendezvous"), (args.device,),
                  threads=max(1, (os.cpu_count() or 1) // args.n))
        return
    fn, example = entry(args.device)
    print("entry ok:", [o.float().cpu().tolist() for o in fn(*example)])


if __name__ == "__main__":
    main(sys.argv[1:])
