"""OETR training from the command line (port of
``oetr_tpu/training/cli.py``).

    python -m oetr_tpu_torch.training.cli --base_path /data/megadepth \
        --train_pairs pairs_train.txt --val_pairs pairs_val.txt \
        --batch_size 8 --epochs 35 --save_path checkpoints

The model is the flagship (``oetr_r50_kernels_config('float32')``: K2 and
K3 on the card, their plain versions on the CPU) on the card, or on the
CPU with ``--device cpu``; the MegaDepth pairs are read on the host with
the port's own JPEG, PNG and HDF5 readers. Checkpoints hold the full state; ``--resume`` continues from
the latest, and ``--max_steps_per_segment N`` checkpoints after N steps
and re-executes the process with ``--resume``. The dropout masks of step
N are drawn from a generator seeded ``seed + 1 + N``, so a resumed run
draws what an uninterrupted one would.

Several processes, one rank each, under torchrun or with explicit flags:

    torchrun --nproc_per_node 4 -m oetr_tpu_torch.training.cli ... \
        --tp 2 --fsdp 2
    python -m oetr_tpu_torch.training.cli ... --coordinator host:port \
        --num_processes 2 --process_id 0      # and 1 in a second process

The mesh is {"data": world / (tp * fsdp), "model": tp, "fsdp": fsdp}, as
in JAX: ``--tp`` splits the transformer's projections over 'model' (the
encoder then runs the plain 'linear' attention: K2 reads whole weights),
``--fsdp`` shards the parameters over 'fsdp', and 'data' replicates (DDP
when neither is asked). Each data rank keeps every P-th batch (P the
data axis's size), so a step trains on P x batch_size pairs; the loss is
the global batch's. NCCL on the card, gloo with ``--device cpu``. Rank 0
alone logs and writes the checkpoints, which are whole, so a run resumes
on any layout.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch
import torch.distributed as dist

from ..config import TrainConfig, oetr_r50_kernels_config
from ..data.megadepth import MegaDepthPairsDataset
from ..parallel import initialize_distributed, make_mesh
from .train import (batch_to, create_train_state, latest_checkpoint_step,
                    load_checkpoint, make_train_step, save_checkpoint,
                    shard_train_state)
from .validation import evaluate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="OETR training")
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--train_pairs", required=True)
    ap.add_argument("--val_pairs", default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=35)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--image_size", type=int, default=640)
    ap.add_argument("--pairs_per_epoch", type=int, default=128_000)
    ap.add_argument("--save_path", default="checkpoints")
    ap.add_argument("--cycle", action="store_true",
                    help="swapped-query cycle loss")
    ap.add_argument("--full_cycle", action="store_true",
                    help="depth-warped cycle GIoU loss")
    ap.add_argument("--oiou", action="store_true")
    ap.add_argument("--aux_match", type=float, default=0.0,
                    help="token InfoNCE weight (losses.aux_match_loss)")
    ap.add_argument("--heatmap", type=float, default=0.0,
                    help="dense heat-map CE weight (losses.heatmap_ce_loss)")
    ap.add_argument("--size_loss", type=float, default=0.0,
                    help="tlbr size loss weight (losses.size_loss)")
    ap.add_argument("--reweight", type=float, default=0.0,
                    help="difficulty reweighting power "
                         "(losses.difficulty_weights)")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--tensorboard", default=None,
                    help="scalar log dir (TensorBoard, or scalars.jsonl)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--save_path")
    ap.add_argument("--max_steps_per_segment", type=int, default=0,
                    help="after N steps in this process: checkpoint and "
                         "re-execute with --resume; 0 never")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis size ('model')")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="FSDP mesh axis size ('fsdp')")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (or a tcp:// or file:// "
                         "URL); torchrun's MASTER_ADDR/PORT by default")
    ap.add_argument("--num_processes", type=int, default=None,
                    help="world size; torchrun's WORLD_SIZE by default")
    ap.add_argument("--process_id", type=int, default=None,
                    help="this process's rank; torchrun's RANK by default")
    args = ap.parse_args(argv)
    env = os.environ
    world = args.num_processes or int(env.get("WORLD_SIZE", "1"))
    if args.coordinator is not None and world <= 1 \
            and args.num_processes is None:
        ap.error("--coordinator needs --num_processes (or torchrun's "
                 "WORLD_SIZE)")
    if world > 1 and args.coordinator is None and not env.get("MASTER_ADDR"):
        ap.error(f"a run of {world} processes needs --coordinator "
                 "host:port (or torchrun's MASTER_ADDR and MASTER_PORT)")
    if world > 1 and args.process_id is None and not env.get("RANK"):
        ap.error(f"a run of {world} processes needs --process_id (or "
                 "torchrun's RANK)")
    if args.tp < 1 or args.fsdp < 1 or world % (args.tp * args.fsdp):
        ap.error(f"mesh model {args.tp} x fsdp {args.fsdp} needs a multiple "
                 f"of {args.tp * args.fsdp} devices, have {world}")
    return args


def main(argv=None):
    args = parse_args(argv)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=args.device)
    distributed = dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if distributed
                   else (1, 0))
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("train")
    device = torch.device(args.device)
    if device.type == "cuda" and distributed:
        device = torch.device("cuda", torch.cuda.current_device())

    tp, fsdp = args.tp, args.fsdp
    n_data, d_rank = world // (tp * fsdp), 0
    hw = (args.image_size, args.image_size)
    train_cfg = TrainConfig(batch_size=args.batch_size, image_size=hw,
                            epochs=args.epochs, lr=args.lr,
                            pairs_per_epoch=args.pairs_per_epoch)
    model_cfg = oetr_r50_kernels_config(
        "float32", attention="linear" if tp > 1 else "linear:cuda")

    dataset = MegaDepthPairsDataset(args.base_path, args.train_pairs,
                                    image_size=hw,
                                    pairs_per_epoch=args.pairs_per_epoch,
                                    train=True)
    val_dataset = None
    if args.val_pairs:
        val_dataset = MegaDepthPairsDataset(args.base_path, args.val_pairs,
                                            image_size=hw, train=False)
    # Global steps an epoch: each takes n_data batches.
    steps_per_epoch = max(len(dataset) // (args.batch_size * n_data), 1)

    model, state = create_train_state(
        model_cfg, train_cfg, torch.Generator().manual_seed(train_cfg.seed),
        steps_per_epoch, device=device)
    group = None
    if world > 1 or tp * fsdp > 1:
        mesh = make_mesh({train_cfg.data_axis: n_data, "model": tp,
                          "fsdp": fsdp}, device.type)
        state, _ = shard_train_state(
            state, mesh, rules=None if tp > 1 else [],
            fsdp_axis="fsdp" if fsdp > 1 else None,
            data_axis=train_cfg.data_axis)
        group = mesh[train_cfg.data_axis].get_group()
        d_rank = mesh.get_local_rank(train_cfg.data_axis)
        log.info("%d processes, mesh %s", world, mesh)
    step_fn = make_train_step(cycle=args.cycle, oiou=args.oiou,
                              full_cycle=args.full_cycle,
                              aux_match_weight=args.aux_match,
                              heatmap_weight=args.heatmap,
                              size_weight=args.size_loss,
                              reweight_power=args.reweight, group=group)
    log.info("device %s, %d steps an epoch", device, steps_per_epoch)

    start_epoch, start_it = 0, 0
    if args.resume:
        last = latest_checkpoint_step(args.save_path)
        if last is not None:
            state = load_checkpoint(args.save_path, last, state)
            start_epoch = state.step // steps_per_epoch
            # Mid-epoch: skip the batches already consumed.
            start_it = (state.step % steps_per_epoch) * n_data
            log.info("resumed from step %d (epoch %d, it %d)", last,
                     start_epoch, start_it)
        else:
            log.info("--resume: no checkpoint under %s, starting fresh",
                     args.save_path)

    def reexec_segment():
        """Checkpoint, then replace this process by one resuming there."""
        save_checkpoint(args.save_path, state)
        argv_out = list(argv) if argv is not None else sys.argv[1:]
        if "--resume" not in argv_out:
            argv_out.append("--resume")
        log.info("segment limit %d reached at step %d: re-exec",
                 args.max_steps_per_segment, state.step)
        sys.stdout.flush()
        sys.stderr.flush()
        if distributed:
            dist.destroy_process_group()
        os.execv(sys.executable, [sys.executable, "-m",
                                  "oetr_tpu_torch.training.cli", *argv_out])

    writer = None
    if args.tensorboard and rank == 0:
        from ..utils.profiling import ScalarWriter
        writer = ScalarWriter(args.tensorboard)

    needs_geom = args.full_cycle or args.aux_match > 0
    dropout_gen = torch.Generator(device=device)
    segment_steps = 0
    for epoch in range(start_epoch, args.epochs):
        dataset.build_dataset()              # resample the pairs
        t0 = time.time()
        for it, batch in enumerate(
                dataset.batches(args.batch_size, geometry=needs_geom)):
            if it >= steps_per_epoch * n_data:
                break                        # a last, partial global step
            if epoch == start_epoch and it < start_it:
                continue
            # DistributedSampler's split: each data rank keeps every
            # n_data-th batch; the global batch is n_data x batch_size.
            if it % n_data != d_rank:
                continue
            dropout_gen.manual_seed(train_cfg.seed + 1 + state.step)
            state, metrics = step_fn(state, batch_to(batch, device),
                                     dropout_gen)
            segment_steps += 1
            if (args.max_steps_per_segment
                    and segment_steps >= args.max_steps_per_segment):
                reexec_segment()
            if it // n_data % args.log_every == 0 and rank == 0:
                m = {k: float(v) for k, v in metrics.items()}
                log.info("epoch %d it %d loss %.4f iou %.3f/%.3f (%.1f s)",
                         epoch, it, m["loss"], m["iou1"], m["iou2"],
                         time.time() - t0)
                if writer is not None:
                    writer.write(state.step, m)
        if val_dataset is not None:
            stats = evaluate(model, val_dataset.batches(args.batch_size),
                             oiou=args.oiou)
            log.info("epoch %d val R0.5 %.4f R0.75 %.4f R0.9 %.4f", epoch,
                     stats["R0.5"], stats["R0.75"], stats["R0.9"])
        save_checkpoint(args.save_path, state)
        log.info("epoch %d checkpointed at step %d", epoch, state.step)
    if writer is not None:
        writer.close()
    if distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
