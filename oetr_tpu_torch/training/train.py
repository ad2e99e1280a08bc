"""OETR training on one device (port of ``oetr_tpu/training/train.py``).

AdamW (lr 1e-4, weight decay 1e-2, b1 0.9, b2 0.999, eps 1e-8, every
parameter decayed) under optax's piecewise-constant schedule: the rate is
multiplied by ``lr_gamma`` once the optimizer's step count reaches each
milestone epoch times ``steps_per_epoch``; the schedule steps once per
optimizer step. torch's decoupled decay p·(1 - lr·wd) is optax's
``add_decayed_weights`` scaled by -lr.

Checkpoints are JAX's: ``{dir}/step_{N}`` is the orbax directory of JAX's
``TrainState`` (``interop.write_checkpoint``), with ``step`` (int32),
``params`` (the flax tree) and ``opt_state``, optax AdamW's
``(ScaleByAdamState(count, mu, nu), EmptyState(),
ScaleByScheduleState(count))`` (``jax_state.py``: torch's ``exp_avg`` and
``exp_avg_sq`` as mu and nu, the schedule's count). A run resumes exactly,
in the port or in JAX, and a JAX run resumes here. A ``step_N`` file is
the port's earlier torch checkpoint, and is still read.

Over several ranks, ``shard_train_state`` lays the model out on a mesh
(``parallel.shard_model``: DDP over 'data', Megatron splits over 'model',
FSDP2 over 'fsdp') and ``make_train_step(group=...)`` takes the data
axis's group: each rank holds its rows of the global batch, and the loss
is the global batch's (``parallel.data``), as JAX's sharded step
differentiates it. Checkpoints are full state dicts, written by rank 0, so
a run resumes on any layout.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import OETRConfig, TrainConfig
from ..interop.orbax_read import read_checkpoint
from ..interop.orbax_write import write_checkpoint
from ..models.oetr import OETR, build_oetr
from .losses import (aux_match_loss, cycle_overlap_loss, difficulty_weights,
                     heatmap_ce_loss, oetr_losses, size_loss, total_loss)
from ..parallel.data import global_batch, loss_scale, sum_metrics
from ..interop.from_flax import to_flax
from .jax_state import (adam_tree, check_layout, full_state_dicts, load_adam,
                        load_params)
from .optim import apply_update, piecewise_constant_schedule


def multistep_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """MultiStepLR over epochs as optax's ``piecewise_constant_schedule(lr,
    {m · steps_per_epoch: gamma})``: ``schedule(count)`` is lr times gamma
    for every boundary that count has reached, in float32 as optax
    computes it."""
    return piecewise_constant_schedule(
        cfg.lr, {m * steps_per_epoch: cfg.lr_gamma
                 for m in cfg.lr_milestones})


class StepScheduler:
    """Sets every parameter group's rate to ``schedule(count)``, count the
    optimizer steps taken; ``step()`` after each optimizer step."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule):
        self.optimizer, self.schedule, self.count = optimizer, schedule, 0
        self._apply()

    def _apply(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)

    def step(self) -> None:
        self.count += 1
        self._apply()

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self._apply()


def make_optimizer(cfg: TrainConfig, params, steps_per_epoch: int = 1):
    """(AdamW over ``params``, its StepScheduler). On CUDA parameters torch
    takes its foreach implementation, whose in-place updates move each
    parameter's version counter (which K2's cache of bf16 weights
    watches)."""
    optimizer = torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=cfg.weight_decay)
    return optimizer, StepScheduler(
        optimizer, multistep_schedule(cfg, steps_per_epoch))


@dataclass
class TrainState:
    step: int
    model: OETR
    optimizer: torch.optim.Optimizer
    scheduler: StepScheduler
    # The module the step calls: the model under DDP after
    # ``shard_train_state`` (None: the model itself).
    module: torch.nn.Module | None = None


def create_train_state(model_cfg: OETRConfig, train_cfg: TrainConfig,
                       generator: torch.Generator | None = None,
                       steps_per_epoch: int = 1, device="cuda"
                       ) -> tuple[OETR, TrainState]:
    """(model, TrainState): the model built on ``device`` from
    ``generator`` (a CPU generator; seed 0 when None) in training mode,
    with its optimizer and schedule."""
    model = build_oetr(model_cfg, device=device, generator=generator)
    model.train()
    optimizer, scheduler = make_optimizer(train_cfg, model.parameters(),
                                          steps_per_epoch)
    return model, TrainState(0, model, optimizer, scheduler)


def loss_fn(model: OETR, batch: dict, generator: torch.Generator | None,
            cycle: bool, oiou: bool, full_cycle: bool = False,
            aux_match_weight: float = 0.0, aux_match_stride: int = 32,
            heatmap_weight: float = 0.0, size_weight: float = 0.0,
            reweight_power: float = 0.0):
    """Forward and losses on one batch: (total loss, loss and metric dict).

    batch: image1/image2 [B, H, W, 3], overlap_box1/2 [B, 4],
    overlap_valid [B] bool, optional mask1/mask2 (feature-resolution
    validity). ``full_cycle`` adds the depth-warped cycle loss and
    ``aux_match_weight`` > 0 the token InfoNCE; both read K1/2, depth1/2,
    pose1/2, crop1/2 and ratio1/2. ``heatmap_weight`` adds the dense
    heat-map cross-entropy, ``size_weight`` the tlbr size loss, and
    ``reweight_power`` > 0 scales per-pair losses by ``difficulty_weights``.
    ``generator`` draws the decoder's dropout masks.
    """
    h1, w1 = batch["image1"].shape[1:3]
    h2, w2 = batch["image2"].shape[1:3]
    out = model(batch["image1"], batch["image2"], batch.get("mask1"),
                batch.get("mask2"), with_cycle=cycle, generator=generator)
    wts = None
    if reweight_power > 0.0:
        wts = difficulty_weights(batch["overlap_box1"], batch["overlap_box2"],
                                 (h1, w1), (h2, w2), power=reweight_power)
    losses = oetr_losses(out, batch["overlap_box1"], batch["overlap_box2"],
                         batch["overlap_valid"], (h1, w1), (h2, w2),
                         oiou=oiou, weights=wts)
    if size_weight > 0.0:
        losses["size_loss"] = size_weight * size_loss(
            out, batch["overlap_box1"], batch["overlap_box2"],
            batch["overlap_valid"], (h1, w1), (h2, w2), weights=wts)
    if full_cycle:
        losses["cycle_overlap_loss"] = cycle_overlap_loss(
            out["pred_bbox1"], out["pred_bbox2"],
            batch["K1"], batch["depth1"], batch["pose1"], batch["crop1"],
            batch["ratio1"], batch["K2"], batch["depth2"], batch["pose2"],
            batch["crop2"], batch["ratio2"], batch["overlap_valid"])
    if aux_match_weight > 0.0:
        losses["aux_match_loss"] = aux_match_weight * aux_match_loss(
            out, batch, aux_match_stride)
    if heatmap_weight > 0.0:
        losses["heatmap_loss"] = heatmap_weight * (
            heatmap_ce_loss(out["prob_map1"], batch["overlap_box1"],
                            batch["overlap_valid"], (h1, w1), weights=wts)
            + heatmap_ce_loss(out["prob_map2"], batch["overlap_box2"],
                              batch["overlap_valid"], (h2, w2),
                              weights=wts)) / 2.0
    return total_loss(losses), losses


def make_train_step(cycle: bool = False, oiou: bool = False,
                    full_cycle: bool = False, aux_match_weight: float = 0.0,
                    aux_match_stride: int = 32, heatmap_weight: float = 0.0,
                    size_weight: float = 0.0, reweight_power: float = 0.0,
                    group=None):
    """``step(state, batch, generator) -> (state, metrics)``: a forward in
    training mode, the backward, the AdamW update and the schedule's step.
    ``batch`` holds tensors on the model's device; ``generator`` (on that
    device) draws the dropout masks. ``metrics`` is the loss dict plus
    ``loss``, tensors on the device: nothing is read back in the step.
    The state's model and optimizer are updated in place.

    ``group``: the data axis's process group. ``batch`` is then this
    rank's rows (every rank the same number) and the step JAX's over the
    global batch: the losses divide by global counts, the dropout masks
    are the global batch's rows, the gradient averaged by DDP or FSDP is
    the global loss's, and the metrics are the global batch's on every
    rank."""
    scale = loss_scale(group)

    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with global_batch(group):
            loss, metrics = loss_fn(state.module or model, batch, generator,
                                    cycle, oiou, full_cycle,
                                    aux_match_weight, aux_match_stride,
                                    heatmap_weight, size_weight,
                                    reweight_power)
        (loss if scale == 1 else loss * scale).backward()
        # optax updates every leaf (a zero gradient still decays it).
        apply_update(model.parameters(), state.optimizer, state.scheduler)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, sum_metrics(metrics, group)

    return step


def shard_train_state(state: TrainState, mesh, rules=None,
                      fsdp_axis: str | None = None,
                      data_axis: str = "data"):
    """(state, specs) for training on ``mesh``: the state's model laid out
    in place by ``parallel.shard_model`` (DDP, TP, FSDP2; specs as JAX's
    ``param_shardings``), ``state.module`` the module the step calls, and
    the optimizer moved onto the new parameters. Call it before the first
    step and before loading a checkpoint (the optimizer must hold no
    state yet)."""
    from ..parallel.mesh import shard_model

    if state.optimizer.state:
        raise ValueError("shard the state before its first step or load: "
                         "the optimizer already holds state")
    old = list(state.model.parameters())
    module, specs = shard_model(state.model, mesh, rules, fsdp_axis,
                                data_axis)
    new = dict(zip(map(id, old), state.model.parameters()))
    for g in state.optimizer.param_groups:
        g["params"] = [new[id(p)] for p in g["params"]]
    state.module = None if module is state.model else module
    return state, specs


def _norm(g: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a gradient; of a sharded one (DTensor) the whole
    tensor's: its shard's sum of squares summed over the mesh dimensions
    that shard it."""
    if not hasattr(g, "to_local"):
        return torch.linalg.vector_norm(g.float())
    sq = g.to_local().float().pow(2).sum()
    for dim, placement in enumerate(g.placements):
        # Shard and FSDP's _StridedShard (not a Shard) split the tensor.
        if not (placement.is_replicate() or placement.is_partial()):
            dist.all_reduce(sq, group=g.device_mesh.get_group(dim))
    return sq.sqrt()


def global_grad_norm(model: torch.nn.Module) -> torch.Tensor:
    """The L2 norm of all parameter gradients together (after a step, the
    gradients that step applied), a tensor on the device; under TP and
    FSDP the norm of the whole gradient (every rank calls it)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack([_norm(g) for g in grads]))


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


# optax.adamw's state: scale_by_adam, add_decayed_weights, the schedule.
ADAMW_LAYOUT = {"step": None, "params": ...,
                "opt_state": [{"count": None, "mu": ..., "nu": ...},
                              "empty", {"count": None}]}


def train_state_tree(state: TrainState) -> dict | None:
    """The state as JAX's ``TrainState`` tree (numpy leaves; ``None`` for
    optax's ``EmptyState``). Every rank calls it (the gathers are
    collective); under a process group ranks other than 0 get None."""
    model_sd, optim_sd = full_state_dicts(state.model, state.optimizer)
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return {"step": np.int32(state.step),
            "params": to_flax(model_sd, state.model),
            "opt_state": [adam_tree(state.model, optim_sd), None,
                          {"count": np.int32(state.scheduler.count)}]}


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: int | None = None) -> str:
    """The full state to ``{ckpt_dir}/step_{step}`` (the state's step by
    default) in JAX's layout (module docstring), replacing one there; the
    path. Whole whatever the layout: every rank calls it and rank 0
    writes."""
    step = state.step if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step}")
    tree = train_state_tree(state)
    if tree is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
        write_checkpoint(path, tree)
    if dist.is_initialized():
        dist.barrier()
    return path


def _load_torch_checkpoint(path: str, target: TrainState) -> TrainState:
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

    opts = StateDictOptions(full_state_dict=True)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    set_model_state_dict(target.model, saved["model"], options=opts)
    set_optimizer_state_dict(target.model, target.optimizer,
                             saved["optimizer"], options=opts)
    target.scheduler.load_state_dict(saved["scheduler"])
    target.step = int(saved["step"])
    return target


def load_checkpoint(ckpt_dir: str, step: int,
                    target: TrainState) -> TrainState:
    """``target`` (a state of the same configuration, on any layout) with
    the state saved under ``{ckpt_dir}/step_{step}`` loaded into it: JAX's
    ``TrainState`` directory, written by JAX's trainer or the port's, or
    the port's earlier torch file. Every rank reads it. Raises ValueError
    on an optimizer state other than optax AdamW's, KeyError or
    ValueError on a parameter tree that lacks a leaf, has one the model
    lacks, or a wrong shape."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.isfile(path):
        return _load_torch_checkpoint(path, target)
    tree = read_checkpoint(path)
    check_layout(tree, ADAMW_LAYOUT, f"{path}: TrainState")
    load_params(target.model, tree["params"])
    load_adam(target.model, target.optimizer, tree["opt_state"][0])
    target.scheduler.load_state_dict(
        {"count": int(tree["opt_state"][2]["count"])})
    target.step = int(tree["step"])
    return target


def latest_checkpoint_step(ckpt_dir: str) -> int | None:
    """The largest N of ``step_N`` under ckpt_dir, or None."""
    try:
        steps = [int(d.removeprefix("step_")) for d in os.listdir(ckpt_dir)
                 if d.startswith("step_")
                 and d.removeprefix("step_").isdigit()]
    except FileNotFoundError:
        return None
    return max(steps, default=None)
