"""OETR training on one device (port of ``oetr_tpu/training/train.py``).

AdamW (lr 1e-4, weight decay 1e-2, b1 0.9, b2 0.999, eps 1e-8, every
parameter decayed) under optax's piecewise-constant schedule: the rate is
multiplied by ``lr_gamma`` once the optimizer's step count reaches each
milestone epoch times ``steps_per_epoch``; the schedule steps once per
optimizer step. torch's decoupled decay p·(1 - lr·wd) is optax's
``add_decayed_weights`` scaled by -lr. Checkpoints hold the full state
(step, model, optimizer, schedule) under ``{dir}/step_{N}``, the names of
JAX's orbax directories, so a run resumes exactly.

JAX's step runs over a mesh (``mesh``, ``state_shardings``,
``shard_train_state``); this one runs on the model's device alone.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..config import OETRConfig, TrainConfig
from ..models.oetr import OETR, build_oetr
from .losses import (aux_match_loss, cycle_overlap_loss, difficulty_weights,
                     heatmap_ce_loss, oetr_losses, size_loss, total_loss)
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
                    size_weight: float = 0.0, reweight_power: float = 0.0):
    """``step(state, batch, generator) -> (state, metrics)``: a forward in
    training mode, the backward, the AdamW update and the schedule's step.
    ``batch`` holds tensors on the model's device; ``generator`` (on that
    device) draws the dropout masks. ``metrics`` is the loss dict plus
    ``loss``, tensors on the device: nothing is read back in the step.
    The state's model and optimizer are updated in place."""
    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None):
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch, generator, cycle, oiou,
                                full_cycle, aux_match_weight,
                                aux_match_stride, heatmap_weight,
                                size_weight, reweight_power)
        loss.backward()
        # optax updates every leaf (a zero gradient still decays it).
        apply_update(model.parameters(), state.optimizer, state.scheduler)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    return step


def global_grad_norm(model: torch.nn.Module) -> torch.Tensor:
    """The L2 norm of all parameter gradients together (after a step, the
    gradients that step applied), a tensor on the device."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    step: int | None = None) -> str:
    """The full state (step, model, optimizer, schedule) to
    ``{ckpt_dir}/step_{step}`` (the state's step by default); the path."""
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}")
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()}, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(ckpt_dir: str, step: int,
                    target: TrainState) -> TrainState:
    """``target`` (a state of the same configuration) with the state saved
    under ``{ckpt_dir}/step_{step}`` loaded into it, on its device."""
    device = next(target.model.parameters()).device
    saved = torch.load(os.path.join(ckpt_dir, f"step_{step}"),
                       map_location=device, weights_only=True)
    target.model.load_state_dict(saved["model"])
    target.optimizer.load_state_dict(saved["optimizer"])
    target.scheduler.load_state_dict(saved["scheduler"])
    target.step = int(saved["step"])
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
