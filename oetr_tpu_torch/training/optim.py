"""The update the matching trainers share: optax's global-norm clip and
piecewise-constant schedule on a torch optimizer.

JAX's trainers take any optax transform; their tests pass ``optax.adam``
and the demos ``optax.chain(clip_by_global_norm(1.0),
adam(piecewise_constant_schedule(lr, {0.7·steps: 0.1})))``. Here a step
takes a torch optimizer over the model's parameters, an optional
``StepScheduler`` (``training/train.py``) over
``piecewise_constant_schedule`` and an optional clip norm.
"""
from __future__ import annotations

import numpy as np
import torch


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict | None = None):
    """optax's ``piecewise_constant_schedule``: ``schedule(count)`` is
    ``init_value`` times the scale of every boundary that ``count`` has
    reached, in float32 as optax computes it."""
    steps = sorted((boundaries_and_scales or {}).items())

    def schedule(count: int) -> float:
        v = np.float32(init_value)
        for boundary, scale in steps:
            if count >= boundary:
                v = np.float32(scale) * v
        return float(v)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm of
    ``grads`` is at least ``max_norm``, each becomes g / norm · max_norm;
    below it they stay as they are (``torch.nn.utils.clip_grad_norm_``
    scales by max_norm / (norm + 1e-6) instead). Nothing is read back to
    the host. Returns the norm, a tensor on the gradients' device."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    denom = torch.where(keep, torch.ones_like(norm), norm)
    factor = torch.where(keep, torch.ones_like(norm),
                         torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom).mul_(factor)
    return norm


def apply_update(params, optimizer: torch.optim.Optimizer, scheduler=None,
                 clip_norm: float | None = None) -> None:
    """After the backward: give every parameter without a gradient a zero
    one (optax updates every leaf; torch's optimizers skip a parameter
    without one, and its step count would fall behind), clip as optax
    does when ``clip_norm`` is set, take the optimizer's step, then the
    scheduler's."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip_norm is not None:
        clip_by_global_norm_([p.grad for p in params], clip_norm)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
