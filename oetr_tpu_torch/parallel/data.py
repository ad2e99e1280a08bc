"""The loss of the global batch under data parallelism.

JAX's sharded step differentiates the loss of the whole batch: a masked
mean divides by the valid rows of every shard, a batch mean by the global
batch. DDP and FSDP average the ranks' gradients instead, which equals
that only when each rank's mean has the same denominator. Inside
``global_batch(group)`` the losses of the port divide by the all-reduced
denominators (``global_count``), each rank's dropout draws the global
batch's masks and keeps its own rows (``batch_shard``), and the step
scales its loss by the group's size before the backward (``loss_scale``),
so that the averaged gradient is the global batch's.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

# Stack of (group, size, rank) of the data axis the losses reduce over.
_ACTIVE: list[tuple] = []


@contextmanager
def global_batch(group):
    """Losses, counts and dropout inside refer to the batch of every rank
    of ``group`` (the data axis; None: this rank's batch alone). Each rank
    must hold the same number of rows."""
    if group is None:
        yield
        return
    _ACTIVE.append((group, dist.get_world_size(group),
                    dist.get_rank(group)))
    try:
        yield
    finally:
        _ACTIVE.pop()


def batch_shard() -> tuple[int, int] | None:
    """(ranks, this rank's index) of the active data axis, or None."""
    return (_ACTIVE[-1][1], _ACTIVE[-1][2]) if _ACTIVE else None


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a count or sum that takes no gradient) summed over the
    active data axis: a new tensor; ``x`` itself outside one."""
    if not _ACTIVE:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=_ACTIVE[-1][0])
    return y


def global_numel(n: int) -> int:
    """A batch-shaped count (rows, elements) over the active data axis:
    the ranks hold equal shapes, so ``n`` times their number."""
    return n * _ACTIVE[-1][1] if _ACTIVE else n


def loss_scale(group) -> int:
    """The factor on a rank's share of the global loss before the
    backward: DDP and FSDP average over ``group``, so its size."""
    return 1 if group is None else dist.get_world_size(group)


def sum_metrics(metrics: dict, group) -> dict:
    """Metrics that are each rank's share of a global value (its sum over
    the global denominator) summed over ``group``: one all-reduce."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=group)
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(keys)}


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch: its
    sum over the global element count (the plain mean outside
    ``global_batch``)."""
    if not _ACTIVE:
        return x.mean()
    return x.sum() / global_numel(x.numel())


def sync_params(module: torch.nn.Module, group) -> None:
    """Every rank of ``group`` takes the first rank's parameters (DDP's
    broadcast at construction)."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for p in module.parameters():
        dist.broadcast(p.data, src=src, group=group)


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """The parameters' gradients summed over ``group`` in one all-reduce
    (each rank's the gradient of its share of the global loss, so the sum
    is the global loss's); parameters without a gradient are skipped,
    which every rank must agree on."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
