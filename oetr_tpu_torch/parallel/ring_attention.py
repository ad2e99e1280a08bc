"""Sequence-parallel exact softmax attention over a process group (port of
``oetr_tpu/parallel/ring_attention.py``).

Each rank holds a block of the K/V sequence. ``ring_attention`` computes
streaming-softmax partials against its block, then the blocks move one hop
around the ring (``batch_isend_irecv``: rank r sends to r + 1); after n
steps every query has seen every key once, the online-softmax accumulation
of JAX term for term. ``ulysses_attention`` trades sequence blocks for head
blocks with two all-to-alls and attends locally. JAX's version is plain
einsum inside ``shard_map``, not a Pallas kernel, so this one is plain
torch. Both are differentiable: the ring's hop is an autograd function
whose backward sends the gradient the other way, and the all-to-alls are
``torch.distributed.nn``'s.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

# Process groups that 'full:ring' attention in model code shards over
# (models/transformer.py:_attend reads the innermost).
_RING_CTX: list = []


def _group(group, axis: str):
    """A process group from a group, a DeviceMesh (its ``axis``), or None
    (the default group)."""
    if group is not None and hasattr(group, "mesh_dim_names"):
        return group.get_group(axis)
    return group if group is not None else dist.group.WORLD


@contextmanager
def ring_context(group=None, axis: str = "seq"):
    """Any ``attention='full:ring'`` layer called inside shards its K/V
    sequence over ``group`` (a process group, a DeviceMesh's ``axis``, or
    the default group when None)."""
    _RING_CTX.append(_group(group, axis))
    try:
        yield
    finally:
        _RING_CTX.pop()


def current_ring_context():
    """The innermost ``ring_context``'s group, or None."""
    return _RING_CTX[-1] if _RING_CTX else None


def _shift(xs, group, step: int) -> list[torch.Tensor]:
    """Each tensor of ``xs`` sent ``step`` ranks on around the ring, the
    one from ``step`` ranks back received in its place."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(xs)
    r = dist.get_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x, dst, group, tag=i)
           for i, x in enumerate(xs)]
    ops += [dist.P2POp(dist.irecv, o, src, group, tag=i)
            for i, o in enumerate(outs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """One hop around the ring; the first ``n_grad`` tensors carry
    gradients, which the backward sends one hop back."""

    @staticmethod
    def forward(ctx, group, n_grad: int, *xs):
        ctx.group, ctx.n_grad = group, n_grad
        return tuple(_shift(xs, group, 1))

    @staticmethod
    def backward(ctx, *grads):
        gs = [torch.zeros_like(g) if g is None else g
              for g in grads[:ctx.n_grad]]
        back = _shift(gs, ctx.group, -1)
        return (None, None, *back, *([None] * (len(grads) - ctx.n_grad)))


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor: float):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class _TakeBlock(torch.autograd.Function):
    """This rank's block of dim 1 of a tensor every rank holds whole; the
    backward gathers the blocks' gradients, so the whole tensor's gradient
    is complete on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        blk = x.shape[1] // n
        ctx.group = group
        return x[:, r * blk:(r + 1) * blk].clone()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in
                 range(dist.get_world_size(ctx.group))]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=1), None


def take_block(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of the sequence (dim 1) of ``x``, which every rank
    of ``group`` holds whole: rank i takes block i. Differentiable: the
    gradient of ``x`` gathers every rank's block."""
    return _TakeBlock.apply(x, _group(group, "seq"))


def _block_attend(q, k, v, acc, row_max, row_sum, kv_mask):
    """One streaming-softmax block update.

    q: [B, Lq, H, D]; k, v: [B, Lk, H, D]; acc: [B, Lq, H, D];
    row_max/row_sum: [B, Lq, H]; kv_mask: [B, Lk] float (1 valid).
    """
    temp = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("blhd,bshd->blsh", q, k) * temp    # [B, Lq, Lk, H]
    logits = torch.where(kv_mask[:, None, :, None] > 0, logits,
                         float("-inf"))

    blk_max = logits.amax(dim=2)                              # [B, Lq, H]
    new_max = torch.maximum(row_max, blk_max)
    new_max_safe = torch.where(torch.isfinite(new_max), new_max, 0.0)
    correction = torch.exp(row_max - new_max_safe)
    correction = torch.where(torch.isfinite(row_max), correction, 0.0)

    p = torch.exp(logits - new_max_safe[:, :, None, :])
    p = torch.where(torch.isfinite(logits), p, 0.0)
    blk_sum = p.sum(dim=2)
    acc = acc * correction[..., None] + torch.einsum("blsh,bshd->blhd", p, v)
    row_sum = row_sum * correction + blk_sum
    return acc, new_max, row_sum


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, kv_mask: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Exact softmax attention with K/V sharded over ``group``.

    Args:
      q: [B, L, H, D], the same queries on every rank.
      k, v: [B, S/n, H, D], this rank's block of the keys (rank i holds
        block i of the global sequence).
      kv_mask: optional [B, S/n] bool, this rank's block.
    Returns [B, L, H, D]: attention over the FULL key set, on every rank.

    Gradients: every rank computes the same loss from the replicated
    output, so each rank's q gets the whole gradient, and its k and v
    blocks their blocks' (every rank's use of a block, over n).
    """
    group = _group(group, "seq")
    n = dist.get_world_size(group)
    if n > 1 and torch.is_grad_enabled():
        k, v = _ScaleGrad.apply(k, 1.0 / n), _ScaleGrad.apply(v, 1.0 / n)
    b, s = k.shape[0], k.shape[1]
    m = (torch.ones((b, s), dtype=torch.float32, device=k.device)
         if kv_mask is None else kv_mask.to(torch.float32))
    qf = q.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    row_max = torch.full(q.shape[:3], float("-inf"), device=q.device)
    row_sum = torch.zeros(q.shape[:3], device=q.device)
    for i in range(n):
        acc, row_max, row_sum = _block_attend(qf, k.float(), v.float(), acc,
                                              row_max, row_sum, m)
        if i < n - 1:
            k, v, m = _RingShift.apply(group, 2, k, v, m)
    out = acc / torch.clamp(row_sum[..., None], min=1e-30)
    return out.to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: slice j to rank j; returns [n, ...], slice j from rank j
    (differentiable)."""
    from torch.distributed.nn.functional import all_to_all_single
    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, kv_mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Ulysses sequence parallelism: one all-to-all makes the sequence
    blocks head blocks (each rank then holds H/n heads of the full length),
    attention runs locally (the plain ``full_attention``), and a second
    all-to-all gives the sequence blocks back.

    Args:
      q: [B, L/n, H, D]; k, v: [B, S/n, H, D], this rank's sequence blocks;
        H divisible by the group's size.
      kv_mask: optional [B, S/n] bool, this rank's block.
    Returns [B, L/n, H, D], this rank's block of full softmax attention.
    """
    from ..ops.attention import full_attention

    group = _group(group, "seq")
    n = dist.get_world_size(group)
    b, s = k.shape[0], k.shape[1]
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by the group's "
                         f"{n} ranks")
    if kv_mask is None:
        kv_mask = torch.ones((b, s), dtype=torch.bool, device=k.device)

    def seq_to_head(x):      # [B, L/n, H, D] -> [B, L, H/n, D]
        bb, lb, h, d = x.shape
        x = x.reshape(bb, lb, n, h // n, d).permute(2, 0, 1, 3, 4)
        y = _all_to_all(x, group)                    # [n, B, L/n, H/n, D]
        return y.permute(1, 0, 2, 3, 4).reshape(bb, n * lb, h // n, d)

    def head_to_seq(x):      # [B, L, H/n, D] -> [B, L/n, H, D]
        bb, ll, hn, d = x.shape
        x = x.reshape(bb, n, ll // n, hn, d).permute(1, 0, 2, 3, 4)
        y = _all_to_all(x, group)                    # [n, B, L/n, H/n, D]
        return y.permute(1, 2, 0, 3, 4).reshape(bb, ll // n, n * hn, d)

    parts = [torch.empty_like(kv_mask, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(parts, kv_mask.to(torch.uint8).contiguous(), group=group)
    m_full = torch.cat(parts, dim=1).bool()
    out = full_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                         None, m_full)
    return head_to_seq(out)
