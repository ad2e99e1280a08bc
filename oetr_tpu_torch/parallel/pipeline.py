"""GPipe pipeline parallelism over a process group (port of
``oetr_tpu/parallel/pipeline.py``).

One stage a rank. Stage parameters come stacked along a leading stage
dimension, and rank i runs slice i. Microbatches enter at stage 0, and
each tick the activations move one rank on around the ring (send and
recv); the last stage commits its outputs, which then reach every rank as
JAX's psum gives them. The schedule is JAX's: M + S - 1 ticks, stage i at
tick t works on microbatch t - i (clipped, as JAX computes the idle
ticks too). Per-microbatch constants (``aux``: masks, positional
encodings) are indexed locally, never sent.

It is differentiable, as JAX's ``scan`` + ``ppermute`` is: the schedule is
one autograd function that keeps each tick's graph (GPipe keeps every
activation for the backward) and whose backward runs the ticks in
reverse, sending each input's gradient one rank back. Every rank takes
part in every exchange, idle ticks included (their gradients are zeros),
so the ranks never wait on a send that autograd skipped. The outputs'
gradient is taken on the last stage: every rank computes the same loss
from the replicated outputs, as in JAX's test of it.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .ring_attention import _group, _shift


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, n_params: int, *flat):
        params, mbs = list(flat[:n_params]), list(flat[n_params:])
        track = run["track"]
        idx, n_stages, n_micro = run["idx"], run["n_stages"], run["n_micro"]
        group = run["group"]
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        stage = pytree.tree_unflatten(leaves, run["param_spec"])
        state = [torch.zeros_like(x[0]) for x in mbs]
        outputs = [torch.zeros_like(x) for x in mbs]
        ticks = []
        for t in range(n_micro + n_stages - 1):
            feed = min(max(t, 0), n_micro - 1)
            inp = [x[feed] for x in mbs] if idx == 0 else state
            inp = [i.detach().requires_grad_(track) for i in inp]
            mine = min(max(t - idx, 0), n_micro - 1)
            aux_m = pytree.tree_map(lambda a: a[mine], run["aux"])
            with torch.set_grad_enabled(track):
                out = run["stage_fn"](stage, pytree.tree_unflatten(
                    inp, run["mb_spec"]), aux_m)
            out = pytree.tree_leaves(out)
            done = t - (n_stages - 1)
            if idx == n_stages - 1 and done >= 0:
                for acc, y in zip(outputs, out):
                    acc[done] = y.detach()
            if track:
                ticks.append((inp, out))
            state = _shift([y.detach() for y in out], group, 1)
        # Outputs are filled on the last stage only; replicate them.
        for o in outputs:
            dist.all_reduce(o, group=group)
        ctx.run, ctx.ticks, ctx.leaves = run, ticks, leaves
        ctx.n_params = n_params
        return tuple(outputs)

    @staticmethod
    def backward(ctx, *g_outputs):
        run, ticks, leaves = ctx.run, ctx.ticks, ctx.leaves
        idx, n_stages, n_micro = run["idx"], run["n_stages"], run["n_micro"]
        group = run["group"]
        wanted = [p for p in leaves if p.requires_grad]
        p_grads = [torch.zeros_like(p) for p in wanted]
        mb_grads = [torch.zeros((n_micro,) + tuple(o.shape),
                                dtype=o.dtype, device=o.device)
                    for o in ticks[0][1]]
        from_next = None
        for t in reversed(range(len(ticks))):
            inp, out = ticks[t]
            g_out = [torch.zeros_like(y) for y in out]
            done = t - (n_stages - 1)
            if idx == n_stages - 1 and done >= 0:
                g_out = [g + (0 if go is None else go[done])
                         for g, go in zip(g_out, g_outputs)]
            if from_next is not None:
                g_out = [g + r for g, r in zip(g_out, from_next)]
            grads = torch.autograd.grad(out, inp + wanted, g_out,
                                        allow_unused=True)
            g_inp = [torch.zeros_like(i) if g is None else g
                     for i, g in zip(inp, grads[:len(inp)])]
            for acc, g in zip(p_grads, grads[len(inp):]):
                if g is not None:
                    acc += g
            if idx == 0:
                feed = min(max(t, 0), n_micro - 1)
                for acc, g in zip(mb_grads, g_inp):
                    acc[feed] += g
                # Stage 0 read the microbatches, not the last stage's
                # activation: nothing flows back around the ring.
                g_inp = [torch.zeros_like(g) for g in g_inp]
            if t > 0:
                from_next = _shift(g_inp, group, -1)
        if any(ctx.needs_input_grad[2 + ctx.n_params:]):
            for g in mb_grads:
                dist.all_reduce(g, group=group)
        it = iter(p_grads)
        out_p = [next(it) if p.requires_grad else None for p in leaves]
        return (None, None, *out_p, *mb_grads)


def gpipe(stage_fn: Callable, stacked_params: Any, microbatches: Any,
          group=None, aux: Any = None) -> Any:
    """Run ``microbatches`` through a pipeline of identical stages.

    Args:
      stage_fn: ``(params_one_stage, x, aux_m) -> y`` (``(params, x) -> y``
        without ``aux``), ``y`` shaped like ``x`` (a pytree of tensors).
      stacked_params: pytree of tensors with a leading stage dimension of
        the group's size; rank i runs slice i.
      microbatches: pytree of float tensors with leading dimension M, the
        same on every rank.
      group: the pipeline's process group (a DeviceMesh's 'pipe' axis, or
        the default group when None).
      aux: optional pytree with leading dimension M of per-microbatch
        constants, the same on every rank; not differentiated.

    Returns the outputs, structured as ``microbatches``, on every rank.
    """
    group = _group(group, "pipe")
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    p_leaves, p_spec = pytree.tree_flatten(stacked_params)
    lead = p_leaves[0].shape[0]
    if lead != n_stages:
        raise ValueError(
            f"stacked_params leading dim {lead} != the pipe group's "
            f"{n_stages} ranks: exactly one stage per rank is required")
    mb_leaves, mb_spec = pytree.tree_flatten(microbatches)
    stage = [p[idx] for p in p_leaves]
    have_aux = aux is not None
    fn = stage_fn if have_aux else (lambda p, x, _: stage_fn(p, x))
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in stage + mb_leaves)
    run = {"stage_fn": fn, "param_spec": p_spec, "mb_spec": mb_spec,
           "aux": aux if have_aux else (), "group": group, "idx": idx,
           "n_stages": n_stages, "n_micro": mb_leaves[0].shape[0],
           "track": track}
    out = _GPipe.apply(run, len(stage), *stage, *mb_leaves)
    return pytree.tree_unflatten(list(out), mb_spec)


# ---------------------------------------------------------------------------
# OETR encoder as a pipeline
# ---------------------------------------------------------------------------

def stack_encoder_stages(transformer, num_layers: int) -> dict:
    """The ``enc_self_i``/``enc_cross_i`` parameters of a QueryTransformer
    (a module, or a {name: tensor} mapping of its parameters) stacked along
    a stage dimension: {"self": {leaf: [L, ...]}, "cross": {...}}, leaf the
    EncoderLayer's own parameter names. Stacking is differentiable."""
    params = (dict(transformer.named_parameters())
              if isinstance(transformer, torch.nn.Module) else
              dict(transformer))

    def stacked(kind):
        pre = [f"enc_{kind}_{i}." for i in range(num_layers)]
        leaves = sorted(k[len(pre[0]):] for k in params
                        if k.startswith(pre[0]))
        return {leaf: torch.stack([params[p + leaf] for p in pre])
                for leaf in leaves}

    return {"self": stacked("self"), "cross": stacked("cross")}


def make_encoder_stage(d_model: int, nhead: int, attention: str = "linear",
                       dtype: torch.dtype = torch.float32) -> Callable:
    """Stage fn: one (self, cross) encoder layer pair on a doubled batch.

    The activation is ``x = cat([feat0, feat1])`` ([2b, N, C]); aux is
    ``(mask, pos)`` stacked the same way. Self-attention is batch-local;
    cross-attention's source is the other image, a half-batch roll: the
    sequential four calls of ``QueryTransformer.forward``.
    """
    from torch.func import functional_call

    from ..models.transformer import EncoderLayer

    with torch.device("meta"):
        layer = EncoderLayer(d_model, nhead, attention, dtype)

    def stage(params, x, aux):
        mask, pos = aux
        half = x.shape[0] // 2
        x = functional_call(layer, params["self"],
                            (x, x, mask, mask, pos, pos))
        src = torch.roll(x, half, dims=0)
        src_mask = torch.roll(mask, half, dims=0)
        src_pos = torch.roll(pos, half, dims=0)
        return functional_call(layer, params["cross"],
                               (x, src, mask, src_mask, pos, src_pos))

    return stage


def pipelined_encoder(transformer, feat0: torch.Tensor, feat1: torch.Tensor,
                      pos0: torch.Tensor, pos1: torch.Tensor, group=None, *,
                      mask0: torch.Tensor | None = None,
                      mask1: torch.Tensor | None = None,
                      num_layers: int = 4, nhead: int = 8,
                      attention: str = "linear", n_micro: int | None = None,
                      dtype: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder stack of a QueryTransformer (module or parameter
    mapping) as a pipeline of ``num_layers`` (self, cross) stages, one a
    rank of ``group`` (whose size must be ``num_layers``); batch divisible
    by ``n_micro`` (the stage count by default). Returns ``(feat0,
    feat1)`` contextualized, on every rank."""
    group = _group(group, "pipe")
    b, n, c = feat0.shape
    size = dist.get_world_size(group)
    if size != num_layers:
        raise ValueError(f"{num_layers} encoder layers need a pipe group of "
                         f"{num_layers} ranks, have {size}")
    n_micro = n_micro if n_micro is not None else size
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    mb = b // n_micro

    def to_mb(a0, a1):
        # [M, 2*mb, ...]: microbatch m carries rows m*mb:(m+1)*mb of both
        # images, image 0 first.
        a0 = a0.reshape(n_micro, mb, *a0.shape[1:])
        a1 = a1.reshape(n_micro, mb, *a1.shape[1:])
        return torch.cat([a0, a1], dim=1)

    x = to_mb(feat0, feat1)
    pos = to_mb(pos0.expand(feat0.shape), pos1.expand(feat1.shape))
    if mask0 is None:
        mask = torch.ones((n_micro, 2 * mb, n), dtype=torch.bool,
                          device=feat0.device)
    else:
        mask = to_mb(mask0, mask1)

    stacked = stack_encoder_stages(transformer, num_layers)
    stage = make_encoder_stage(c, nhead, attention, dtype)
    out = gpipe(stage, stacked, x, group, aux=(mask, pos))
    out = out.reshape(n_micro, 2, mb, n, c)
    return out[:, 0].reshape(b, n, c), out[:, 1].reshape(b, n, c)
