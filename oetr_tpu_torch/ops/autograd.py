"""Gradients through the kernels, as the JAX package defines them.

Each differentiable JAX kernel wraps its pallas_call in a
``jax.custom_vjp`` whose backward is the VJP of a plain function,
recomputed from the saved inputs: ``_with_xla_vjp`` for K1, K5 and K6
(``oetr_tpu/ops/pallas_attention.py``), K2's own, and
``groupnorm_relu_maxpool_trainable`` for K3 (``ops/pallas_norm.py``).
``KernelFunction`` is that pattern as a ``torch.autograd.Function``: its
forward is the wrapper's launch (the kernel on a CUDA tensor, its plain
version on a CPU tensor), its backward torch autograd of the port's copy of
the plain function that JAX differentiates.

A wrapper goes through it only when ``needs_grad``; otherwise it launches
as it would without autograd, so inference pays nothing for it.
"""
from __future__ import annotations

import torch


def needs_grad(*args) -> bool:
    """True when grad mode is on and a tensor among ``args`` requires
    grad."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class KernelFunction(torch.autograd.Function):
    """``apply(forward, vjp_fn, *args)``: ``forward(*args)`` with no graph;
    the backward recomputes ``vjp_fn(*args)`` from the saved inputs and
    returns its gradients for the inputs that require grad (None for the
    others: masks, integers, floats)."""

    @staticmethod
    def forward(ctx, forward, vjp_fn, *args):
        ctx.vjp_fn = vjp_fn
        ctx.tensor_at = [i for i, a in enumerate(args)
                         if isinstance(a, torch.Tensor)]
        ctx.others = [None if isinstance(a, torch.Tensor) else a
                      for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.tensor_at))
        return forward(*args)

    @staticmethod
    def backward(ctx, grad):
        args = list(ctx.others)
        wanted = []
        for i, saved in zip(ctx.tensor_at, ctx.saved_tensors):
            args[i] = saved.detach()
            if ctx.needs_input_grad[2 + i]:
                args[i].requires_grad_()
                wanted.append(i)
        with torch.enable_grad():
            out = ctx.vjp_fn(*args)
        grads = torch.autograd.grad(out, [args[i] for i in wanted], grad,
                                    allow_unused=True)
        result = [None] * (2 + len(args))
        for i, g in zip(wanted, grads):
            result[2 + i] = g
        return tuple(result)
