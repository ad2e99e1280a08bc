"""Train states in JAX's layout: a torch model and its Adam / AdamW as the
flax parameters and optax state that JAX's trainers save with orbax.

optax's Adam keeps one ``ScaleByAdamState(count, mu, nu)``: an int32
count and the two moments as trees shaped like the parameters. torch's
Adam and AdamW keep per parameter a float32 ``step`` and ``exp_avg``,
``exp_avg_sq``; the port's steps give every parameter a gradient
(``optim.apply_update``), so every step is the same and maps onto the one
count, and a state whose steps differ raises. The moments take their
parameter's layout (``interop.from_flax.to_flax``). The model and
optimizer are read and set through ``torch.distributed.checkpoint``'s full
state dicts, so DDP, FSDP2 and tensor-parallel layouts give and take the
whole tree (every rank calls, as the gathers are collective).

A tree that lacks a leaf or has one too many, a wrong shape, or an optax
state of another layout raises (KeyError, ValueError).
"""
from __future__ import annotations

import numpy as np
import torch

from ..interop.from_flax import flax_state_dict, to_flax


def _options(**kw):
    from torch.distributed.checkpoint.state_dict import StateDictOptions
    return StateDictOptions(full_state_dict=True, **kw)


def full_state_dicts(model, optimizer):
    """(model state dict, optimizer state dict): whole, on the CPU, keyed
    by parameter name. Collective under a process group, where rank 0
    alone gets them (the others get empty dicts)."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict, get_optimizer_state_dict)

    opts = _options(cpu_offload=True)
    return (get_model_state_dict(model, options=opts),
            get_optimizer_state_dict(model, optimizer, options=opts))


def load_params(model, tree) -> None:
    """Set the model's parameters from a flax tree (with or without its
    ``"params"`` key); every parameter exactly once."""
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(model, flax_state_dict(tree, model),
                         options=_options())


def adam_tree(model, optim_sd: dict) -> dict:
    """optax's ``ScaleByAdamState`` of a torch Adam / AdamW over ``model``'s
    parameters, from its full state dict (``full_state_dicts``):
    ``{"count": int32, "mu": tree, "nu": tree}`` (zeros and count 0 before
    the first step). Raises ValueError where the parameters' steps differ
    or some have no state."""
    names = [n for n, _ in model.named_parameters()]
    state = optim_sd["state"]
    if not state:
        count = 0
        mu = nu = {n: torch.zeros(p.shape) for n, p in
                   model.named_parameters()}
    else:
        missing = sorted(set(names) - set(state))
        if missing:
            raise ValueError(f"parameters without Adam state: {missing}")
        steps = sorted({float(state[n]["step"]) for n in names})
        if len(steps) != 1 or steps[0] != int(steps[0]):
            raise ValueError(f"the parameters' Adam steps {steps} differ: "
                             "optax keeps one count")
        count = int(steps[0])
        mu = {n: state[n]["exp_avg"] for n in names}
        nu = {n: state[n]["exp_avg_sq"] for n in names}
    return {"count": np.int32(count), "mu": to_flax(mu, model),
            "nu": to_flax(nu, model)}


def load_adam(model, optimizer, tree) -> None:
    """Set a torch Adam / AdamW's state from optax's ``ScaleByAdamState``
    tree (``adam_tree``'s layout): every parameter's step is the count."""
    from torch.distributed.checkpoint.state_dict import \
        set_optimizer_state_dict

    check_layout(tree, {"count": None, "mu": ..., "nu": ...}, "Adam state")
    count = int(np.asarray(tree["count"]))
    mu = flax_state_dict(tree["mu"], model)
    nu = flax_state_dict(tree["nu"], model)
    # The full optimizer state dict names each group's parameters.
    names = {id(p): n for n, p in model.named_parameters()}
    groups = [dict(g, params=[names[id(p)] for p in g["params"]])
              for g in optimizer.param_groups]
    state = {n: {"step": torch.tensor(float(count)), "exp_avg": mu[n],
                 "exp_avg_sq": nu[n]} for n in mu}
    set_optimizer_state_dict(model, optimizer,
                             {"state": state, "param_groups": groups},
                             options=_options())


def check_layout(tree, layout, what: str) -> None:
    """Raise ValueError unless ``tree`` has ``layout``'s shape: a dict has
    exactly its keys, a list its length, ``"empty"`` is optax's
    ``EmptyState`` (``None`` in the tree), ``None`` a scalar array and
    ``...`` any subtree."""
    def walk(node, want, path):
        where = f"{what} at {'/'.join(path) or 'the root'}"
        if want is ...:
            return
        if isinstance(want, dict):
            if not isinstance(node, dict) or sorted(node) != sorted(want):
                got = sorted(node) if isinstance(node, dict) else \
                    type(node).__name__
                raise ValueError(f"{where}: {got}, not optax's "
                                 f"{sorted(want)}")
            for k in want:
                walk(node[k], want[k], path + [k])
        elif isinstance(want, list):
            if not isinstance(node, list) or len(node) != len(want):
                raise ValueError(f"{where}: not a sequence of {len(want)}")
            for i, (n, w) in enumerate(zip(node, want)):
                walk(n, w, path + [str(i)])
        elif want == "empty":
            if node is not None:
                raise ValueError(f"{where}: not optax's EmptyState")
        elif node is None or np.ndim(node) != 0:
            raise ValueError(f"{where}: not a scalar")

    walk(tree, layout, [])
